"""Fault tolerance and elasticity for the training loop (port of
``repro.runtime.fault_tolerance``).

* periodic asynchronous checkpoints with committed-step semantics
  (``checkpoint.Checkpointer``): a failed write never corrupts a restore;
* failure handling: a step that raises restores the latest committed step
  and resumes the loader's deterministic stream after it;
* straggler mitigation: a step slower than ``factor`` times the rolling
  median flags the host (the policy records the decision);
* elastic re-mesh: on a shrink, the largest surviving mesh that divides
  the global batch (planning only: one device runs one mesh).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint import Checkpointer


@dataclasses.dataclass
class StragglerPolicy:
    window: int = 32
    factor: float = 3.0  # flag if step_time > factor * rolling median

    def __post_init__(self):
        self.times: deque = deque(maxlen=self.window)
        self.flagged: List[Tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        med = float(np.median(self.times)) if len(self.times) >= 8 else None
        self.times.append(dt)
        if med is not None and dt > self.factor * med:
            self.flagged.append((step, dt, med))
            return True
        return False


@dataclasses.dataclass
class ElasticPlan:
    """Valid fallback meshes, largest first; all must divide the batch."""

    global_batch: int
    candidates: Tuple[Tuple[int, int], ...] = ((16, 16), (8, 16), (4, 16), (2, 16), (1, 16))

    def pick(self, surviving_chips: int) -> Optional[Tuple[int, int]]:
        for d, m in self.candidates:
            if d * m <= surviving_chips and self.global_batch % d == 0:
                return (d, m)
        return None


class TrainingRunner:
    """Wraps a step with checkpoint and restore and failure recovery."""

    def __init__(
        self,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        state: Any,
        loader,  # TokenLoader-like: a deterministic device batch per step
        checkpointer: Checkpointer,
        *,
        ckpt_every: int = 50,
        max_restores: int = 8,
        straggler: Optional[StragglerPolicy] = None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.loader = loader
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.max_restores = max_restores
        self.straggler = straggler or StragglerPolicy()
        self.restores = 0
        self.history: List[Dict[str, float]] = []

    def resume_step(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        self.state, step = self.ckpt.restore(self.state)
        return step + 1

    def run(self, n_steps: int, *, failure_injector: Optional[Callable[[int], None]] = None) -> int:
        step = self.resume_step()
        end = step + n_steps
        while step < end:
            try:
                t0 = time.time()
                if failure_injector is not None:
                    failure_injector(step)
                batch = self.loader.device_batch(step)
                self.state, metrics = self.step_fn(self.state, batch)
                rec = {k: float(v) for k, v in metrics.items()}  # waits for the step
                dt = time.time() - t0
                slow = self.straggler.observe(step, dt)
                self.history.append({"step": step, "dt": dt, "straggler": slow, **rec})
                if self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                    self.ckpt.save(step, self.state, block=False)
                step += 1
            except Exception:
                self.restores += 1
                if self.restores > self.max_restores:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    # nothing committed yet: restart the run from step 0
                    step = 0
                    continue
                self.state, restored = self.ckpt.restore(self.state)
                step = restored + 1
        self.ckpt.wait()
        self.ckpt.save(end - 1, self.state, block=True)
        return end
