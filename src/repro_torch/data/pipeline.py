"""Host data pipeline: deterministic per-step batches, background prefetch
and placement on the loader's device (port of ``repro.data.pipeline``).

``TokenLoader.host_batch(step)`` is the reference's numpy, array for array:
one seed gives the same batches in both packages.  The reference's
``sharding`` argument (a batch ``NamedSharding`` across a mesh) has no
one-device counterpart: the loader accepts ``None`` only and puts every
batch on its ``device``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


class Prefetcher:
    """Background-thread prefetch of batches (depth-bounded)."""

    def __init__(self, make_batch: Callable[[int], Any], depth: int = 2, start_step: int = 0):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> Any:
        step, batch = self._q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


class TokenLoader:
    """Deterministic, restart-safe loader: batch(step) is a pure function of
    (seed, step), so restoring a checkpoint at step S resumes the exact
    stream, which reproducible fault recovery needs."""

    def __init__(self, task, batch: int, seq: int, seed: int = 0, sharding=None,
                 prefetch: int = 2, device="cuda"):
        if sharding is not None:
            raise ValueError("TokenLoader runs on one device: sharding must be None")
        self.task = task
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.sharding = None
        self.device = torch.device(device)
        self._prefetcher: Optional[Prefetcher] = None
        self.prefetch_depth = prefetch

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        return self.task.sample(rng, self.batch, self.seq)

    def device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """``host_batch(step)`` on the loader's device, dtypes kept."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in self.host_batch(step).items()}

    def start(self, start_step: int = 0):
        self._prefetcher = Prefetcher(self.device_batch, self.prefetch_depth, start_step)
        return self

    def next(self):
        assert self._prefetcher is not None, "call start() first"
        return self._prefetcher.next()

    def close(self):
        if self._prefetcher:
            self._prefetcher.close()
            self._prefetcher = None
