"""What the drivers share: the port's configuration checked against the
configuration file, the served parameters made from the seed and packed
by the program, the instrumentation around the program's calls, and the
record of one run."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.weights import WeightSource


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the driver found."""

    name: str
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float  # perf_counter at process start
    keep: bool = False  # keep the checked sample and the reference's logits (bench/control.py)
    # filled by the driver
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    obs: Dict[str, Any] = dataclasses.field(default_factory=dict)  # what per-layer readers read
    checks: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    correct: bool = False
    memory_peak_bytes: int = 0
    summary: Any = None  # trace.Summary of the traced span


def _at(tree, dotted: str):
    for part in dotted.split("."):
        tree = tree[part] if isinstance(tree, dict) else getattr(tree, part)
    return tree


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of the configuration, checked key by key
    (``port_checks``: the port's field against the configuration's key):
    the file must say what runs."""
    from repro_torch.configs import get_config

    port = get_config(cfg["port_arch"])
    if cfg.get("port_reduced"):
        port = port.reduced()
    for field, key in cfg["port_checks"].items():
        got, want = _at(port, field), _at(cfg, key)
        if got != want:
            raise ValueError(f"{cfg['name']}: the port runs {field}={got!r}, the file says "
                             f"{key}={want!r}")
    return port


def quant_scopes(cfg: dict) -> contextlib.ExitStack:
    """The serving path's quantization as the configuration states it: int8
    activations, and PVQ KV pages where the KV cache is ``pvq`` (a dense
    cache otherwise)."""
    from repro_torch.core.quantize import ActQuant, KVQuant, act_quant_scope, kv_quant_scope

    srv = cfg["serving"]
    kv = srv["kv_cache"]
    kvq = KVQuant(block=kv["block"], group=kv["group"], k=kv["k"]) \
        if kv["format"] == "pvq" else None
    stack = contextlib.ExitStack()
    stack.enter_context(act_quant_scope(ActQuant(mode=srv["activations"]["granularity"])))
    stack.enter_context(kv_quant_scope(kvq))
    return stack


def serving_policy(port, cfg: dict):
    from repro_torch.launch.serve import serving_policy as policy

    return policy(port, cfg["serving"]["weights"]["n_over_k"])


def build_params(model, policy, ws: WeightSource) -> dict:
    """The model's parameter tree (its shapes from the port's shape-only
    init) filled from ``ws`` leaf by leaf and layer by layer, each leaf
    packed by the program's ``quantize_params`` as soon as it is made (left
    as made where ``policy`` is None)."""
    from repro_torch.core.packed import quantize_params
    from repro_torch.launch.inputs import params_shape

    def build(tree: dict, prefix: str) -> dict:
        out = {}
        for key, leaf in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(leaf, dict):
                out[key] = build(leaf, path)
                continue
            if path.startswith("segments/"):
                t = torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device=ws.device)
                for r in range(leaf.shape[0]):
                    t[r] = ws.get(path, r, leaf.shape[1:], leaf.dtype)
            else:
                t = ws.get(path, None, leaf.shape, leaf.dtype)
            if policy is None:
                out[key] = t
                continue
            holder = {key: t}
            del t
            quantize_params(holder, policy, prefix=prefix)
            out[key] = holder[key]
        return out

    return build(params_shape(model), "")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_device(device) -> None:
    """Hand the program's freed memory back before the reference runs."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Spans:
    """Host-clock spans around the program's calls, by name."""

    def __init__(self):
        self.by: Dict[str, List[float]] = {}

    def wrap(self, name: str, fn: Callable, before: Optional[Callable] = None,
             after: Optional[Callable] = None) -> Callable:
        spans = self.by.setdefault(name, [])

        def wrapped(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            spans.append(time.perf_counter() - t)
            if after is not None:
                after(*args, **kwargs)
            return out

        return wrapped
