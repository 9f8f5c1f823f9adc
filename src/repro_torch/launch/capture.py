"""A step of fixed shapes captured as one CUDA graph and replayed: the
port's counterpart of the reference's ``jax.jit`` of a step.  The engine
captures its decode, prefill, graft and chunk steps, the fixed-batch loop
its decode step.

An eager step launches its kernels one by one from Python (~7,700 for a
smollm-360m decode step, ~11,400 for deepseek-v2-lite-16b, ~8,900 for a
smollm prefill); a replay is one launch of the whole graph.  The
hand-written kernels launch on ``torch.cuda.current_stream()``, so they
are captured with the glue.

* Every graph of a device is captured on one capture stream into one
  memory pool (``torch.cuda.graph_pool_handle()``), shared by the
  fixed-batch loop's and the engine's steps.  The splitk bodies keep their
  arrival counters per stream (``kernels.pvq_matmul._SPLITK_COUNTERS``):
  every graph holds the capture stream's, and every replay runs on the
  serving stream, one at a time.
* The first call runs the step eagerly on the capture stream: it builds
  and loads the kernels on first use and makes the capture stream's splitk
  counters, outside the capture.  The capture that follows launches
  nothing, and the first run's outputs are copied into the graph's own
  (:attr:`CapturedStep.out`), so the first call's result is where every
  replay leaves it (the engine's graft graph reads the prefill graph's).
* The launch counts (``repro_torch.kernels``) count on the host: what the
  capture counted is taken back and added on every replay, so they keep
  counting launches on the card.
* A graph's outputs live in the shared pool and are overwritten by the
  next replay of any graph of the device: callers clone what they keep,
  and a graph that reads another's outputs replays right after it.
* Nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .. import kernels

_POOLS: Dict[int, Any] = {}
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _index(device) -> int:
    d = torch.device(device)
    return d.index if d.index is not None else torch.cuda.current_device()


def capture_stream(device) -> "torch.cuda.Stream":
    """The one stream every graph of ``device`` is captured on."""
    i = _index(device)
    if i not in _STREAMS:
        _STREAMS[i] = torch.cuda.Stream(device=i)
    return _STREAMS[i]


def graph_pool(device):
    """The memory pool every graph of ``device`` shares."""
    i = _index(device)
    if i not in _POOLS:
        _POOLS[i] = torch.cuda.graph_pool_handle()
    return _POOLS[i]


class CapturedStep:
    """``fn()`` run once eagerly on the capture stream, then captured;
    :attr:`out` holds the first run's outputs, and :meth:`replay` runs the
    graph on the current stream and returns them anew."""

    def __init__(self, fn: Callable[[], Any], device):
        stream = capture_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            first = fn()
        current.wait_stream(stream)
        before = kernels.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        # the context empties the caching allocator first, which retires
        # the shared pool once every graph in it is gone: a bare
        # capture_begin into such a pool fails an allocator assertion
        with torch.cuda.graph(self.graph, pool=graph_pool(device), stream=stream):
            self.out = fn()
        self.launches = kernels.since(before)
        kernels.add(self.launches, -1)
        _copy_tree(self.out, first)

    def replay(self) -> Any:
        self.graph.replay()
        kernels.add(self.launches)
        return self.out


def _copy_tree(dst, src) -> None:
    """``dst.copy_(src)`` over matching trees of tensors (dicts, lists, tuples)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for key, sub in dst.items():
            _copy_tree(sub, src[key])
    elif isinstance(dst, (list, tuple)):
        for sub, src_sub in zip(dst, src):
            _copy_tree(sub, src_sub)
