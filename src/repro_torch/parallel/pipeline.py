"""Pipeline parallelism over the ``pod`` axis (GPipe-style microbatching;
port of ``repro.parallel.pipeline``).

At 2 pods the default posture is DP over ``pod`` (bubble-free, and the
cross-pod gradient traffic can be PVQ-compressed — see
``optim.grad_compress.cross_pod_mean``); this module provides the PP
alternative for deeper pod counts or models whose layers do not fit a
single pod even fully sharded.

Schedule: the L layer-groups are split into S stages (one per rank of the
axis); microbatches flow stage to stage.  GPipe schedule: all microbatches
forward; bubble fraction = (S-1)/(S-1+M) for M microbatches.  Where the
reference rotates activations with ``lax.ppermute`` inside a ``shard_map``,
each rank here runs its own stage and sends its output to the next rank of
the axis's process group with ``batch_isend_irecv`` every tick.  The
forward only: the sends are not differentiated.

``stage_fn(stage_params, x)`` is any per-stage function.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def _local_stage(stage_params: Any) -> Any:
    """This rank's stage: a DTensor leaf sharded over the stage axis (the
    reference's leading ``[n_stages]`` axis on ``P('pod')``) gives its local
    ``[0]``; a plain leaf already is this rank's stage."""
    from torch.distributed.tensor import DTensor

    if isinstance(stage_params, dict):
        return {k: _local_stage(v) for k, v in stage_params.items()}
    if isinstance(stage_params, DTensor):
        return stage_params.to_local()[0]
    return stage_params


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x_microbatches: torch.Tensor,  # (n_micro, mb, ...) input microbatches, on every rank
    *,
    mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run the pipeline; returns the final stage's outputs (n_micro, mb, ...)
    on every rank of the axis (the reference's one global value).

    Total ticks = n_micro + n_stages - 1.  At tick ``t`` stage 0 takes
    microbatch ``t`` (while there is one), every other stage the activation
    its predecessor sent at ``t - 1``; the last stage keeps its output for
    microbatch ``t - (S - 1)``."""
    from ..launch.roofline import current_counter

    dim = mesh.mesh_dim_names.index(axis)
    group = mesh.get_group(dim)
    n_stages = mesh.size(dim)
    stage_idx = mesh.get_local_rank(dim)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage_idx + 1) % n_stages], ranks[(stage_idx - 1) % n_stages]
    params_here = _local_stage(stage_params)
    n_micro = x_microbatches.shape[0]
    counter = current_counter()

    buf = torch.zeros_like(x_microbatches[0])
    outputs = None
    for t in range(n_micro + n_stages - 1):
        x_in = x_microbatches[t] if (stage_idx == 0 and t < n_micro) else buf
        y = stage_fn(params_here, x_in)
        if outputs is None:
            outputs = y.new_zeros((n_micro,) + tuple(y.shape))
        out_slot = t - (n_stages - 1)
        if stage_idx == n_stages - 1 and out_slot >= 0:
            outputs[out_slot] = y
        # rotate activations to the next stage
        y = y.contiguous()
        buf = torch.empty_like(y)
        if n_stages > 1:
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                           dist.P2POp(dist.irecv, buf, prv, group)])
            for r in reqs:
                r.wait()
            if counter is not None:
                counter.record("collective-permute", y.numel() * y.element_size(), axis)
        else:
            buf = y
    if n_stages > 1:
        dist.broadcast(outputs, src=ranks[-1], group=group)
    return outputs


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: idle ticks / total ticks."""
    return (n_stages - 1) / (n_stages - 1 + n_micro)
