"""PVQ gradient compression with error feedback (port of
``repro.optim.grad_compress``, its one-device half).

Gradients are near-Laplacian, PVQ's sweet spot: each leaf is encoded in
groups of 256 (int8 pulses + one f32 rho per group, ~1.02 bytes a value
against 4).  Error feedback (Seide et al.; Karimireddy et al., EF-SGD)
keeps the quantization residual in a local accumulator, so the compression
error does not bias convergence.

* ``compress_decompress(g, cfg)``: the quantization channel (pure);
* ``make_ef_compressor(cfg)``: the error-feedback transform
  ``(grads, ef_state) -> (decoded grads, new ef_state)``;
* ``cross_pod_mean(grads, cfg, axis='pod')``: the compressed all-reduce
  over a mesh axis: encode the local gradient, all-gather the codes over
  the axis's process group, decode and average (the identity when there is
  no such axis);
* ``wire_bytes(grads, cfg)``: compressed against f32 bytes a participant.

The ``ls`` scale mode runs the encoder through ``kernels.ops`` (the encode
kernel on a CUDA tensor, its plain version on the CPU); the other modes run
the exact core encoder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from ..core.packed import is_packed
from ..core.pvq import pvq_encode_grouped
from ..kernels import ops as kernel_ops
from .adamw import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    group: int = 256
    n_over_k: float = 2.0  # K = group/2 pulses per group
    scale_mode: str = "ls"
    min_size: int = 1024  # leaves smaller than this pass through uncompressed

    @property
    def k(self) -> int:
        return max(int(round(self.group / self.n_over_k)), 1)

    def bytes_per_value(self) -> float:
        # int8 pulse + f32 scale amortized over the group
        return 1.0 + 4.0 / self.group


def _encode_grouped(flat: torch.Tensor, cfg: CompressionConfig):
    """``(pulses int32 (G, group), rho f32 (G,))``."""
    if cfg.scale_mode == "ls":
        return kernel_ops.pvq_encode_grouped_fast(flat, cfg.group, cfg.k)
    code = pvq_encode_grouped(flat, cfg.group, cfg.k, cfg.scale_mode)
    return code.pulses, code.scale


def compress_decompress(g: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """Quantization channel Q(g): PVQ encode + decode of one leaf, grouped.

    ``PackedPVQ`` leaves pass through unchanged: they already are the
    channel's output (frozen packed params carry no gradient; apply an
    explicit update with ``core.packed.packed_update``)."""
    if is_packed(g):
        return g
    flat = g.reshape(-1).to(torch.float32)
    if flat.numel() < cfg.min_size:
        return g
    pulses, scale = _encode_grouped(flat, cfg)
    deq = (scale[:, None] * pulses.to(torch.float32)).reshape(-1)[: flat.numel()]
    return deq.reshape(g.shape).to(g.dtype)


def make_ef_compressor(cfg: CompressionConfig):
    """Error feedback: ``decoded = Q(g + e)``, ``e' = g + e - decoded``.
    Returns ``(init, apply)`` over nested dicts.  ``PackedPVQ`` leaves
    (frozen packed params under a mixed fine-tune) keep themselves as their
    EF state and pass through untouched."""

    def init(grads: Any) -> Any:
        return tree_map(
            lambda g: g if is_packed(g) else torch.zeros(g.shape, dtype=torch.float32,
                                                         device=g.device),
            grads,
        )

    def apply(grads: Any, ef: Any) -> Tuple[Any, Any]:
        def one(g, e):
            if is_packed(g):
                return g, e  # frozen: no update, EF state untouched
            corrected = g.to(torch.float32) + e
            q = compress_decompress(corrected, cfg)
            return q.to(g.dtype), corrected - q.to(torch.float32)

        out = tree_map(one, grads, ef)
        return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)

    return init, apply


def cross_pod_mean(grads: Any, cfg: CompressionConfig, axis: str = "pod", *,
                   mesh=None) -> Any:
    """Compressed mean over the mesh axis ``axis`` (of ``mesh``, else the
    active mesh), called on every rank of it with that rank's gradients.

    Each participant encodes its local gradient; int8 pulses + f32 scales
    are all-gathered over the axis's process group (~1.02 B a value on the
    wire instead of 4); everyone decodes and averages.  Leaves below
    ``cfg.min_size`` are averaged exactly (an all-reduce); ``PackedPVQ``
    leaves (frozen, replicated) come back untouched.  Without a mesh, a
    process group or such an axis this is the identity."""
    import torch.distributed as dist

    from ..parallel.sharding import active_mesh

    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or not dist.is_initialized() or axis not in (mesh.mesh_dim_names or ()):
        return grads
    dim = mesh.mesh_dim_names.index(axis)
    group, n = mesh.get_group(dim), mesh.size(dim)

    def one(g):
        if is_packed(g):
            return g  # frozen packed artifact: replicated, nothing to reduce
        flat = g.reshape(-1).to(torch.float32)
        if flat.numel() < cfg.min_size:
            total = g.clone()
            dist.all_reduce(total, group=group)
            return total / n
        pulses_i32, scales = _encode_grouped(flat, cfg)
        pulses = kernel_ops.pulses_to_int8(pulses_i32)  # (G, group) wire format
        scales = scales.to(torch.float32).contiguous()  # (G,)
        all_pulses = [torch.empty_like(pulses) for _ in range(n)]
        all_scales = [torch.empty_like(scales) for _ in range(n)]
        dist.all_gather(all_pulses, pulses.contiguous(), group=group)
        dist.all_gather(all_scales, scales, group=group)
        deq = torch.stack(all_pulses).to(torch.float32) * torch.stack(all_scales)[..., None]
        mean = torch.mean(deq, dim=0).reshape(-1)[: flat.numel()]
        return mean.reshape(g.shape).to(g.dtype)

    return tree_map(one, grads)


def wire_bytes(grads: Any, cfg: CompressionConfig) -> Tuple[int, int]:
    """``(compressed, uncompressed f32)`` bytes a participant sends."""
    comp = 0
    raw = 0
    for g in tree_leaves(grads):
        if is_packed(g):  # frozen packed leaves never cross the wire
            continue
        n = int(g.numel())
        raw += 4 * n
        if n < cfg.min_size:
            comp += 4 * n
        else:
            groups = math.ceil(n / cfg.group)
            comp += groups * cfg.group + 4 * groups
    return comp, raw
