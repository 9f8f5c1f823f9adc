"""Packed PVQ weights and the PVQ-compressed KV cache (PyTorch port of
``repro.core.packed``: ``PackedPVQ``, ``PackedKV``, the pack functions and
``quantize_params``; the paged pool waits for the engine slice).

``PackedPVQ`` is int8 pulses plus per-group f32 scales and the metadata to
consume them.  Layouts:

* ``'matmul'`` — pulses ``(..., k_pad, n)`` / scales ``(..., k_pad // G, n)``,
  the layout the matmul kernels stream; leading axes are layer stacks.
* ``'flat'`` — pulses ``(G_total, group)`` / scales ``(G_total,)``, row-major
  groups of the flattened tensor (embeddings: group divides the row).

Parameters are nested dicts of tensors; a path is the ``/``-joined keys,
as the reference's pytree paths are.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Tuple

import torch

from .quantize import KVQuant, QuantPolicy, k_for

#: leaves the packed policy never touches even when a rule matches
PACK_SKIP_REGEX = r"(conv_kernel|pos_embedding|wk_b|wv_b|time_|router)"


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _fit_group(group: int, dim: int) -> int:
    """Largest power-of-two divisor chain of ``group`` that divides ``dim``."""
    g = max(int(group), 1)
    while g > 1 and dim % g:
        g //= 2
    return max(g, 1)


def matmul_plan(group: int, d_in: int) -> Tuple[int, int]:
    """(effective group, group-padded contraction dim) for a matmul-layout
    pack of a ``(d_in, n)`` kernel."""
    g = _fit_group(group, d_in) if d_in < group else int(group)
    k_pad = -(-d_in // g) * g
    return g, k_pad


def _resolve_k(g: int, n_over_k: Optional[float], k: Optional[int]) -> int:
    if (n_over_k is None) == (k is None):
        raise ValueError("pass exactly one of n_over_k / k")
    return int(k) if k is not None else k_for(g, n_over_k)


@dataclasses.dataclass(frozen=True, eq=False)
class PackedPVQ:
    """One PVQ-coded tensor: int8 pulses + per-group f32 scales + metadata.
    ``shape``/``dtype`` describe the logical dense tensor (unstacked)."""

    pulses: torch.Tensor
    scales: torch.Tensor
    group: int
    k: int
    shape: Tuple[int, ...]
    dtype: str
    layout: str = "matmul"
    scale_mode: str = "ls"

    @property
    def k_pad(self) -> int:
        return int(self.pulses.shape[-2]) if self.layout == "matmul" else 0

    @property
    def nbytes_packed(self) -> int:
        return self.pulses.numel() + 4 * self.scales.numel()

    @property
    def nbytes_dense(self) -> int:
        lead = self.pulses.shape[: self.pulses.ndim - 2]
        itemsize = torch.empty((), dtype=torch_dtype(self.dtype)).element_size()
        return math.prod(lead) * math.prod(self.shape) * itemsize

    def stack_item(self, i: int) -> "PackedPVQ":
        """The ``i``-th matrix of a stacked leaf (a view, no copy)."""
        return dataclasses.replace(self, pulses=self.pulses[i], scales=self.scales[i])

    def to(self, device) -> "PackedPVQ":
        return dataclasses.replace(
            self, pulses=self.pulses.to(device), scales=self.scales.to(device)
        )

    def dequantize(self, dtype=None) -> torch.Tensor:
        """Dense view (cold path: tests and tooling)."""
        out_dtype = torch_dtype(self.dtype) if dtype is None else dtype
        p = self.pulses.to(torch.float32)
        if self.layout == "matmul":
            w = p * torch.repeat_interleave(self.scales, self.group, dim=-2)
            lead = w.shape[:-2]
            w = w[..., : self.shape[-2], :]
            return w.reshape(*lead, *self.shape).to(out_dtype)
        deq = p * self.scales[..., None]
        lead = deq.shape[:-2]
        flat = deq.reshape(*lead, -1)[..., : math.prod(self.shape)]
        return flat.reshape(*lead, *self.shape).to(out_dtype)

    def __repr__(self) -> str:
        return (
            f"PackedPVQ(shape={self.shape}, dtype={self.dtype}, layout={self.layout!r}, "
            f"group={self.group}, k={self.k}, pulses={tuple(self.pulses.shape)})"
        )


def is_packed(leaf: Any) -> bool:
    return isinstance(leaf, PackedPVQ)


# ---------------------------------------------------------------------------
# PackedKV: the PVQ-compressed attention KV cache (kernel v4 consumer)
# ---------------------------------------------------------------------------


def _kv_encode_planes(x: torch.Tensor, group: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PVQ-encode the head dim of ``x (..., hd)`` in ``hd // group`` groups:
    ``(pulses int8 (..., hd), scales f32 (..., hd // group))``, with the
    least-squares rho fitted against the int8 pulses actually stored.  The
    projection is the encode kernel's function (the reference computes the
    same ``pvq_quantize_direction_fast`` in jnp), so on a card it runs
    through the kernel."""
    from ..kernels import ops
    from .pvq import _scales

    shp = x.shape
    ng = shp[-1] // group
    xg = x.to(torch.float32).reshape(shp[:-1] + (ng, group))
    pulses, _ = ops.pvq_encode(xg.reshape(-1, group), k_pulses=k)
    p8 = ops.pulses_to_int8(pulses).reshape(xg.shape)
    scales = _scales(xg, p8, "ls").to(torch.float32)
    _probe_kv_encode(xg, p8, scales)
    return p8.reshape(shp), scales


def _probe_kv_encode(xg, p8, scales) -> None:
    """KV-block reconstruction SNR + saturation probe (telemetry only)."""
    from ..runtime import obs, telemetry

    if not obs.enabled():
        return
    ref = xg.detach().cpu().numpy()
    approx = (p8.to(torch.float32) * scales[..., None]).cpu().numpy()
    obs.counter("quant.kv_blocks_probed").inc()
    obs.histogram("quant.kv_snr_db").record(telemetry.snr_db(ref, approx))
    if p8.numel():
        obs.histogram("quant.kv_clamp_frac").record(float((p8.abs() == 127).sum()) / p8.numel())
    if scales.numel():
        obs.histogram("quant.kv_zero_scale_frac").record(
            float((scales == 0).sum()) / scales.numel()
        )


@dataclasses.dataclass(eq=False)
class PackedKV:
    """Block-aligned PVQ-compressed KV cache for one attention layer.

    ``k_pulses``/``v_pulses`` ``(b, S, n_kv, hd)`` int8 and
    ``k_scales``/``v_scales`` ``(b, S, n_kv, ng)`` f32 hold the completed
    blocks; ``tail_k``/``tail_v`` ``(b, block, n_kv, hd)`` in the cache dtype
    hold the in-flight partial block (slot ``pos % block``).  Positions below
    ``packed_end(filled)`` are served from the planes, the rest from the
    tail.  Unlike the reference's immutable pytree, ``append`` updates the
    tensors in place: a decode step writes one row and, on a block fill,
    one block, instead of copying every plane.
    """

    k_pulses: torch.Tensor
    k_scales: torch.Tensor
    v_pulses: torch.Tensor
    v_scales: torch.Tensor
    tail_k: torch.Tensor
    tail_v: torch.Tensor
    block: int
    group: int
    k: int
    dtype: str

    @property
    def head_dim(self) -> int:
        return int(self.k_pulses.shape[-1])

    @property
    def n_groups(self) -> int:
        return int(self.k_scales.shape[-1])

    @property
    def max_len(self) -> int:
        return int(self.k_pulses.shape[-3])

    @property
    def packed_bytes_per_token(self) -> int:
        return 2 * (self.head_dim + 4 * self.n_groups)

    @property
    def dense_bytes_per_token(self) -> int:
        itemsize = torch.empty((), dtype=torch_dtype(self.dtype)).element_size()
        return 2 * self.head_dim * itemsize

    def packed_end(self, filled):
        """First position served from the tail (= completed-block extent)."""
        return (filled // self.block) * self.block

    @classmethod
    def init(
        cls, batch: int, max_len: int, n_kv: int, head_dim: int, *,
        kvq: KVQuant, dtype=torch.bfloat16, device="cuda",
    ) -> "PackedKV":
        g = _fit_group(kvq.group, head_dim)
        blk = int(kvq.block)
        s_pad = -(-int(max_len) // blk) * blk
        ng = head_dim // g

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(
            k_pulses=z((batch, s_pad, n_kv, head_dim), torch.int8),
            k_scales=z((batch, s_pad, n_kv, ng), torch.float32),
            v_pulses=z((batch, s_pad, n_kv, head_dim), torch.int8),
            v_scales=z((batch, s_pad, n_kv, ng), torch.float32),
            tail_k=z((batch, blk, n_kv, head_dim), dtype),
            tail_v=z((batch, blk, n_kv, head_dim), dtype),
            block=blk, group=g, k=int(kvq.k), dtype=dtype_name(dtype),
        )

    @classmethod
    def from_dense(cls, k: torch.Tensor, v: torch.Tensor, *, kvq: KVQuant, dtype=None) -> "PackedKV":
        """Encode a dense prefill cache ``(b, s, n_kv, hd)`` pair: complete
        blocks into the planes, the remainder into tail slots ``0 .. s % block - 1``."""
        b, s, n_kv, hd = k.shape
        dt = k.dtype if dtype is None else dtype
        pkv = cls.init(b, s, n_kv, hd, kvq=kvq, dtype=dt, device=k.device)
        blk = pkv.block
        n_full = s // blk
        rem = s - n_full * blk
        if n_full:
            end = n_full * blk
            kp, ks = _kv_encode_planes(k[:, :end].to(torch.float32), pkv.group, pkv.k)
            vp, vs = _kv_encode_planes(v[:, :end].to(torch.float32), pkv.group, pkv.k)
            pkv.k_pulses[:, :end] = kp
            pkv.k_scales[:, :end] = ks
            pkv.v_pulses[:, :end] = vp
            pkv.v_scales[:, :end] = vs
        if rem:
            pkv.tail_k[:, :rem] = k[:, n_full * blk :].to(dt)
            pkv.tail_v[:, :rem] = v[:, n_full * blk :].to(dt)
        return pkv

    def pad_seq(self, extra: int) -> "PackedKV":
        """Zero-extend the planes by ``extra`` positions (the prefill cache
        padding of the reference's ``Model.prefill``)."""
        if extra <= 0:
            return self

        def pad(t):
            return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra))

        return dataclasses.replace(
            self, k_pulses=pad(self.k_pulses), k_scales=pad(self.k_scales),
            v_pulses=pad(self.v_pulses), v_scales=pad(self.v_scales),
        )

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> "PackedKV":
        """Write one decode step ``(b, 1, n_kv, hd)`` at host position ``pos``
        (in place).  The row lands in the tail ring in the cache dtype; when
        it completes a block, the whole ring is PVQ-encoded into the planes."""
        blk = self.block
        slot = pos % blk
        self.tail_k[:, slot : slot + 1] = k_new.to(self.tail_k.dtype)
        self.tail_v[:, slot : slot + 1] = v_new.to(self.tail_v.dtype)
        if (pos + 1) % blk == 0:
            start = pos + 1 - blk
            pk, sk = _kv_encode_planes(self.tail_k, self.group, self.k)
            pv, sv = _kv_encode_planes(self.tail_v, self.group, self.k)
            self.k_pulses[:, start : start + blk] = pk
            self.k_scales[:, start : start + blk] = sk
            self.v_pulses[:, start : start + blk] = pv
            self.v_scales[:, start : start + blk] = sv
        return self

    def dense_kv(self, filled: int, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact dense view ``(k, v)`` of shape ``(b, S, n_kv, hd)``: planes
        below ``packed_end(filled)``, the tail ring at and above it.  Rows
        beyond ``filled`` carry garbage and must stay length-masked."""
        blk = self.block
        s = self.max_len
        pe = self.packed_end(filled)
        posn = torch.arange(s, device=self.k_pulses.device)
        tidx = torch.remainder(posn - pe, blk)
        mask = (posn >= pe)[None, :, None, None]

        def expand(pulses, scales):
            return pulses.to(torch.float32) * torch.repeat_interleave(scales, self.group, dim=-1)

        def overlay(deq, tail):
            return torch.where(mask, tail.to(torch.float32)[:, tidx], deq)

        k = overlay(expand(self.k_pulses, self.k_scales), self.tail_k)
        v = overlay(expand(self.v_pulses, self.v_scales), self.tail_v)
        return k.to(dtype), v.to(dtype)

    def __repr__(self) -> str:
        return (
            f"PackedKV(shape={tuple(self.k_pulses.shape)}, dtype={self.dtype}, "
            f"block={self.block}, group={self.group}, k={self.k})"
        )


def is_packed_kv(leaf: Any) -> bool:
    return isinstance(leaf, PackedKV)


# ---------------------------------------------------------------------------
# Encoding single arrays
# ---------------------------------------------------------------------------


def pack_matmul(
    w: torch.Tensor, *, group: int, n_over_k: Optional[float] = None,
    k: Optional[int] = None, scale_mode: str = "ls",
) -> PackedPVQ:
    """Encode a dense weight ``(..., d_in, d_out)`` (leading axes: a layer
    stack, each matrix its own code) into the kernel-native matmul layout.
    For K > 127 a coordinate may be clamped to the int8 range, so rho is
    refit against the pulses actually stored."""
    from ..kernels import ops
    from .pvq import _scales

    if w.ndim < 2:
        raise ValueError(f"matmul layout needs a tensor of rank >= 2, got {tuple(w.shape)}")
    d_in, d_out = w.shape[-2:]
    g, _ = matmul_plan(group, d_in)
    k = _resolve_k(g, n_over_k, k)
    wf = w.to(torch.float32)
    pulses, scales, k_pad = ops.encode_weight_matrix(wf, group=g, k_pulses=k)
    if scale_mode != "ls" or k > 127:
        pad = k_pad - d_in
        wp = torch.nn.functional.pad(wf, (0, 0, 0, pad)) if pad else wf
        lead = wp.shape[:-2]
        wg = wp.transpose(-1, -2).reshape(*lead, d_out, k_pad // g, g)
        pg = pulses.transpose(-1, -2).reshape(*lead, d_out, k_pad // g, g)
        scales = _scales(wg, pg, scale_mode).transpose(-1, -2).to(torch.float32).contiguous()
    return PackedPVQ(
        pulses=pulses, scales=scales, group=g, k=k, shape=(int(d_in), int(d_out)),
        dtype=dtype_name(w.dtype), layout="matmul", scale_mode=scale_mode,
    )


def pack_flat(
    w: torch.Tensor, *, group: int, n_over_k: Optional[float] = None,
    k: Optional[int] = None, scale_mode: str = "ls",
    row_align: Optional[int] = None,
) -> PackedPVQ:
    """Encode any tensor as row-major groups of its flattening; ``row_align``
    shrinks the group so it divides the row length."""
    from ..kernels import ops
    from .pvq import _scales

    g = _fit_group(group, row_align) if row_align else int(group)
    k = _resolve_k(g, n_over_k, k)
    flat = w.reshape(-1).to(torch.float32)
    pulses_i32, scales = ops.pvq_encode_grouped_fast(flat, g, k, scale_mode=scale_mode)
    pulses = ops.pulses_to_int8(pulses_i32)
    if k > 127:
        pad = (-flat.shape[0]) % g
        wg = (torch.nn.functional.pad(flat, (0, pad)) if pad else flat).reshape(-1, g)
        scales = _scales(wg, pulses, scale_mode)
    return PackedPVQ(
        pulses=pulses, scales=scales.to(torch.float32), group=g, k=k,
        shape=tuple(int(s) for s in w.shape), dtype=dtype_name(w.dtype),
        layout="flat", scale_mode=scale_mode,
    )


# ---------------------------------------------------------------------------
# Tree transforms over nested parameter dicts
# ---------------------------------------------------------------------------


def tree_map_with_path(fn, tree, prefix: str = ""):
    """Map ``fn(path, leaf)`` over a nested dict; packed leaves are leaves."""
    if isinstance(tree, dict):
        return {
            key: tree_map_with_path(fn, sub, f"{prefix}/{key}" if prefix else str(key))
            for key, sub in tree.items()
        }
    return fn(prefix, tree)


def _pack_leaf(pstr: str, leaf: torch.Tensor, n_over_k: float, group: Optional[int],
               scale_mode: str) -> Optional[PackedPVQ]:
    g = group or 256
    if re.search(PACK_SKIP_REGEX, pstr):
        return None
    if re.search(r"(^|/)embedding$", pstr) and leaf.ndim == 2:
        return pack_flat(leaf, group=g, n_over_k=n_over_k, scale_mode=scale_mode,
                         row_align=leaf.shape[-1])
    if re.search(r"kernel$", pstr) and leaf.ndim in (2, 3):
        return pack_matmul(leaf, group=g, n_over_k=n_over_k, scale_mode=scale_mode)
    return None


def quantize_params(params: Any, policy: QuantPolicy, *, min_size: int = 64) -> Any:
    """Encode a parameter tree once into ``PackedPVQ`` leaves (dense kernels,
    embeddings) and untouched leaves (norms and anything without a packed
    consumer)."""

    def visit(pstr, leaf):
        if is_packed(leaf) or not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
            return leaf
        if leaf.numel() < min_size or not leaf.is_floating_point():
            return leaf
        m = policy.match(pstr)
        if m is None:
            return leaf
        n_over_k, group = m
        packed = _pack_leaf(pstr, leaf, n_over_k, group, policy.scale_mode)
        if packed is None:
            return leaf
        _probe_weight_pack(leaf, packed)
        return packed

    return tree_map_with_path(visit, params)


def _probe_weight_pack(leaf: torch.Tensor, packed: PackedPVQ) -> None:
    from ..runtime import obs, telemetry

    if not obs.enabled():
        return
    ref = leaf.detach().to(torch.float32).cpu().numpy()
    approx = packed.dequantize(torch.float32).cpu().numpy()
    obs.counter("quant.weight_leaves_packed").inc()
    obs.counter("quant.weight_bytes_packed").add(packed.nbytes_packed)
    obs.counter("quant.weight_bytes_dense").add(packed.nbytes_dense)
    obs.histogram("quant.weight_snr_db").record(telemetry.snr_db(ref, approx))


def packed_leaves(params: Any) -> Dict[str, PackedPVQ]:
    out: Dict[str, PackedPVQ] = {}

    def visit(pstr, leaf):
        if is_packed(leaf):
            out[pstr] = leaf
        return leaf

    tree_map_with_path(visit, params)
    return out


def packed_stats(params: Any, *, entropy: bool = False) -> Dict[str, float]:
    """Artifact-size report (int8 + f32 bytes).  The entropy-coded sizes
    need the bitstream codecs, which arrive with the artifact slice."""
    if entropy:
        raise NotImplementedError("entropy-coded sizes arrive with the artifact slice")
    packed_bytes = replaced = untouched = n_packed = 0

    def visit(_, leaf):
        nonlocal packed_bytes, replaced, untouched, n_packed
        if is_packed(leaf):
            packed_bytes += leaf.nbytes_packed
            replaced += leaf.nbytes_dense
            n_packed += 1
        elif isinstance(leaf, torch.Tensor):
            untouched += leaf.numel() * leaf.element_size()
        return leaf

    tree_map_with_path(visit, params)
    return {
        "packed_tensors": n_packed,
        "packed_bytes": packed_bytes,
        "replaced_dense_bytes": replaced,
        "untouched_bytes": untouched,
        "weight_compression_ratio": replaced / max(packed_bytes, 1),
        "total_bytes": packed_bytes + untouched,
    }
