"""Packed PVQ weights and the PVQ-compressed KV cache (PyTorch port of
``repro.core.packed``: ``PackedPVQ``, ``PackedKV``, the engine's paged
pool ``PagedKV``, the pack functions, ``quantize_params`` and
``packed_update``).

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

import numpy as np
import torch

from .quantize import KVQuant, QuantPolicy, graph_capturing, k_for

#: the MoE expert banks ``_pack_leaf`` packs into the expert-stacked matmul
#: layout: the one predicate every expert-bank report filters with
EXPERT_LEAF_REGEX = r"(wi_up|wi_gate|wo)_experts$"

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


def materialize(leaf: Any, dtype=None) -> torch.Tensor:
    """Dense view of a (possibly packed) leaf, for consumers without a
    packed compute path (the MLA b-projections at decode)."""
    if is_packed(leaf):
        return leaf.dequantize(dtype)
    return leaf if dtype is None else leaf.to(dtype)


# ---------------------------------------------------------------------------
# PackedKV: the PVQ-compressed attention KV cache (kernel v4 consumer)
# ---------------------------------------------------------------------------


def _kv_encode_planes(x: torch.Tensor, group: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PVQ-encode the head dim of ``x (..., hd)`` in ``hd // group`` groups:
    ``(pulses int8 (..., hd), scales f32 (..., hd // group))``, with the
    least-squares rho fitted against the int8 pulses actually stored.  The
    projection is the encode kernel's function (the reference computes the
    same ``pvq_quantize_direction_fast`` in jnp), so on a card it runs
    through the kernel.  For ``k <= 127`` (every ``KVQuant``) the int8
    pulses are the encoder's, whose rho is that fit (the same elementwise
    sum tree as ``pvq._scales``), so it is taken as it comes."""
    from ..kernels import ops
    from .pvq import _scales

    shp = x.shape
    ng = shp[-1] // group
    xg = x.to(torch.float32).reshape(shp[:-1] + (ng, group))
    pulses, rho = ops.pvq_encode(xg.reshape(-1, group), k_pulses=k)
    p8 = ops.pulses_to_int8(pulses).reshape(xg.shape)
    if k <= 127:
        scales = rho.reshape(xg.shape[:-1])
    else:
        scales = _scales(xg, p8, "ls").to(torch.float32)
    _probe_kv_encode(xg, p8, scales)
    return p8.reshape(shp), scales


def _probe_kv_encode(xg, p8, scales) -> None:
    """KV-block reconstruction SNR + saturation probe (telemetry only).
    It reads its values back to the host, so it bails while a CUDA graph
    is being captured (a captured decode step's block fill)."""
    from ..runtime import obs, telemetry

    if not obs.enabled() or graph_capturing():
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


def _ring_write(tail_k: torch.Tensor, tail_v: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, pos: torch.Tensor) -> None:
    """``tail[i, pos[i] % block] = new[i, 0]`` for every row ``i``, K and V,
    in place: one ``index_copy_`` each on the flattened rings, at device
    positions ``pos (rows,)``."""
    n, blk = tail_k.shape[:2]
    ring = torch.arange(0, n * blk, blk, device=tail_k.device) \
        + torch.remainder(pos.to(torch.int64), blk)
    tail_k.view(n * blk, *tail_k.shape[2:]).index_copy_(0, ring, k_new[:, 0].to(tail_k.dtype))
    tail_v.view(n * blk, *tail_v.shape[2:]).index_copy_(0, ring, v_new[:, 0].to(tail_v.dtype))


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

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor, pos,
               fill: Optional[bool] = None) -> "PackedKV":
        """Write one decode step ``(b, 1, n_kv, hd)`` in place.  The row lands
        in the tail ring in the cache dtype; when it completes a block, the
        whole ring is PVQ-encoded into the planes.

        ``pos`` is a host int (the eager lockstep step: the ring slot and
        the block fill follow from it) or a ``(b,)`` device tensor (the
        captured step, which reads no position on the host).  With a tensor,
        ``fill`` is the host's choice (the lockstep loop knows the position,
        and replays the graph captured with or without the fill): the ring
        write is an ``index_copy_`` at ``pos % block``, and a fill writes the
        encoded ring to rows ``pos + 1 - block ..`` computed on the device.
        Both forms write the same bytes."""
        if isinstance(pos, torch.Tensor):
            if fill is None:
                raise ValueError("PackedKV.append at device positions needs the host's fill flag")
            _ring_write(self.tail_k, self.tail_v, k_new, v_new, pos)
            if fill:
                self._fill_at(pos)
            return self
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

    def _fill_at(self, pos: torch.Tensor) -> None:
        """Encode the ring of each row into its planes' rows ``pos + 1 -
        block .. pos`` (device positions ``(b,)``)."""
        blk = self.block
        b, s = self.k_pulses.shape[:2]
        dev = self.k_pulses.device
        first = torch.arange(b, device=dev) * s + pos.to(torch.int64) + 1 - blk
        rows = (first[:, None] + torch.arange(blk, device=dev)).reshape(-1)
        pk, sk = _kv_encode_planes(self.tail_k, self.group, self.k)
        pv, sv = _kv_encode_planes(self.tail_v, self.group, self.k)
        for plane, val in ((self.k_pulses, pk), (self.k_scales, sk),
                           (self.v_pulses, pv), (self.v_scales, sv)):
            plane.view(b * s, *plane.shape[2:]).index_copy_(
                0, rows, val.reshape(b * blk, *val.shape[2:]))

    def dense_kv(self, filled, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact dense view ``(k, v)`` of shape ``(b, S, n_kv, hd)``: planes
        below ``packed_end(filled)``, the tail ring at and above it.
        ``filled`` is a host int (lockstep batch) or a per-row ``(b,)``
        tensor (the engine's slots).  Rows beyond ``filled`` carry garbage
        and must stay length-masked."""
        blk = self.block
        dev = self.k_pulses.device
        pe = torch.as_tensor(self.packed_end(filled), device=dev)
        pe = pe.expand(self.k_pulses.shape[0])[:, None]  # (b, 1)
        posn = torch.arange(self.max_len, device=dev)[None, :]
        tidx = torch.remainder(posn - pe, blk)  # (b, S) ring slot of each position
        mask = (posn >= pe)[:, :, None, None]

        def expand(pulses, scales):
            return pulses.to(torch.float32) * torch.repeat_interleave(scales, self.group, dim=-1)

        def overlay(deq, tail):
            idx = tidx[:, :, None, None].expand(-1, -1, *tail.shape[2:])
            return torch.where(mask, torch.gather(tail.to(torch.float32), 1, idx), deq)

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
# PagedKV: the physical-page pool of the continuous-batching engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class PagedKV:
    """Physical-page pool view of :class:`PackedKV` for a slot-pool engine
    (``launch.engine``): one attention layer's PVQ-encoded KV blocks live
    in a pool of pages shared by ``n_slots`` decode slots, with **page size
    = kv block size**, so a page is one PVQ encode unit and stays packed.

    * ``k_pages``/``v_pages`` ``(P + 1, page, n_kv, hd)`` int8 and
      ``k_page_scales``/``v_page_scales`` ``(P + 1, page, n_kv, ng)`` f32:
      the pool.  Page ``P`` (the last) is the *trash page*: page-table
      entries of unallocated logical blocks point at it, and whatever it
      holds stays behind the length masks.
    * ``tail_k``/``tail_v`` ``(n_slots, page, n_kv, hd)``: each slot's
      in-flight partial block in the cache dtype (ring slot ``p % page``).
    * ``page_table`` ``(n_slots, max_pages)`` int32 on the pool's device:
      the physical page of each slot's logical block (trash where
      unallocated), read by :meth:`gather`.
    * ``write_page`` ``(n_slots,)`` int32 **on the host**, and
      ``write_page_dev`` the same as int64 on the pool's device: the page a
      slot completes in this decode step, trash for the slots that
      complete none.  The eager :meth:`append` takes the completing slots
      from the host's, the captured one scatters through the device's.
      The engine's allocator owns the tables and hands them over with
      :meth:`with_tables` before each step (after :meth:`bind_tables`, one
      pair of device buffers serves every layer), so a step reads nothing
      back from the device.  The device tables are static buffers,
      refilled in place: a captured step reads them by address.

    Like :class:`PackedKV` (and unlike the reference's immutable pytree),
    every update is in place.
    """

    k_pages: torch.Tensor
    k_page_scales: torch.Tensor
    v_pages: torch.Tensor
    v_page_scales: torch.Tensor
    tail_k: torch.Tensor
    tail_v: torch.Tensor
    page_table: torch.Tensor
    write_page: np.ndarray
    write_page_dev: torch.Tensor
    page: int
    group: int
    k: int
    dtype: str

    @property
    def n_pages(self) -> int:
        """Usable physical pages (the trash page excluded)."""
        return int(self.k_pages.shape[0]) - 1

    @property
    def trash_page(self) -> int:
        return self.n_pages

    @property
    def n_slots(self) -> int:
        return int(self.tail_k.shape[0])

    @property
    def block(self) -> int:
        """The :class:`PackedKV` name of the PVQ encode granularity."""
        return self.page

    def packed_end(self, filled):
        return (filled // self.page) * self.page

    @classmethod
    def init(
        cls, n_slots: int, n_pages: int, max_pages: int, n_kv: int, head_dim: int, *,
        kvq: KVQuant, dtype=torch.bfloat16, device="cuda",
    ) -> "PagedKV":
        g = _fit_group(kvq.group, head_dim)
        page = int(kvq.block)
        ng = head_dim // g

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(
            k_pages=z((n_pages + 1, page, n_kv, head_dim), torch.int8),
            k_page_scales=z((n_pages + 1, page, n_kv, ng), torch.float32),
            v_pages=z((n_pages + 1, page, n_kv, head_dim), torch.int8),
            v_page_scales=z((n_pages + 1, page, n_kv, ng), torch.float32),
            tail_k=z((n_slots, page, n_kv, head_dim), dtype),
            tail_v=z((n_slots, page, n_kv, head_dim), dtype),
            page_table=torch.full((n_slots, max_pages), int(n_pages), dtype=torch.int32,
                                  device=device),
            write_page=np.full((n_slots,), int(n_pages), np.int32),
            write_page_dev=torch.full((n_slots,), int(n_pages), dtype=torch.int64, device=device),
            page=page, group=g, k=int(kvq.k), dtype=dtype_name(dtype),
        )

    def with_tables(self, page_table, write_page) -> "PagedKV":
        """Take the allocator's tables, in place.  ``page_table`` is copied
        into the pool's device table (nothing is copied where it is that
        buffer).  ``write_page`` as host integers is kept on the host (the
        eager append's); as a tensor it is copied into ``write_page_dev``
        (nothing is copied where it is that buffer)."""
        if page_table is not self.page_table:
            self.page_table.copy_(torch.as_tensor(page_table, dtype=torch.int32))
        if not isinstance(write_page, torch.Tensor):
            self.write_page = np.asarray(write_page, np.int32).reshape(self.n_slots)
        elif write_page is not self.write_page_dev:
            self.write_page_dev.copy_(write_page)
        return self

    def bind_tables(self, page_table: torch.Tensor, write_page_dev: torch.Tensor) -> "PagedKV":
        """Read the device tables from these buffers from now on (the engine
        binds one pair to every layer, once, before any step is captured,
        and refills it in place each step)."""
        self.page_table, self.write_page_dev = page_table, write_page_dev
        return self

    # ---------------------------------------------------------------- views

    def _pick(self, pool: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
        """``pool[pt]`` as ``(rows, max_pages * page, n_kv, X)`` (one
        ``index_select``: advanced indexing costs several launches)."""
        g = pool.index_select(0, pt.reshape(-1))
        return g.reshape(pt.shape[0], pt.shape[1] * self.page, g.shape[-2], g.shape[-1])

    def gather(self) -> PackedKV:
        """Slot-major :class:`PackedKV` view through the page table:
        ``k_pulses[slot, b * page + t] = k_pages[page_table[slot, b], t]``.
        Unallocated blocks read the trash page, behind the length mask.
        The planes are a gathered copy; the tails are the pool's own."""
        pt = self.page_table
        return PackedKV(
            k_pulses=self._pick(self.k_pages, pt), k_scales=self._pick(self.k_page_scales, pt),
            v_pulses=self._pick(self.v_pages, pt), v_scales=self._pick(self.v_page_scales, pt),
            tail_k=self.tail_k, tail_v=self.tail_v,
            block=self.page, group=self.group, k=self.k, dtype=self.dtype,
        )

    def gather_slot(self, slot) -> PackedKV:
        """Batch-1 :class:`PackedKV` view of one slot (the chunked-prefill
        read leg attends only to the slot it extends).  ``slot`` is a host
        int (views of the slot's tails) or a one-element device tensor (the
        captured chunk: ``index_select`` of its table row and tails)."""
        if isinstance(slot, torch.Tensor):
            idx = slot.reshape(1).to(torch.int64)
            pt = self.page_table.index_select(0, idx)
            tail_k, tail_v = self.tail_k.index_select(0, idx), self.tail_v.index_select(0, idx)
        else:
            pt = self.page_table[slot : slot + 1]
            tail_k, tail_v = self.tail_k[slot : slot + 1], self.tail_v[slot : slot + 1]
        return PackedKV(
            k_pulses=self._pick(self.k_pages, pt), k_scales=self._pick(self.k_page_scales, pt),
            v_pulses=self._pick(self.v_pages, pt), v_scales=self._pick(self.v_page_scales, pt),
            tail_k=tail_k, tail_v=tail_v,
            block=self.page, group=self.group, k=self.k, dtype=self.dtype,
        )

    def dense_kv(self, filled, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact dense oracle view (through the gathered :class:`PackedKV`)."""
        return self.gather().dense_kv(filled, dtype=dtype)

    # -------------------------------------------------------------- updates

    def _write_pages(self, ids: np.ndarray, k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
        """PVQ-encode blocks ``(n, page, n_kv, hd)`` of K and V (one encode
        for both: the code is per group row) into pages ``ids``.  Every
        index is a host integer, so nothing is copied to the device."""
        n = k_rows.shape[0]
        pulses, scales = _kv_encode_planes(
            torch.cat([k_rows, v_rows]).to(torch.float32), self.group, self.k)
        for i, j, pid in _runs(ids):
            dst = slice(pid, pid + j - i)
            self.k_pages[dst] = pulses[i:j]
            self.k_page_scales[dst] = scales[i:j]
            self.v_pages[dst] = pulses[n + i : n + j]
            self.v_page_scales[dst] = scales[n + i : n + j]

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor, pos: torch.Tensor,
               fill: Optional[bool] = None) -> "PagedKV":
        """Write one decode step ``(n_slots, 1, n_kv, hd)`` at per-slot
        positions ``pos (n_slots,)`` (a device tensor), in place.  Each
        slot's row lands in its tail ring at ``pos % page``.

        The slots that complete a block in this step have their ring
        PVQ-encoded into the page they were assigned.  With ``fill`` None
        (the eager step) the host's ``write_page`` names them and only
        their rings are encoded.  The captured step cannot vary the number
        of rings it encodes, so the host picks one of two graphs instead:
        ``fill=False`` encodes nothing; ``fill=True`` encodes every ring and
        scatters it through ``write_page_dev``, the rings of the slots that
        complete no block to the trash page, as the reference does.  A real
        page gets the same bytes either way."""
        ns = self.n_slots
        _ring_write(self.tail_k, self.tail_v, k_new, v_new, pos)
        if fill is None:
            done = np.nonzero(self.write_page != self.trash_page)[0]
            if done.size:
                self._write_pages(self.write_page[done], _rows(self.tail_k, done),
                                  _rows(self.tail_v, done))
        elif fill:
            pulses, scales = _kv_encode_planes(
                torch.cat([self.tail_k, self.tail_v]).to(torch.float32), self.group, self.k)
            ids = self.write_page_dev
            self.k_pages.index_copy_(0, ids, pulses[:ns])
            self.k_page_scales.index_copy_(0, ids, scales[:ns])
            self.v_pages.index_copy_(0, ids, pulses[ns:])
            self.v_page_scales.index_copy_(0, ids, scales[ns:])
        return self

    def graft(self, k_dense, v_dense, slot, page_ids, real_len) -> "PagedKV":
        """Graft one prefilled request into decode slot ``slot``: the
        ``start = 0`` case of :meth:`graft_chunk`, so whole-prompt and
        chunked prefill share one encode and cannot drift apart."""
        return self.graft_chunk(k_dense, v_dense, slot, page_ids, 0, real_len)

    def graft_chunk(self, k_dense, v_dense, slot, page_ids, start, real_len) -> "PagedKV":
        """Graft one page-aligned prefill chunk into slot ``slot`` (in place).

        ``k_dense``/``v_dense`` ``(1, C, n_kv, hd)`` hold the chunk's exact
        KV for positions ``[start, start + C)``, ``C`` a page multiple and
        ``start`` page-aligned.  ``page_ids (C // page,)`` are the physical
        pages of the chunk's logical blocks, trash for the blocks at and
        after ``real_len // page``; blocks are PVQ-encoded with the same
        ``_kv_encode_planes`` every write path uses.

        The tail ring takes the page window at ``packed_end(real_len) -
        start``, clamped into the chunk as the reference's dynamic slice
        clamps it: only the final chunk writes the real partial block;
        earlier ones write a clamped window that it overwrites, masked by
        length until then.

        Two forms write the same bytes into every real page and ring:

        * host integers (``page_ids`` a host array; the eager engine): only
          the live blocks are encoded, written by slices over runs of ids;
        * device tensors (``page_ids`` a tensor, ``slot`` and ``real_len``
          one-element tensors, ``start`` one too or 0; the captured graft
          and chunk): nothing is read on the host, so every block is encoded and
          scattered with ``index_copy_`` through ``page_ids``, the blocks
          past the context to the trash page, as the reference does; the
          tail window is taken at the clamped device offset and written at
          the device slot.
        """
        page = self.page
        kf = k_dense[0].to(torch.float32)
        vf = v_dense[0].to(torch.float32)
        c = kf.shape[0]
        blocks = (c // page, page) + tuple(kf.shape[1:])
        if isinstance(page_ids, torch.Tensor):
            nb = c // page
            pulses, scales = _kv_encode_planes(
                torch.cat([kf.reshape(blocks), vf.reshape(blocks)]), self.group, self.k)
            ids = page_ids.reshape(nb).to(torch.int64)
            self.k_pages.index_copy_(0, ids, pulses[:nb])
            self.k_page_scales.index_copy_(0, ids, scales[:nb])
            self.v_pages.index_copy_(0, ids, pulses[nb:])
            self.v_page_scales.index_copy_(0, ids, scales[nb:])
            if isinstance(start, torch.Tensor):
                start = start.reshape(1).to(torch.int64)
            off = self.packed_end(real_len.reshape(1).to(torch.int64)) - start
            rows = off.clamp(0, c - page) + torch.arange(page, device=kf.device)
            at = slot.reshape(1).to(torch.int64)
            self.tail_k.index_copy_(0, at, kf.index_select(0, rows)[None].to(self.tail_k.dtype))
            self.tail_v.index_copy_(0, at, vf.index_select(0, rows)[None].to(self.tail_v.dtype))
            return self
        ids = np.asarray(page_ids, np.int64).reshape(c // page)
        live = np.nonzero(ids != self.trash_page)[0]
        if live.size:
            self._write_pages(ids[live], _rows(kf.reshape(blocks), live),
                              _rows(vf.reshape(blocks), live))
        off = min(max(int(self.packed_end(int(real_len))) - int(start), 0), c - page)
        self.tail_k[slot] = kf[off : off + page].to(self.tail_k.dtype)
        self.tail_v[slot] = vf[off : off + page].to(self.tail_v.dtype)
        return self

    def __repr__(self) -> str:
        return (
            f"PagedKV(pages={self.n_pages}, page={self.page}, slots={tuple(self.tail_k.shape)}, "
            f"dtype={self.dtype}, group={self.group}, k={self.k})"
        )


def is_paged_kv(leaf: Any) -> bool:
    return isinstance(leaf, PagedKV)


def _runs(ids: np.ndarray):
    """``(i, j, first id)`` of each maximal run ``ids[i:j]`` of consecutive
    ascending ids (pages from a fresh free list come out in one run)."""
    out, i = [], 0
    while i < len(ids):
        j = i + 1
        while j < len(ids) and ids[j] == ids[j - 1] + 1:
            j += 1
        out.append((i, j, int(ids[i])))
        i = j
    return out


def _rows(t: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``t[idx]`` for host indices: a slice where they run consecutively,
    else a stack of views; no index tensor is copied to the device."""
    if idx[-1] - idx[0] == len(idx) - 1:
        return t[int(idx[0]) : int(idx[-1]) + 1]
    return torch.stack([t[int(i)] for i in idx])


# ---------------------------------------------------------------------------
# Pulse geometry: layout -> canonical symbol orders (entropy coding + stats)
# ---------------------------------------------------------------------------


def pulse_stream(pk: PackedPVQ) -> np.ndarray:
    """1-D int64 host stream of the *logical* pulse symbols (no structural
    padding): the order the ``.pvqz`` entropy streams encode.  The matmul
    layout walks column-major over the contraction dim (groups stay
    contiguous) and drops the group-padding rows; the flat layout walks
    row-major and drops the tail padding."""
    pulses = pk.pulses.detach().cpu().numpy().astype(np.int64)
    if pk.layout == "matmul":
        d_in = int(pk.shape[-2])
        return np.swapaxes(pulses, -1, -2)[..., :d_in].ravel()
    numel = int(np.prod(pk.shape))
    lead = pulses.shape[:-2]
    return pulses.reshape(*lead, -1)[..., :numel].ravel()


def pulse_groups(pk: PackedPVQ) -> np.ndarray:
    """(G_total, group) group-major int64 host view, padded groups included:
    the geometry the enumeration codec and the per-group size models price."""
    pulses = pk.pulses.detach().cpu().numpy().astype(np.int64)
    if pk.layout == "matmul":
        return np.swapaxes(pulses, -1, -2).reshape(-1, pk.group)
    return pulses.reshape(-1, pk.group)


# ---------------------------------------------------------------------------
# Encoding single arrays
# ---------------------------------------------------------------------------


#: stacked leaves above this many elements are packed one leading-axis
#: slice at a time (each matrix is its own code, so the result is
#: byte-identical); it bounds the f32 and int32 transients of a pack
PACK_CHUNK_ELEMS = 1 << 28


def pack_matmul(
    w: torch.Tensor, *, group: int, n_over_k: Optional[float] = None,
    k: Optional[int] = None, scale_mode: str = "ls",
) -> PackedPVQ:
    """Encode a dense weight ``(..., d_in, d_out)`` (leading axes: a layer
    or expert stack, each matrix its own code) into the kernel-native
    matmul layout.  For K > 127 a coordinate may be clamped to the int8
    range, so rho is refit against the pulses actually stored.  A stack of
    more than ``PACK_CHUNK_ELEMS`` elements is encoded one leading slice at
    a time into preallocated planes."""
    if w.ndim < 2:
        raise ValueError(f"matmul layout needs a tensor of rank >= 2, got {tuple(w.shape)}")
    d_in, d_out = w.shape[-2:]
    g, k_pad = matmul_plan(group, d_in)
    k = _resolve_k(g, n_over_k, k)
    if w.ndim > 2 and w.numel() > PACK_CHUNK_ELEMS:
        pulses = torch.empty((*w.shape[:-2], k_pad, d_out), dtype=torch.int8, device=w.device)
        scales = torch.empty((*w.shape[:-2], k_pad // g, d_out), dtype=torch.float32,
                             device=w.device)
        for i in range(w.shape[0]):
            part = pack_matmul(w[i], group=group, k=k, scale_mode=scale_mode)
            pulses[i], scales[i] = part.pulses, part.scales
    else:
        pulses, scales = _encode_matmul(w, g, k, scale_mode)
    return PackedPVQ(
        pulses=pulses, scales=scales, group=g, k=k, shape=(int(d_in), int(d_out)),
        dtype=dtype_name(w.dtype), layout="matmul", scale_mode=scale_mode,
    )


def _encode_matmul(w: torch.Tensor, g: int, k: int, scale_mode: str):
    """``(pulses int8 (..., k_pad, n), scales f32 (..., k_pad // g, n))``."""
    from ..kernels import ops
    from .pvq import _scales

    d_in, d_out = w.shape[-2:]
    wf = w.to(torch.float32)
    pulses, scales, k_pad = ops.encode_weight_matrix(wf, group=g, k_pulses=k)
    if scale_mode != "ls" or k > 127:
        pad = k_pad - d_in
        wp = torch.nn.functional.pad(wf, (0, 0, 0, pad)) if pad else wf
        lead = wp.shape[:-2]
        wg = wp.transpose(-1, -2).reshape(*lead, d_out, k_pad // g, g)
        pg = pulses.transpose(-1, -2).reshape(*lead, d_out, k_pad // g, g)
        scales = _scales(wg, pg, scale_mode).transpose(-1, -2).to(torch.float32).contiguous()
    return pulses, scales


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


def packed_update(packed: PackedPVQ, delta: torch.Tensor) -> PackedPVQ:
    """Apply a dense additive update to a packed leaf: dequantize, add,
    re-encode onto the same pyramid (same layout, group and K).  The
    explicit re-encode point for fine-tuning or an EMA on a packed
    artifact; the gradient pipeline (``optim.grad_compress``) leaves packed
    leaves frozen."""
    dense = packed.dequantize(torch.float32)
    lead = packed.pulses.shape[: packed.pulses.ndim - 2]
    updated = dense + delta.to(torch.float32).reshape(*lead, *packed.shape)
    dtype = torch_dtype(packed.dtype)
    if packed.layout == "matmul":
        return pack_matmul(updated.to(dtype), group=packed.group, k=packed.k,
                           scale_mode=packed.scale_mode)
    return pack_flat(updated.to(dtype), group=packed.group, k=packed.k,
                     scale_mode=packed.scale_mode,
                     row_align=packed.shape[-1] if len(packed.shape) >= 2 else None)


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


def sorted_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` of a nested dict in sorted key order at every level
    (the order in which JAX flattens a dict, so the reference's): the leaf
    order of a ``.pvqz`` file and of the size reports."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from sorted_leaves(tree[key], f"{prefix}/{key}" if prefix else str(key))
    else:
        yield prefix, tree


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
    # stacked MoE expert banks: (E, d_in, d_out) or layer-stacked
    # (repeats, E, d_in, d_out), one code per expert matrix
    if re.search(EXPERT_LEAF_REGEX, pstr) and leaf.ndim in (3, 4):
        return pack_matmul(leaf, group=g, n_over_k=n_over_k, scale_mode=scale_mode)
    return None


def quantize_params(params: Any, policy: QuantPolicy, *, min_size: int = 64,
                    prefix: str = "") -> Any:
    """Encode a parameter tree once into ``PackedPVQ`` leaves (dense kernels,
    embeddings, expert banks) and untouched leaves (norms and anything
    without a packed consumer).

    Packs in place: each packed leaf replaces its dense leaf in ``params``
    as soon as it is encoded, so a dense leaf's memory is released before
    the next one is packed (a model that fills most of the card).  Returns
    ``params``; a caller that needs the dense tree afterwards packs a copy.
    ``prefix`` is the path of ``params`` in its model's tree (a part of a
    model packed on its own, :func:`quantize_layer`).
    """

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

    def pack_dict(tree, prefix):
        for key in list(tree):
            pstr = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(tree[key], dict):
                pack_dict(tree[key], pstr)
            else:
                tree[key] = visit(pstr, tree[key])
        return tree

    return pack_dict(params, prefix)


def _map_in_place(fn, tree: dict) -> dict:
    for key in list(tree):
        if isinstance(tree[key], dict):
            _map_in_place(fn, tree[key])
        else:
            tree[key] = fn(tree[key])
    return tree


def quantize_layer(layer: dict, policy: QuantPolicy, *, prefix: str, repeats: int,
                   min_size: int = 64) -> dict:
    """Pack one layer of a stack of ``repeats`` layers at ``prefix`` in
    place, leaf by leaf as :func:`quantize_params` packs the stacked tree:
    each leaf is handed over with the stack's leading axis (of length 1)
    and the stack's size counts against ``min_size``.  Each code is one
    matrix's, so the layer's pulses and scales are those of its slice of
    the packed stack, byte for byte.  Returns ``layer`` unstacked again
    (tensors and ``PackedPVQ.stack_item(0)``)."""
    _map_in_place(lambda t: t[None] if isinstance(t, torch.Tensor) else t, layer)
    quantize_params(layer, policy, min_size=-(-min_size // repeats), prefix=prefix)
    return _map_in_place(
        lambda t: t.stack_item(0) if is_packed(t) else (t[0] if isinstance(t, torch.Tensor) else t),
        layer)


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


def expert_leaves(params: Any) -> Dict[str, PackedPVQ]:
    """{path: PackedPVQ} for the packed MoE expert banks only."""
    return {k: v for k, v in packed_leaves(params).items() if re.search(EXPERT_LEAF_REGEX, k)}


def dequantize_params(params: Any) -> Any:
    """Inverse transform: expand every ``PackedPVQ`` leaf back to dense."""
    return tree_map_with_path(lambda _, leaf: materialize(leaf), params)


def packed_stats(params: Any, *, entropy: bool = True) -> Dict[str, float]:
    """Aggregate artifact-size report for a mixed parameter tree.

    Beyond the int8 + f32 byte counts, ``entropy=True`` (default) prices the
    pulse streams under the paper's §VI codecs with the exact ``codes`` size
    models.  ``entropy_bits_per_weight`` applies the ``.pvqz`` per-leaf
    selection rule itself (``bitstream.choose_codec``), so it reports what
    ``write_pvqz`` would produce; the per-codec ``*_bits_per_weight`` keys
    are whole-tree totals under that single codec (``enum`` wherever its
    count tables fit memory).  Leaves are walked in sorted key order, the
    reference's, so the float sums match it bit for bit.
    """
    packed_bytes = replaced = untouched = n_packed = 0
    numel = scale_bits = 0
    best_bits = 0.0
    codec_bits = {"golomb": 0.0, "rle": 0.0, "enum": 0.0}
    enum_priceable = True
    for _, leaf in sorted_leaves(params):
        if is_packed(leaf):
            packed_bytes += leaf.nbytes_packed
            replaced += leaf.nbytes_dense
            n_packed += 1
            if entropy:
                from . import bitstream

                stream = pulse_stream(leaf)
                numel += stream.size
                scale_bits += 32 * leaf.scales.numel()
                chosen, sizes = bitstream.choose_codec(stream, pulse_groups(leaf), leaf.k)
                best_bits += sizes[chosen]
                codec_bits["golomb"] += sizes["golomb"]
                codec_bits["rle"] += sizes["rle"]
                if "enum" in sizes:
                    codec_bits["enum"] += sizes["enum"]
                else:
                    enum_priceable = False
        elif isinstance(leaf, torch.Tensor):
            untouched += leaf.numel() * leaf.element_size()
    out = {
        "packed_tensors": n_packed,
        "packed_bytes": packed_bytes,
        "replaced_dense_bytes": replaced,
        "untouched_bytes": untouched,
        "weight_compression_ratio": replaced / max(packed_bytes, 1),
        "total_bytes": packed_bytes + untouched,
    }
    if entropy and n_packed:
        if not enum_priceable:
            del codec_bits["enum"]
        for codec, bits in codec_bits.items():
            out[f"{codec}_bits_per_weight"] = bits / max(numel, 1)
        out["entropy_bits_per_weight"] = (best_bits + scale_bits) / max(numel, 1)
        out["entropy_coded_bytes_est"] = int((best_bits + scale_bits) // 8)
        out["entropy_compression_ratio"] = 8.0 * replaced / max(best_bits + scale_bits, 1.0)
    return out
