"""Roofline terms of a traced step on an H100 cluster (port of
``repro.launch.roofline``).

Terms, per GPU (each rank traces its own shard of the step, so GPUs cancel):

    compute    = FLOPs on the local shards      / PEAK_FLOPS
    memory     = local HBM bytes (upper bound)  / HBM_BW
    collective = bytes on the ``model`` axis    / NVLINK_BW
               + bytes on every other axis      / NET_BW

The constants are the datasheet figures of an H100 SXM5 80GB at its 700 W
limit (the card ``nvidia-smi`` names ``NVIDIA H100 80GB HBM3``): dense BF16
tensor-core peak, HBM3 bandwidth, NVLink 4 per direction, and one 400 Gb/s
NDR InfiniBand port per GPU between nodes.  A roofline term is an estimate
from these constants, never a time measured on a card.  The reference's
single ``ICI_BW`` becomes two rates because the ``model`` axis stays inside
an NVLink node and the other axes cross the network (``launch.mesh``).

Collective bytes are not parsed from HLO text: :class:`OpCounter`, a
``TorchDispatchMode`` that sees the local ops beneath DTensor, records every
``_c10d_functional`` collective (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``) with the
bytes of its largest local tensor (operand or result; doubled for
all-reduce: reduce-scatter + all-gather phases of a ring) and the mesh dim
of its group; the pipeline's sends count as ``collective-permute``.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12  # dense bf16 / GPU (H100 SXM5)
HBM_BW = 3.35e12  # bytes/s / GPU (HBM3)
NVLINK_BW = 450e9  # bytes/s / GPU, one direction (NVLink 4, within a node)
NET_BW = 50e9  # bytes/s / GPU (one 400 Gb/s NDR port, between nodes)

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


#: ops that move no data: views, metadata and allocation
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh", "t",
         "_to_copy_meta", "wait_tensor", "device", "dim", "size", "stride", "is_same_size",
         "_unsafe_view", "lift_fresh_copy", "chunk", "split", "split_with_sizes", "unbind"}


class OpCounter(TorchDispatchMode):
    """Counts one rank's work beneath DTensor: FLOPs and HBM bytes of every
    local op, the collectives (:func:`collective_bytes`'s records), and the
    peak bytes of live op outputs (temporaries).

    A DTensor op reaches this mode first with DTensor arguments; the mode
    declines it (``NotImplemented``), DTensor runs its local ops, and those
    come back through the mode on local tensors, which it counts.  DTensor's
    shape propagation runs each op once more on fake tensors at its global
    shapes: those runs are not counted (the counter wraps the
    propagator's meta function while it is active), nor, when
    ``fake_mode`` is given, ops on any tensor not of that mode.  While
    it is active, DTensor reads a strided shard's offsets from a real
    index tensor (a fake one has no values to read)."""

    def __init__(self, mesh=None, fake_mode=None):
        super().__init__()
        self.mesh = mesh
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: List[Dict[str, Any]] = []
        self.live = 0
        self.peak = 0
        self._skip = 0
        self._restore = None
        self._groups = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._groups[mesh.get_group(i).group_name] = name

    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        meta = ShardingPropagator._propagate_tensor_meta_non_cached
        offsets = _StridedShard.local_shard_size_and_offset

        def meta_only(prop, op_schema):
            self._skip += 1
            try:
                return meta(prop, op_schema)
            finally:
                self._skip -= 1

        def real_offsets(*args, **kwargs):
            # a strided shard's offsets are read from an index tensor on the
            # host: a real one, also inside a shape-only trace (not counted)
            self._skip += 1
            try:
                with unset_fake_temporarily():
                    return offsets(*args, **kwargs)
            finally:
                self._skip -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = meta_only
        _StridedShard.local_shard_size_and_offset = real_offsets

        def restore():
            ShardingPropagator._propagate_tensor_meta_non_cached = meta
            _StridedShard.local_shard_size_and_offset = offsets

        self._restore = restore
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._restore()

    def _ours(self, ts) -> bool:
        if self._skip:
            return False
        if self.fake_mode is None:
            return True
        from torch._subclasses.fake_tensor import FakeTensor

        return all(isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode for t in ts)

    def _track(self, out) -> None:
        seen = set()
        for t in _tensors(out):
            try:
                key = t.untyped_storage()._cdata
            except Exception:
                continue
            if key in seen or t._base is not None:
                continue
            seen.add(key)
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def record(self, kind: str, nbytes: float, axis: Optional[str]) -> None:
        self.collectives.append({"kind": kind, "bytes": float(nbytes), "axis": axis})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if not self._ours(ins + outs):
            return out
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns == "_c10d_functional" and name in _FUNCOL_KINDS:
            kind = _FUNCOL_KINDS[name]
            moved = max(_nbytes(t) for t in ins + outs)
            if kind == "all-reduce":
                moved *= 2
            group = next((a for a in list(args) + list(kwargs.values())
                          if isinstance(a, str) and a in self._groups), None)
            self.record(kind, moved, self._groups.get(group))
        elif ns == "aten" and name not in _FREE and not func.is_view:
            from torch.utils.flop_counter import flop_registry

            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
            self._track(out)
        return out


def current_counter():
    """The innermost active :class:`OpCounter` (None when none is)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


def collective_bytes(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum :class:`OpCounter`'s collective records by kind and by mesh axis."""
    per_kind: Dict[str, float] = {k: 0.0 for k in _COLL_KINDS}
    counts: Dict[str, int] = {k: 0 for k in _COLL_KINDS}
    per_axis: Dict[str, float] = {}
    for r in records:
        per_kind[r["kind"]] += r["bytes"]
        counts[r["kind"]] += 1
        axis = r.get("axis") or "none"
        per_axis[axis] = per_axis.get(axis, 0.0) + r["bytes"]
    return {"total_bytes": sum(per_kind.values()), "per_kind_bytes": per_kind,
            "per_kind_counts": counts, "per_axis_bytes": per_axis}


def collective_seconds(coll: Dict[str, Any]) -> float:
    """Bytes on the ``model`` axis at ``NVLINK_BW``, the rest at ``NET_BW``."""
    per_axis = coll.get("per_axis_bytes")
    if per_axis is None:  # no axis recorded: all of it on the network
        return coll["total_bytes"] / NET_BW
    nvl = per_axis.get("model", 0.0)
    return nvl / NVLINK_BW + (coll["total_bytes"] - nvl) / NET_BW


@dataclasses.dataclass
class Roofline:
    flops: float  # per chip
    hbm_bytes: float  # per chip
    coll_bytes: float  # per chip
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # global useful flops (6ND / 2ND)
    chips: int
    useful_ratio: float  # model_flops / (flops * chips)
    collectives: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze_corrected(
    *, flops: float, hbm_bytes: float, coll: Dict[str, Any], chips: int, model_flops: float
) -> Roofline:
    """Roofline from per-chip costs (the reference's name: its costs were
    corrected for XLA counting loop bodies once; an eager trace counts
    every layer)."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    collective_s = collective_seconds(coll)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        flops=flops,
        hbm_bytes=hbm_bytes,
        coll_bytes=coll["total_bytes"],
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        chips=chips,
        useful_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        collectives=coll,
    )


def model_flops_for(cfg, shape, n_active_params: int) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for inference forward."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active_params * tokens


# ---------------------------------------------------------------------------
# Analytic min-traffic model (decode) + PVQ weight streaming
# ---------------------------------------------------------------------------

# PVQ storage cost per weight under the pvq_matmul kernel contract
# (int8 pulses + one f32 scale per `group` weights); nibble variant packs two
# pulses/byte (|pulse| <= 7).
def pvq_bytes_per_weight(group: int = 256, nibble: bool = False) -> float:
    return (0.5 if nibble else 1.0) + 4.0 / group


def analytic_decode_memory(cfg, shape, mesh_sizes: Dict[str, int], n_params_total: int) -> dict:
    """Per-GPU min HBM traffic for one decode step, and the PVQ variant.

    weights: every live weight is read once per step (weight-memory-bound
    decode).  Serving layout (opt>=1): experts sharded over all GPUs,
    non-experts over TP only.  cache: read once + one-token write.  The
    traced memory term is an *unfused upper bound*; this analytic floor
    brackets the truth from below, and is the term the PVQ dequant-matmul
    kernel moves (2B -> ~1.02B or ~0.52B per weight).  ``mesh_sizes`` is
    axis name -> size."""
    chips = math.prod(mesh_sizes.values())
    tp = int(mesh_sizes.get("model", 1))
    b = shape.global_batch
    s = shape.seq_len
    dp = max(chips // tp, 1)

    # weights (bf16), serving layout
    if cfg.moe is not None:
        d_exp = cfg.moe.d_expert
        glu = cfg.moe.activation in ("swiglu", "geglu")
        n_per_expert = cfg.d_model * d_exp * (3 if glu else 2)
        n_experts_total = cfg.moe.n_experts * (cfg.n_layers - cfg.first_dense) * (
            1 if cfg.moe_period == 1 else 1.0 / cfg.moe_period
        )
        n_expert_params = int(n_per_expert * n_experts_total)
        n_rest = n_params_total - n_expert_params
        weight_bytes = 2.0 * n_expert_params / chips + 2.0 * n_rest / tp
    else:
        weight_bytes = 2.0 * n_params_total / tp

    # KV/state cache per chip (batch over dp, seq over tp)
    if cfg.rwkv is not None:
        m = cfg.rwkv.head_size
        cache_bytes = 4.0 * (cfg.d_model // m) * m * m * cfg.n_layers * b / dp
    elif cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        cache_bytes = 2.0 * b * s * per_tok * cfg.n_layers / chips
    elif cfg.hybrid_period:
        attn_layers = cfg.n_layers // cfg.hybrid_period
        kv = 2.0 * b * s * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * attn_layers / chips
        ssm_layers = cfg.n_layers - attn_layers
        d_inner = cfg.ssm.expand * cfg.d_model
        ssm = 4.0 * b * d_inner * cfg.ssm.d_state * ssm_layers / dp
        cache_bytes = kv + ssm
    else:
        cache_bytes = 2.0 * b * s * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * cfg.n_layers / chips

    pvq_w = weight_bytes * pvq_bytes_per_weight(cfg.pvq.group or 256) / 2.0
    pvq_w_nib = weight_bytes * pvq_bytes_per_weight(cfg.pvq.group or 256, nibble=True) / 2.0
    return {
        "weight_bytes_per_chip": weight_bytes,
        "cache_bytes_per_chip": cache_bytes,
        "memory_s_analytic": (weight_bytes + cache_bytes) / HBM_BW,
        "memory_s_analytic_pvq_int8": (pvq_w + cache_bytes) / HBM_BW,
        "memory_s_analytic_pvq_nibble": (pvq_w_nib + cache_bytes) / HBM_BW,
        "pvq_weight_speedup": (weight_bytes + cache_bytes) / (pvq_w + cache_bytes),
        "pvq_nibble_speedup": (weight_bytes + cache_bytes) / (pvq_w_nib + cache_bytes),
    }
