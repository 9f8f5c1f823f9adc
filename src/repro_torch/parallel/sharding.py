"""Sharding rules: logical activation and parameter axes -> DTensor placements
(port of ``repro.parallel.sharding``).

Mesh axes (see ``launch.mesh``):
    pod    — inter-pod axis (DP by default; pipeline stage axis in PP mode)
    data   — intra-pod data parallel + FSDP (params/optimizer sharded here)
    model  — tensor parallel (heads / ffn hidden / experts) + optional SP

The reference writes a sharding as a ``PartitionSpec`` over a named JAX
mesh and lets XLA's SPMD partitioner split the step.  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names, a
spec is a :class:`PSpec` with ``P``'s entries (``None``, an axis name, or a
tuple of axis names, one entry per tensor dim), and :func:`to_placements`
turns it into one ``Shard(d)``/``Replicate()`` per mesh dim.  Parameters,
optimizer moments, batches and caches become ``DTensor``s with those
placements, and the model's plain torch code runs on them: DTensor's
sharding propagation takes the place of SPMD partitioning.

Activation constraints go through :func:`constrain` with symbolic axes
('dp', 'tp', 'sp', 'cp', 'seq', None) resolved against the *active* mesh
(:func:`use_mesh` stands in for the reference's ``with mesh:``), so model
code is mesh-agnostic: without an active mesh, or on a plain tensor,
``constrain`` returns its input unchanged.

The rule functions (:func:`param_pspec`, :func:`cache_pspec`) take any
object with ``.shape`` (axis name -> size) and ``.axis_names``, so they are
tested on duck meshes of production size without a process group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
from typing import Any, Dict, List, Tuple

import torch

from ..core.packed import PackedKV, PagedKV, is_packed


# ---------------------------------------------------------------------------
# Specs and placements
# ---------------------------------------------------------------------------


class PSpec(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh axis
    name, or a tuple of mesh axis names (major to minor), as JAX's ``P``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or a duck mesh's ``.shape``)."""
    if isinstance(mesh.shape, dict):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(mesh.mesh_dim_names)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: PSpec, mesh) -> List[Any]:
    """``spec`` as a DTensor placement list (one per mesh dim): mesh dim
    ``m`` is ``Shard(d)`` when tensor dim ``d`` names its axis, else
    ``Replicate()``.  A tensor dim split over several axes takes them in
    mesh-dim order, which is DTensor's major-to-minor order; a spec that
    lists them otherwise would mean another layout, and raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: axes {axes} of dim {d} are not in mesh order {names}")
        for m in order:
            # a mesh dim of size 1 holds the whole tensor either way; Replicate
            # keeps DTensor's view rules off shards of size-1 dims
            if sizes[names[m]] > 1:
                out[m] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh, with its placements: the counterpart of JAX's
    ``NamedSharding``."""

    mesh: Any
    spec: PSpec

    @property
    def placements(self) -> List[Any]:
        return to_placements(self.spec, self.mesh)


# ---------------------------------------------------------------------------
# Active mesh + policy
# ---------------------------------------------------------------------------

_local = threading.local()


def active_mesh():
    """The mesh installed by :func:`use_mesh` (None outside)."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh for :func:`constrain` (the reference's
    ``with mesh:``)."""
    old = active_mesh()
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = old


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How activations/params are sharded for the current step function.

    The `opt_*` fields are the §Perf hillclimb levers; defaults reproduce the
    recorded baseline.
    """

    seq_shard: bool = False  # Megatron-style sequence parallelism on residuals
    context_parallel: bool = False  # shard decode KV cache along sequence (data axis)
    fsdp_pod: bool = False  # extend FSDP over the pod axis too (ZeRO across pods)
    # --- opt levers ---
    serve_params: bool = False  # serving layout: no FSDP on params (TP/EP only;
    #                              expert ffn dim sharded over data instead)
    cache_seq_tp: bool = False  # decode KV cache sequence axis sharded over model
    moe_light_combine: bool = False  # slot-gate combine (no f32 (g,s,e,c) tensor)
    remat: str = "full"  # 'full' | 'dots' (save matmul outputs) | 'collectives'
    #                       (save the mixer and FFN outputs only) | 'none'


def current_policy() -> ShardingPolicy:
    return getattr(_local, "policy", ShardingPolicy())


@contextlib.contextmanager
def sharding_policy(policy: ShardingPolicy):
    old = current_policy()
    _local.policy = policy
    try:
        yield
    finally:
        _local.policy = old


# ---------------------------------------------------------------------------
# Symbolic axis resolution
# ---------------------------------------------------------------------------


def dp_axes(mesh=None):
    mesh = mesh or active_mesh()
    if mesh is None:
        return None
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return axes or None


def tp_axis(mesh=None):
    mesh = mesh or active_mesh()
    if mesh is None:
        return None
    return "model" if "model" in axis_names(mesh) else None


def _resolve(sym, mesh, policy: ShardingPolicy):
    names = axis_names(mesh)
    if sym is None:
        return None
    if sym == "dp":
        return dp_axes(mesh)
    if sym == "tp":
        return tp_axis(mesh)
    if sym == "sp":  # sequence-parallel position: only when policy enables it
        return tp_axis(mesh) if policy.seq_shard else None
    if sym == "cp":  # context-parallel (decode KV seq axis)
        return "data" if (policy.context_parallel and "data" in names) else None
    if sym == "seq":  # decode cache sequence axis: cp (data) and/or tp (model)
        axes = []
        if policy.context_parallel and "data" in names:
            axes.append("data")
        if policy.cache_seq_tp and "model" in names:
            axes.append("model")
        return tuple(axes) if axes else None
    if sym in ("pod", "data", "model"):
        return sym if sym in names else None
    raise ValueError(f"unknown symbolic axis {sym!r}")


def constrain_spec(shape: Tuple[int, ...], syms, mesh, policy: ShardingPolicy) -> PSpec:
    """The spec :func:`constrain` gives a tensor of ``shape``: mesh axes
    claimed by an earlier dim are dropped from later dims (e.g. batch='dp'
    uses 'data', so a 'seq'=('data','model') KV axis degrades to
    ('model',)), and an axis whose extent does not divide its dim is
    dropped too (the dim stays whole rather than padded)."""
    sizes = mesh_shape(mesh)
    used: set = set()
    resolved = []
    for dim, s in zip(shape, syms):
        ax = tuple(a for a in _axes(_resolve(s, mesh, policy)) if a not in used)
        if ax and dim % math.prod(sizes[a] for a in ax):
            ax = ()
        used.update(ax)
        resolved.append(ax if ax else None)
    return PSpec(*resolved)


def constrain(x, *syms):
    """``x`` redistributed to the symbolic layout ``syms``, and its gradient
    too (the reference's ``with_sharding_constraint``): a no-op without an
    active mesh or on a plain tensor."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = constrain_spec(tuple(x.shape), syms, mesh, current_policy())
    placements = to_placements(spec, mesh)
    if tuple(placements) != tuple(x.placements):
        x = x.redistribute(mesh, placements)
    # the gradient takes the same layout, as XLA's constraint binds the
    # cotangent too (a redistribute's backward only restores its input's)
    return _HoldLayout.apply(x) if x.requires_grad else x


def split_last(t, *sizes):
    """``t.reshape(*t.shape[:-1], *sizes)``: the last dim split into
    ``sizes`` (heads x head dim).  On a DTensor whose last dim is sharded
    over an extent that does not divide ``sizes[0]`` (15 heads over 8
    ranks), the last dim is gathered first: DTensor does not reshape an
    uneven shard, where XLA would reshard on its own."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(t, DTensor):
        last = t.ndim - 1
        on_last = [isinstance(p, Shard) and p.dim in (last, -1) for p in t.placements]
        extent = math.prod(t.device_mesh.size(m) for m, on in enumerate(on_last) if on)
        if sizes[0] % extent:
            t = t.redistribute(t.device_mesh, [Replicate() if on else p
                                               for p, on in zip(t.placements, on_last)])
    return t.reshape(*t.shape[:-1], *sizes)


def pad_dim(t, dim: int, pad: int):
    """``t`` zero-padded by ``pad`` rows at the end of ``dim``.  A DTensor
    is padded shard by shard (its ``dim`` gathered first if it is sharded)
    and keeps its placements: DTensor versions differ in whether, and how,
    they lay out ``constant_pad_nd``'s result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    widths = [0, 0] * (t.ndim - 1 - dim) + [0, pad]
    if not isinstance(t, DTensor):
        return torch.nn.functional.pad(t, widths)
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in t.placements]
    if list(pl) != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    local = torch.nn.functional.pad(t.to_local(), widths)
    return DTensor.from_local(local, t.device_mesh, pl, run_check=False)


class _HoldLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the forward value
    was laid out."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def merge_last(t, n: int):
    """``t`` with its last two dims (heads x head dim) merged into one of
    size ``n``.  On a DTensor the merged value keeps its layout for the
    gradient too: the gradient that comes back may be sharded where the
    heads were not (15 heads on 8 ranks), and DTensor cannot split such a
    shard back into heads."""
    from torch.distributed.tensor import DTensor

    out = t.reshape(*t.shape[:-2], n)
    return _HoldLayout.apply(out) if isinstance(out, DTensor) else out


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

# (path_regex, spec_by_rank) — first match wins. Specs are written for the
# UNSTACKED tensor; stacked params (path contains 'segments/') get a
# leading None prepended automatically when rank exceeds the rule's.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    # --- packed PVQ artifact children (a PackedPVQ leaf yields
    # <param>/pulses + <param>/scales; see core.packed) ---
    # flat-layout embedding: groups are row-major over vocab, so the leading
    # axis shards like the vocab axis (vocab-parallel logits)
    (r"embedding/pulses$", ("tp", None)),
    (r"embedding/scales$", ("tp",)),
    # row-parallel matmul layout: contraction (k_pad) axis on model; the
    # scales' group axis tiles the same contraction dim
    (r"(wo|out|out_proj)/kernel/pulses$", ("tp", "fsdp")),
    (r"(wo|out|out_proj)/kernel/scales$", ("tp", "fsdp")),
    # packed MoE expert banks (expert-stacked matmul layout): E on model
    # (EP); wi pulses (E, d_pad, f) shard the contraction dim on data
    # (FSDP), wo pulses (E, f_pad, d) shard the output dim on data.  The
    # scales' group axes (d_pad/group, f_pad/group) are short and stay
    # unsharded unless divisible (wo scales tile the model dim n=d).
    (r"wi_(up|gate)_experts/pulses$", ("tp", "fsdp", None)),
    (r"wi_(up|gate)_experts/scales$", ("tp", None, None)),
    (r"wo_experts/pulses$", ("tp", None, "fsdp")),
    (r"wo_experts/scales$", ("tp", None, "fsdp")),
    # column-parallel / generic matmul layout: FSDP in, TP out (scales'
    # group axis is short — k_pad/group — so only the n axis shards)
    (r"kernel/pulses$", ("fsdp", "tp")),
    (r"kernel/scales$", (None, "tp")),
    # embeddings: vocab on model (vocab-parallel logits), d on data (FSDP)
    (r"embedding$", ("tp", "fsdp")),
    (r"pos_embedding$", (None, "fsdp")),
    # MoE stacked experts: E on model (EP), d_model on data (FSDP)
    (r"wi_(up|gate)_experts$", ("tp", "fsdp", None)),
    (r"wo_experts$", ("tp", None, "fsdp")),
    (r"router/kernel$", (None, None)),
    # row-parallel outputs (contract dim is model-sharded)
    (r"(wo|out|out_proj)/kernel$", ("tp", "fsdp")),
    # column-parallel inputs
    (r"(wq|wk|wv|wg|wr|wi_gate|wi_up|wq_a|wq_b|wkv_a|wk_rope|wk_b|wv_b|in_proj|x_proj|dt_proj|wi)/kernel$", ("fsdp", "tp")),
    # generic dense kernels: FSDP in, TP out
    (r"kernel$", ("fsdp", "tp")),
    # mamba recurrence params: d_inner is model-sharded
    (r"a_log$", ("tp", None)),
    (r"d_skip$", ("tp",)),
    (r"conv_kernel$", (None, "tp")),
    (r"conv_bias$", ("tp",)),
    # rwkv head-structured params
    (r"time_faaaa$", ("tp", None)),
    # biases / norm scales / small vectors: replicated
    (r"(bias|scale|base|w1|w2)$", None),
)


def _fsdp_axes(mesh, policy: ShardingPolicy):
    if policy.serve_params:
        return None  # serving: params replicated over data (TP/EP shards only)
    names = axis_names(mesh)
    axes = []
    if policy.fsdp_pod and "pod" in names:
        axes.append("pod")
    if "data" in names:
        axes.append("data")
    return tuple(axes) if axes else None


# Serving layout for MoE expert weights: EP over model, and the expert FFN
# hidden dim sharded over data (no per-step weight all-gathers; the
# down-proj contraction reduces a tokens-sized tensor instead — tiny at
# decode batch sizes).
_SERVE_EXPERT_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    # packed children first (their paths end in /pulses|/scales, so the
    # dense rules below can never shadow them): EP over model; the expert
    # FFN hidden dim (f on wi's output axis, f_pad on wo's group-padded
    # contraction axis) shards over data, exactly like the dense bank
    (r"wi_(up|gate)_experts/pulses$", ("tp", None, "data")),
    (r"wi_(up|gate)_experts/scales$", ("tp", None, "data")),
    (r"wo_experts/pulses$", ("tp", "data", None)),
    (r"wo_experts/scales$", ("tp", "data", None)),
    (r"wi_(up|gate)_experts$", ("tp", None, "data")),
    (r"wo_experts$", ("tp", "data", None)),
)


def _divisible(shape, resolved, mesh) -> PSpec:
    """Never shard an axis that isn't divisible by its mesh extent."""
    sizes = mesh_shape(mesh)
    final = []
    for dim, axes in zip(shape, resolved):
        if axes is None:
            final.append(None)
            continue
        extent = math.prod(sizes[a] for a in _axes(axes))
        final.append(axes if dim % extent == 0 else None)
    return PSpec(*final)


def param_pspec(path: str, shape: Tuple[int, ...], mesh, policy: ShardingPolicy) -> PSpec:
    """Spec for one parameter leaf."""
    rules = _PARAM_RULES
    if policy.serve_params:
        rules = _SERVE_EXPERT_RULES + _PARAM_RULES
    for pat, spec in rules:
        if re.search(pat, path):
            if spec is None:
                return PSpec()
            resolved = []
            for s in spec:
                if s == "fsdp":
                    resolved.append(_fsdp_axes(mesh, policy))
                elif s == "tp":
                    resolved.append(tp_axis(mesh))
                else:
                    resolved.append(s)
            # stacked tensors carry extra leading axes
            extra = len(shape) - len(spec)
            if extra > 0:
                resolved = [None] * extra + resolved
            elif extra < 0:
                return PSpec()  # rank mismatch: fall back to replicated
            return _divisible(shape, resolved, mesh)
    return PSpec()


def param_leaves(params: Any, prefix: str = ""):
    """``(path, tensor)`` over a params tree in insertion order; a
    ``PackedPVQ`` leaf yields ``<param>/pulses`` and ``<param>/scales``, as
    the reference's pytree node does."""
    if isinstance(params, dict):
        for key, sub in params.items():
            yield from param_leaves(sub, f"{prefix}/{key}" if prefix else str(key))
    elif is_packed(params):
        yield f"{prefix}/pulses", params.pulses
        yield f"{prefix}/scales", params.scales
    else:
        yield prefix, params


def _map_params(fn, params: Any, prefix: str = ""):
    """``fn(path, tensor)`` over a params tree, rebuilding it; a packed
    leaf maps to ``{"pulses": ..., "scales": ...}`` of its children."""
    if isinstance(params, dict):
        return {k: _map_params(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in params.items()}
    if is_packed(params):
        return {"pulses": fn(f"{prefix}/pulses", params.pulses),
                "scales": fn(f"{prefix}/scales", params.scales)}
    return fn(prefix, params)


def param_shardings(params_shape: Any, mesh, policy: ShardingPolicy = ShardingPolicy()):
    """:class:`Sharding` tree for a params tree (of tensors or shape stand-ins)."""
    return _map_params(
        lambda path, leaf: Sharding(mesh, param_pspec(path, tuple(leaf.shape), mesh, policy)),
        params_shape)


def batch_pspec(mesh, *, context_parallel: bool = False) -> PSpec:
    """Spec for (batch, seq, ...) inputs."""
    if context_parallel:
        return PSpec(None, "data")
    return PSpec(dp_axes(mesh))


# ---------------------------------------------------------------------------
# Decode-cache sharding rules
# ---------------------------------------------------------------------------

# Leaf paths look like  seg0/b3/kv/k  with shapes (repeats, batch, seq, ...),
# the reference's stacked cache.  The port's cache is a list with one entry
# per layer: :func:`cache_shardings` builds the reference's path and shape
# for each layer's leaf, applies the rule and drops the leading repeats
# entry.  The 'seq' symbol shards the cache sequence axis over data (context
# parallel) and/or model (cache_seq_tp) per the active policy; KV heads are
# deliberately NOT model-sharded (n_kv < tp extent for every assigned GQA
# arch — head-sharding would force per-step cache all-gathers).
_CACHE_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    (r"kv/(k|v)$", (None, "dp", "seq", None, None)),
    # PVQ-packed cache children: the pulse/scale planes are seq-indexed
    # exactly like dense k/v; the block-length tail ring is replicated along
    # seq (it is one block).
    (r"kv/(k|v)_pulses$", (None, "dp", "seq", None, None)),
    (r"kv/(k|v)_scales$", (None, "dp", "seq", None, None)),
    (r"kv/tail_(k|v)$", (None, "dp", None, None, None)),
    # Paged slot-pool cache (PagedKV): the physical page pool is shared by
    # every slot — pages from different sequences interleave freely — so it
    # has no batch axis and must be replicated.  Slot-indexed children
    # (page table, write heads; the tail ring reuses the tail rule above)
    # shard their slot axis over data exactly like a batch axis.
    (r"kv/(k|v)_pages$", (None, None, None, None, None)),
    (r"kv/(k|v)_page_scales$", (None, None, None, None, None)),
    (r"kv/page_table$", (None, "dp", None)),
    (r"kv/write_page$", (None, "dp")),
    (r"cross/(k|v)$", (None, "dp", "seq", None, None)),
    (r"mla/c_kv$", (None, "dp", "seq", None)),
    (r"mla/k_rope$", (None, "dp", "seq", None)),
    (r"mamba/conv$", (None, "dp", None, "tp")),
    (r"mamba/ssm$", (None, "dp", "tp", None)),
    (r"rwkv_state$", (None, "dp", "tp", None, None)),
    (r"rwkv_shift_(att|ffn)$", (None, "dp", None)),
)


def cache_pspec(path: str, shape: Tuple[int, ...], mesh, policy: ShardingPolicy) -> PSpec:
    """Spec for one cache leaf at the reference's stacked path and shape."""
    for pat, spec in _CACHE_RULES:
        if re.search(pat, path):
            resolved = [_resolve(s, mesh, policy) for s in spec]
            if len(resolved) != len(shape):
                return PSpec()
            return _divisible(shape, resolved, mesh)
    return PSpec()


#: the tensor children of the packed caches, under the reference's names
_KV_CHILDREN = {
    PackedKV: ("k_pulses", "k_scales", "v_pulses", "v_scales", "tail_k", "tail_v"),
    PagedKV: ("k_pages", "k_page_scales", "v_pages", "v_page_scales", "tail_k", "tail_v",
              "page_table", "write_page_dev"),
}


def cache_leaves(entry: Any, prefix: str):
    """``(path, tensor)`` of one layer's cache entry; a packed cache yields
    its tensor children (``write_page_dev`` under the reference's name
    ``write_page``; the host copy is not a tensor)."""
    if isinstance(entry, dict):
        for k, v in entry.items():
            yield from cache_leaves(v, f"{prefix}/{k}")
    elif type(entry) in _KV_CHILDREN:
        for n in _KV_CHILDREN[type(entry)]:
            yield f"{prefix}/{'write_page' if n == 'write_page_dev' else n}", getattr(entry, n)
    elif isinstance(entry, torch.Tensor):
        yield prefix, entry


def layer_cache_pspec(seg_path: str, repeats: int, path: str, shape: Tuple[int, ...], mesh,
                      policy: ShardingPolicy) -> PSpec:
    """Spec of one layer's cache leaf: the reference's rule at the stacked
    path ``seg_path/path`` and shape ``(repeats,) + shape``, its leading
    (repeats) entry dropped."""
    spec = cache_pspec(f"{seg_path}/{path}", (repeats,) + tuple(shape), mesh, policy)
    if not spec:
        return PSpec()
    if spec[0] is not None:
        raise ValueError(f"cache rule shards the repeats axis of {seg_path}/{path}: {spec}")
    return PSpec(*spec[1:])


def cache_shardings(cache: Any, mesh, policy: ShardingPolicy):
    """``{path: Sharding}`` over a decode cache (``Model.init_cache``'s
    ``{"seg<i>": [layer, ...]}``), keyed ``seg<i>/<r>/b<j>/...``."""
    out = {}
    for seg, layers in cache.items():
        for r, layer in enumerate(layers):
            for path, leaf in cache_leaves(layer, ""):
                path = path.lstrip("/")
                spec = layer_cache_pspec(seg, len(layers), path, tuple(leaf.shape), mesh, policy)
                out[f"{seg}/{r}/{path}"] = Sharding(mesh, spec)
    return out


# ---------------------------------------------------------------------------
# Laying trees out on a mesh
# ---------------------------------------------------------------------------


def distribute(t: torch.Tensor, sharding: Sharding):
    """``t`` as a DTensor with ``sharding``'s placements (every rank's
    ``t`` must be the same; the pieces are cut locally, nothing is sent)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)


def distribute_params(params: Any, shardings: Any) -> Any:
    """A params tree laid out by :func:`param_shardings`'s tree (a packed
    leaf's children by its ``{"pulses", "scales"}``)."""
    if isinstance(params, dict):
        return {k: distribute_params(v, shardings[k]) for k, v in params.items()}
    if is_packed(params):
        return dataclasses.replace(params, pulses=distribute(params.pulses, shardings["pulses"]),
                                   scales=distribute(params.scales, shardings["scales"]))
    return distribute(params, shardings)


def distribute_cache(cache: Any, shardings: Dict[str, Sharding]) -> Any:
    """A decode cache laid out by :func:`cache_shardings`'s ``{path: ...}``
    (a packed cache's tensor children replaced in a copy of it)."""

    def entry(e, prefix):
        if isinstance(e, dict):
            return {k: entry(v, f"{prefix}/{k}") for k, v in e.items()}
        if type(e) in _KV_CHILDREN:
            new = {n: distribute(getattr(e, n),
                                 shardings[f"{prefix}/{'write_page' if n == 'write_page_dev' else n}"])
                   for n in _KV_CHILDREN[type(e)]}
            return dataclasses.replace(e, **new)
        if isinstance(e, torch.Tensor):
            return distribute(e, shardings[prefix])
        return e

    return {seg: [entry(layer, f"{seg}/{r}") for r, layer in enumerate(layers)]
            for seg, layers in cache.items()}


def full_tree(tree: Any) -> Any:
    """Every DTensor of a nested dict/list/tuple (and of packed leaves and
    caches) gathered whole on every rank; plain values unchanged."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(full_tree(v) for v in tree)
    if hasattr(tree, "_fields"):  # NamedTuple (the optimizer state)
        return type(tree)(*(full_tree(v) for v in tree))
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: full_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree
