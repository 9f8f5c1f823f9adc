"""Step functions (train / prefill / serve) with their sharding assignments
(port of ``repro.launch.steps``).  Used by the dry-run, and by a run on a
real mesh.

Where the reference hands a step to ``jax.jit`` with in/out shardings, a
:class:`StepBundle` here holds the eager step function and the
:class:`~repro_torch.parallel.sharding.Sharding` of each argument:

* :meth:`StepBundle.distribute` lays the arguments out on the mesh as
  DTensors (params, optimizer moments, batch, cache, token);
* :meth:`StepBundle.run` calls the step with the mesh active
  (``use_mesh``), the policy set and plain tensors taken as replicated
  (``implicit_replication``: the model makes index and mask tensors of
  its own), so DTensor's propagation partitions every op;
* :meth:`StepBundle.trace` runs the step once on its shape-only ``specs``
  (fake tensors) under a :class:`~repro_torch.launch.roofline.OpCounter`.

``donate_argnums`` is kept for parity with the reference and not used (an
eager step frees what it no longer holds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs.base import ShapeConfig
from ..nn.models import Model
from ..optim import AdamW
from ..optim.adamw import AdamWState
from ..parallel.sharding import (
    PSpec,
    Sharding,
    ShardingPolicy,
    cache_shardings,
    distribute,
    distribute_cache,
    distribute_params,
    dp_axes,
    mesh_shape,
    param_shardings,
    sharding_policy,
    use_mesh,
)
from . import inputs as inputs_lib


@dataclasses.dataclass
class StepBundle:
    """A step function plus its in/out shardings and input specs."""

    fn: Callable
    in_shardings: Any
    out_shardings: Any
    specs: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...] = ()
    mesh: Any = None
    policy: ShardingPolicy = ShardingPolicy()
    fake_mode: Any = None

    def distribute(self, *args):
        """The arguments laid out by ``in_shardings``."""
        return tuple(_lay_out(a, s) for a, s in zip(args, self.in_shardings))

    def run(self, *args):
        """The step on already distributed arguments (eager)."""
        from torch.distributed.tensor.experimental import implicit_replication

        with use_mesh(self.mesh), sharding_policy(self.policy), implicit_replication():
            return self.fn(*args)

    def trace(self):
        """Run the step once on ``specs`` under an ``OpCounter`` (in the
        specs' fake mode): returns ``(counter, args_bytes, outputs)``, where
        ``args_bytes`` is one rank's bytes of the distributed arguments."""
        from .roofline import OpCounter

        with self.fake_mode:
            args = self.distribute(*self.specs)
            args_bytes = sum(_local_bytes(t) for t in _leaves(args))
            counter = OpCounter(self.mesh, self.fake_mode)
            with counter:
                out = self.run(*args)
        return counter, args_bytes, out


def _leaves(tree):
    """Every tensor of an argument tree (dicts, lists, the optimizer state,
    packed leaves and packed caches)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, AdamWState):
        yield from _leaves([tree.mu, tree.nu])
    elif isinstance(tree, dict):
        yield from _leaves(list(tree.values()))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor):
                yield v


def _local_bytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor

    loc = t.to_local() if isinstance(t, DTensor) else t
    return loc.numel() * loc.element_size()


def _lay_out(x, sh):
    if sh is None:
        return x
    if isinstance(sh, Sharding):
        return distribute(x, sh)
    if isinstance(x, AdamWState):
        return AdamWState(step=x.step, mu=_lay_out(x.mu, sh.mu), nu=_lay_out(x.nu, sh.nu))
    if isinstance(sh, CacheShardings):
        return distribute_cache(x, sh.by_path)
    return distribute_params(x, sh)


@dataclasses.dataclass(frozen=True)
class CacheShardings:
    """A decode cache's ``{path: Sharding}`` (``cache_shardings``)."""

    by_path: dict


def _batch_sharding(mesh, batch_size: int) -> Sharding:
    """Shard the batch dim over (pod, data) only when divisible."""
    axes = dp_axes(mesh)
    sizes = mesh_shape(mesh)
    if axes:
        extent = math.prod(sizes[a] for a in axes)
        if batch_size % extent == 0:
            return Sharding(mesh, PSpec(axes))
        if batch_size % sizes.get("data", 1) == 0:
            return Sharding(mesh, PSpec("data"))
    return Sharding(mesh, PSpec())


def _tree_of(sharding, tree):
    return {k: sharding for k in tree}


def _mode(mode):
    return mode if mode is not None else inputs_lib.fake_mode()


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def make_train_step(
    model: Model,
    optimizer: AdamW,
    mesh,
    shape: ShapeConfig,
    policy: ShardingPolicy = ShardingPolicy(),
    seed: int = 0,
    *,
    mode=None,
) -> StepBundle:
    """The training step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``launch.train``'s step (the loss, its gradients, the
    optimizer update), with the router jitter drawn from
    ``launch.train.step_generator(seed, opt_state.step)``."""
    from ..optim.adamw import tree_leaves
    from .train import loss_and_grads, step_generator

    cfg = model.cfg
    mode = _mode(mode)

    def train_step(params, opt_state, batch):
        rng = step_generator(seed, opt_state.step, tree_leaves(params)[0].device)
        loss, metrics, grads = loss_and_grads(model, params, batch, rng)
        params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    with sharding_policy(policy):
        pshape = inputs_lib.params_shape(model, max_seq=shape.seq_len, mode=mode)
        with mode:
            oshape = optimizer.init(pshape)
        pshard = param_shardings(pshape, mesh, policy)
        # moments share the param sharding; the step counter is a host int
        oshard = AdamWState(step=None, mu=param_shardings(oshape.mu, mesh, policy),
                            nu=param_shardings(oshape.nu, mesh, policy))
        batch = inputs_lib.batch_specs(cfg, shape, with_targets=True, mode=mode)
        bshard = _tree_of(_batch_sharding(mesh, shape.global_batch), batch)

    return StepBundle(
        fn=train_step,
        in_shardings=(pshard, oshard, bshard),
        out_shardings=(pshard, oshard, None),
        specs=(pshape, oshape, batch),
        donate_argnums=(0, 1),
        mesh=mesh, policy=policy, fake_mode=mode,
    )


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def make_prefill_step(
    model: Model,
    mesh,
    shape: ShapeConfig,
    policy: ShardingPolicy = ShardingPolicy(),
    *,
    cache_len: int = 0,
    mode=None,
) -> StepBundle:
    """``(params, batch) -> (last-position logits, caches)``; ``cache_len``
    pads the caches for the decode steps that follow (``Model.prefill``)."""
    cfg = model.cfg
    mode = _mode(mode)

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len)

    with sharding_policy(policy):
        pshape = inputs_lib.params_shape(model, max_seq=shape.seq_len, mode=mode)
        pshard = param_shardings(pshape, mesh, policy)
        batch = inputs_lib.batch_specs(cfg, shape, with_targets=False, mode=mode)
        bshard = _tree_of(_batch_sharding(mesh, shape.global_batch), batch)

    return StepBundle(
        fn=prefill_step,
        in_shardings=(pshard, bshard),
        out_shardings=None,
        specs=(pshape, batch),
        mesh=mesh, policy=policy, fake_mode=mode,
    )


# ---------------------------------------------------------------------------
# Decode / serve
# ---------------------------------------------------------------------------


def _context_parallel(shape: ShapeConfig, mesh) -> bool:
    """The single-sequence long-context cell: fewer sequences than data
    replicas."""
    return shape.global_batch < math.prod(mesh.shape) // int(mesh_shape(mesh).get("model", 1))


def make_serve_step(
    model: Model,
    mesh,
    shape: ShapeConfig,
    policy: Optional[ShardingPolicy] = None,
    *,
    mode=None,
) -> StepBundle:
    """``(params, cache, token, pos) -> (logits, cache)``: one decode step
    (``Model.decode_step``; ``pos`` a host int)."""
    cfg = model.cfg
    mode = _mode(mode)
    if policy is None:
        # context-parallel KV for the single-sequence long-context cell
        policy = ShardingPolicy(context_parallel=_context_parallel(shape, mesh))

    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    with sharding_policy(policy):
        pshape = inputs_lib.params_shape(model, max_seq=shape.seq_len, mode=mode)
        pshard = param_shardings(pshape, mesh, policy)
        specs = inputs_lib.input_specs(cfg, shape, model, mode=mode)
        cshard = CacheShardings(cache_shardings(specs["cache"], mesh, policy))
        tshard = _batch_sharding(mesh, shape.global_batch)

    return StepBundle(
        fn=serve_step,
        in_shardings=(pshard, cshard, tshard, None),
        out_shardings=(None, cshard),
        specs=(pshape, specs["cache"], specs["token"], specs["pos"]),
        donate_argnums=(1,),
        mesh=mesh, policy=policy, fake_mode=mode,
    )


def policy_for(shape: ShapeConfig, mesh, opt_level: int = 0) -> ShardingPolicy:
    """§Perf hillclimb ladder.  Level 0 reproduces the recorded baseline.

    decode:  L1 = serving param layout (no FSDP; expert-ffn-dim over data)
                  + cache sequence axis sharded over the model axis
    train:   L1 = MoE light combine (no f32 combine tensor)
             L2 = + remat saving only the mixer/FFN outputs
             L3 = + sequence parallelism on residuals
    prefill: as train
    """
    cp = shape.kind == "decode" and _context_parallel(shape, mesh)
    if shape.kind == "decode":
        return ShardingPolicy(
            context_parallel=cp,
            serve_params=opt_level >= 1,
            cache_seq_tp=opt_level >= 1,
            moe_light_combine=opt_level >= 1,
        )
    return ShardingPolicy(
        moe_light_combine=opt_level >= 1,
        remat="collectives" if opt_level >= 2 else "full",
        seq_shard=opt_level >= 3,
    )


def make_step(
    model: Model,
    mesh,
    shape: ShapeConfig,
    policy: Optional[ShardingPolicy] = None,
    *,
    opt_level: int = 0,
    mode=None,
) -> StepBundle:
    if policy is None:
        policy = policy_for(shape, mesh, opt_level)
    if shape.kind == "train":
        return make_train_step(model, AdamW(), mesh, shape, policy, mode=mode)
    if shape.kind == "prefill":
        return make_prefill_step(model, mesh, shape, policy, mode=mode)
    if shape.kind == "decode":
        return make_serve_step(model, mesh, shape, policy, mode=mode)
    raise ValueError(shape.kind)
