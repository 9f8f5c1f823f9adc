"""The port's step functions (``repro_torch.launch.steps``) on a DeviceMesh
against the reference's (``repro.launch.steps``) on its one-device
``make_debug_mesh(1, 1)``.

Both start from the reference's parameters (``jax.random`` init of reduced
smollm-360m and reduced deepseek-v2-lite-16b, router jitter 0) and see the
same numpy batch (4 x 8 tokens).  The port runs on a 1-rank and a 4-rank
``(data 2, model 2)`` gloo mesh (``tests/_torch_mesh_worker.py``, one
process per rank; parameters, optimizer moments, batch and caches are
DTensors laid out by the port's rules), under ``policy_for(shape, mesh,
opt_level)`` at levels 0 and 1 (level 1: the MoE light combine; at decode
also the serving layout and the sequence-sharded cache).

* train, two steps of ``make_step`` (``AdamW()``): every step's loss
  ``rtol=1e-5``, its other metrics ``rtol=1e-4`` and grad norm
  ``rtol=1e-3``; the params after two steps within the train tests'
  Adam bound (``tests/test_torch_train.py``: every element within ``2 lr``
  a step, the leaf within 1e-4 of its norm, at most 0.1% of its elements
  beyond ``rtol=1e-4, atol=1e-2 * lr``);
* prefill: the last position's logits ``rtol=1e-4, atol=1e-5``;
* decode: the prompt fed a token at a time from a zero cache, then 4
  greedy tokens: the tokens identical, every step's logits ``rtol=1e-4,
  atol=1e-5``.

The reference runs on its debug mesh's shape with ``Auto`` axes (this
JAX's ``make_mesh`` defaults to ``Explicit`` ones, which the reference's
``with_sharding_constraint`` refuses).

The remat policies (``ShardingPolicy.remat``: ``full``, ``dots``,
``collectives``) give the loss and gradients of no remat exactly (max
difference 0), deepseek with its router jitter on.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.nn.models import build_model as ref_build_model
from repro.optim import AdamW as RefAdamW
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_step, policy_for
from repro_torch.launch.train import loss_and_grads, step_generator
from repro_torch.nn.models import build_model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import ShardingPolicy, sharding_policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-360m", "deepseek-v2-lite-16b")
OPT_LEVELS = (0, 1)
B, S, GEN = 4, 8, 4
LR = 3e-4  # AdamW()'s default rate, the one make_step uses
WORLDS = {1: (1, 1), 4: (2, 2)}


def _ref_cfg(arch):
    cfg = ref_get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(router_jitter=0.0))
    return cfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _ref_debug_mesh():
    """The reference's ``make_debug_mesh(1, 1)`` with its axes of type
    ``Auto``: this JAX's ``make_mesh`` makes ``Explicit`` axes, on which the
    reference's ``with_sharding_constraint`` raises."""
    from jax.sharding import AxisType

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    assert mesh.shape == ref_mesh.make_debug_mesh(1, 1).shape
    return mesh


def _reference(arch, params, tokens, targets):
    """The reference's make_step results on its 1-device debug mesh."""
    model = ref_build_model(_ref_cfg(arch))
    mesh = _ref_debug_mesh()
    out = {}
    for opt in OPT_LEVELS:
        tag = f"{arch}/{opt}"
        shape = RefShapeConfig("t", "train", S, B)
        bundle = ref_steps.make_step(model, mesh, shape, opt_level=opt)
        with mesh:
            fn = bundle.jit()
            p, o = params, RefAdamW().init(params)
            batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
            for step in range(2):
                p, o, metrics = fn(p, o, batch)
                for k, v in metrics.items():
                    out[f"{tag}/train/{step}/{k}"] = _np(v)
            for k, v in _flat(jax.device_get(p)).items():
                out[f"{tag}/train/params/{k}"] = np.asarray(v, np.float32)
            bundle = ref_steps.make_step(model, mesh, RefShapeConfig("p", "prefill", S, B),
                                         opt_level=opt)
            logits, _ = bundle.jit()(params, {"tokens": jnp.asarray(tokens)})
            out[f"{tag}/prefill/logits"] = _np(logits)
            bundle = ref_steps.make_step(model, mesh,
                                         RefShapeConfig("d", "decode", S + GEN, B),
                                         opt_level=opt)
            fn = bundle.jit()
            cache = model.init_cache(B, S + GEN)
            tok = jnp.asarray(tokens[:, :1])
            outs, logs = [], []
            for i in range(S + GEN):
                logits, cache = fn(params, cache, tok, jnp.int32(i))
                lg = _np(logits)[:, -1]
                logs.append(lg)
                nxt = lg.argmax(-1).astype(np.int32)[:, None]
                tok = jnp.asarray(tokens[:, i + 1 : i + 2] if i + 1 < S else nxt)
                outs.append(np.asarray(tok))
            out[f"{tag}/decode/logits"] = np.stack(logs, 1)
            out[f"{tag}/decode/tokens"] = np.concatenate(outs[S - 1 :], 1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ref": ..., 1: ..., 4: ...}``: the reference's results and the
    port's on each world size."""
    work = tmp_path_factory.mktemp("steps")
    inputs, ref = {}, {}
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        model = ref_build_model(_ref_cfg(arch))
        params = jax.device_get(model.init(jax.random.PRNGKey(0)))
        vocab = _ref_cfg(arch).vocab_size
        tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
        targets = rng.integers(0, vocab, (B, S)).astype(np.int32)
        for k, v in _flat(params).items():
            inputs[f"{arch}/params/{k}"] = v
        inputs[f"{arch}/tokens"], inputs[f"{arch}/targets"] = tokens, targets
        ref.update(_reference(arch, params, tokens, targets))
    np.savez(work / "inputs.npz", **inputs)
    out = {"ref": ref}
    for world, (nd, nm) in WORLDS.items():
        args = {"world": world, "n_data": nd, "n_model": nm, "store": str(work / f"store{world}"),
                "inputs": str(work / "inputs.npz"), "out": str(work / f"out{world}.npz"),
                "archs": list(ARCHS), "opt_levels": list(OPT_LEVELS), "gen": GEN}
        (work / f"args{world}.json").write_text(json.dumps(args))
        res = subprocess.run(
            [sys.executable, os.path.join(REPO, "tests", "_torch_mesh_worker.py"), "steps",
             str(work / f"args{world}.json")],
            env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")), cwd=REPO,
            capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-4000:]
        out[world] = dict(np.load(args["out"]))
    return out


CASES = [(w, a, o) for w in WORLDS for a in ARCHS for o in OPT_LEVELS]


def _ids(case):
    w, a, o = case
    return f"{w}rank-{a}-opt{o}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_train_steps_match_reference(runs, case):
    world, arch, opt = case
    got, want = runs[world], runs["ref"]
    tag = f"{arch}/{opt}/train"
    for step in range(2):
        np.testing.assert_allclose(got[f"{tag}/{step}/loss"], want[f"{tag}/{step}/loss"],
                                   rtol=1e-5, err_msg=f"{tag} step {step} loss")
        for k in ("ce", "aux", "accuracy"):
            np.testing.assert_allclose(got[f"{tag}/{step}/{k}"], want[f"{tag}/{step}/{k}"],
                                       rtol=1e-4, atol=1e-7, err_msg=f"{tag} step {step} {k}")
        np.testing.assert_allclose(got[f"{tag}/{step}/grad_norm"],
                                   want[f"{tag}/{step}/grad_norm"], rtol=1e-3)
    keys = sorted(k for k in want if k.startswith(f"{tag}/params/"))
    assert keys == sorted(k for k in got if k.startswith(f"{tag}/params/"))
    for key in keys:
        g, w = got[key].astype(np.float64), want[key].astype(np.float64)
        diff = np.abs(g - w)
        assert diff.max() <= 2 * LR * 2, (key, diff.max())
        assert np.linalg.norm(diff) <= 1e-4 * np.linalg.norm(w), key
        off = diff > 1e-4 * np.abs(w) + 1e-2 * LR
        assert off.mean() <= 1e-3, (key, int(off.sum()), off.size)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_step_matches_reference(runs, case):
    world, arch, opt = case
    key = f"{arch}/{opt}/prefill/logits"
    np.testing.assert_allclose(runs[world][key], runs["ref"][key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_serve_step_matches_reference(runs, case):
    world, arch, opt = case
    tag = f"{arch}/{opt}/decode"
    np.testing.assert_array_equal(runs[world][f"{tag}/tokens"], runs["ref"][f"{tag}/tokens"])
    np.testing.assert_allclose(runs[world][f"{tag}/logits"], runs["ref"][f"{tag}/logits"],
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The ladder and the remat policies (one process, no mesh)
# ---------------------------------------------------------------------------


class _Mesh:
    def __init__(self, shape):
        self.shape = tuple(shape.values())
        self.mesh_dim_names = tuple(shape)


@pytest.mark.parametrize("opt_level", [0, 1, 2, 3])
def test_policy_ladder_matches_reference(opt_level):
    from repro.configs import SHAPES as REF_SHAPES
    from repro_torch.configs import SHAPES

    class _RefMesh:
        def __init__(self, shape):
            self.shape = shape
            self.devices = np.zeros(tuple(shape.values()))

    for mesh_shape in ({"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8}):
        for s, rs in zip(SHAPES, REF_SHAPES):
            got = policy_for(s, _Mesh(mesh_shape), opt_level)
            want = ref_steps.policy_for(rs, _RefMesh(mesh_shape), opt_level)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (s.name, mesh_shape)


@pytest.mark.parametrize("policy", ["full", "dots", "collectives"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_gradients_of_no_remat(arch, policy):
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(router_jitter=0.2))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))) for k in
             ("tokens", "targets")}
    res = {}
    for pol in ("none", policy):
        with sharding_policy(ShardingPolicy(remat=pol)):
            loss, metrics, grads = loss_and_grads(model, params, batch, step_generator(0, 1, "cpu"))
        res[pol] = (loss, metrics, tree_leaves(grads))
    assert float(res[policy][0]) == float(res["none"][0])
    if cfg.moe is not None:  # the jitter moved the routing: the aux loss differs from 0-jitter
        assert float(res[policy][1]["aux"]) == float(res["none"][1]["aux"])
    for a, b in zip(res[policy][2], res["none"][2]):
        assert float((a - b).abs().max()) == 0.0


def test_train_mode_rematerialises_by_default():
    """``Model.forward`` in train mode checkpoints each layer (the default
    policy ``full``): its backward recomputes the layer."""
    from torch.utils import checkpoint as ckpt

    calls = []
    orig = ckpt.checkpoint

    def spy(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return orig(fn, *a, **kw)

    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.zeros((1, 4), dtype=torch.int64) for k in ("tokens", "targets")}
    ckpt.checkpoint = spy
    try:
        loss_and_grads(model, params, batch, None)
    finally:
        ckpt.checkpoint = orig
    assert calls == [False] * cfg.n_layers


def test_step_bundle_on_shapes_allocates_nothing():
    """``make_step`` builds its specs as fake tensors (full-width deepseek-v2-236b)."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.configs import shape_by_name

    model = build_model(get_config("deepseek-v2-236b"))
    bundle = make_step(model, _Mesh({"data": 1, "model": 1}), shape_by_name("decode_32k"))
    params, cache, token, pos = bundle.specs
    leaves = tree_leaves(params)
    assert all(isinstance(t, FakeTensor) for t in leaves)
    assert sum(t.numel() for t in leaves) > 2e11
    assert pos == 0 and tuple(token.shape) == (128, 1)


def test_chip_smoke_parallel_phase_on_cpu(tmp_path):
    """``chip_smoke.py``'s parallel phase, its code on the CPU over a 1-rank
    gloo group at a reduced size (the card runs it at full width): the
    mesh's train step identical to ``launch.train``'s, every remat policy
    one step, the big batch's two finite steps, the mesh's prefill and
    serve identical to the unmeshed model."""
    prog = (
        "import sys, json, pathlib, torch\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "from _chip_smoke_module import chip_smoke\n"
        "from repro_torch.configs import get_config\n"
        "out = chip_smoke().parallel_phase(torch, 'cpu', pathlib.Path(sys.argv[1]),\n"
        "    cfg=get_config('smollm-360m').reduced(), device='cpu', train_shape=(2, 16),\n"
        "    big_shape=(4, 32), serve_shape=(2, 8, 4), dryruns=False)\n"
        "print('RESULT', json.dumps(out))\n"
    )
    res = subprocess.run([sys.executable, "-c", prog, str(tmp_path)], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                         cwd=REPO, timeout=600)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    out = json.loads(res.stdout.split("RESULT", 1)[1])
    assert out["train_identity"]["identical"]
    assert sorted(out["remat_peak_gb"]) == ["collectives", "dots", "full", "none"]
    losses = {v["loss"] for v in out["remat_peak_gb"].values()}
    assert len(losses) == 1
    assert out["serve_identity"]["logits_identical"] and out["serve_identity"]["tokens_identical"]
