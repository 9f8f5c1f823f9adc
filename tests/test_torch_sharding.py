"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``).

* Every case of the reference's ``tests/test_sharding_rules.py``, in the
  port's terms (``PSpec`` entries as the reference's ``P`` has them).
* Parity of the parameter rules: every leaf of the 10 reduced
  configurations' trees, and of the packed trees of smollm-360m and
  deepseek-v2-lite-16b (``<param>/pulses`` and ``<param>/scales``), gets
  the reference's spec on the reference's own tree, on duck meshes
  ``{data 16, model 16}``, ``{pod 2, data 16, model 16}``, ``{data 32,
  model 8}``, ``{pod 2, data 16, model 8}`` and the port's 512-GPU
  ``{pod 2, data 32, model 8}``, under the default policy,
  ``serve_params``, ``fsdp_pod``, ``cache_seq_tp`` and
  ``context_parallel``.  JAX's ``P`` writes a one-axis tuple as the axis
  name; both sides are compared in that form.
* Parity of the cache rules, the same way: the port's per-layer cache leaf
  against the reference's stacked leaf (the repeats axis dropped), dense
  caches of every decode-capable configuration and smollm-360m's
  PVQ-packed cache.
* ``to_placements`` and the production meshes on a 512-rank fake process
  group, in a subprocess (the group is process-global).
* ``cell_applicable`` equal to the reference's for all 10 x 4 cells.
"""

import os
import re
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_applicable as ref_cell_applicable
from repro.configs import get_config as ref_get_config
from repro.nn.models import build_model as ref_build_model
from repro.parallel import sharding as ref_sh
from repro_torch.configs import SHAPES, cell_applicable, get_config, shape_by_name
from repro_torch.launch.inputs import fake_mode
from repro_torch.nn.models import build_model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import PSpec as P
from repro_torch.parallel.sharding import ShardingPolicy, cache_pspec, param_pspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    """Duck-typed mesh for rule tests (no devices needed)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH_POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
POL = ShardingPolicy()


# ---------------------------------------------------------------------------
# The reference's rule tests
# ---------------------------------------------------------------------------


def test_embedding_rule():
    assert param_pspec("embed/embedding", (49152, 4096), MESH, POL) == P("model", ("data",))


def test_column_and_row_parallel():
    assert param_pspec("segments/seg0/b0/mixer/wq/kernel", (4096, 4096), MESH, POL) == P(("data",), "model")
    assert param_pspec("segments/seg0/b0/mixer/wo/kernel", (4096, 4096), MESH, POL) == P("model", ("data",))


def test_stacked_scan_params_get_leading_none():
    spec = param_pspec("segments/seg0/b0/mixer/wq/kernel", (36, 4096, 4096), MESH, POL)
    assert spec == P(None, ("data",), "model")


def test_expert_rules():
    assert param_pspec("ffn/wi_up_experts", (160, 5120, 1536), MESH, POL) == P("model", ("data",), None)
    assert param_pspec("ffn/wo_experts", (160, 1536, 5120), MESH, POL) == P("model", None, ("data",))


def test_serve_layout_experts():
    pol = ShardingPolicy(serve_params=True)
    assert param_pspec("ffn/wi_up_experts", (160, 5120, 1536), MESH, pol) == P("model", None, "data")
    # non-expert kernels: no FSDP at serve
    assert param_pspec("mixer/wq/kernel", (4096, 4096), MESH, pol) == P(None, "model")


def test_norm_scales_replicated():
    assert param_pspec("ln_mix/rms_scale", (4096,), MESH, POL) == P()
    assert param_pspec("final_norm/ln_bias", (768,), MESH, POL) == P()


def test_indivisible_dims_fall_back_to_replicated():
    # 15 heads * 64 = 960 not divisible by 16 -> no model sharding
    spec = param_pspec("mixer/wq/kernel", (960, 900), MESH, POL)
    assert spec == P(("data",), None)


def test_every_model_param_matches_a_rule():
    """No matrix leaf may fall through to the generic default (guards the
    rule table against renames)."""
    model = build_model(get_config("jamba-1.5-large-398b").reduced())
    with fake_mode():
        params = model.init(0, device="cpu", max_seq=64)
    for pstr, leaf in sh.param_leaves(params):
        if leaf.ndim >= 2 and "experts" not in pstr:
            assert any(re.search(pat, pstr) for pat, _ in sh._PARAM_RULES), pstr


def _port_cache_leaves(cache):
    """``(seg, repeats, layer path, shape)`` of every leaf of the port's
    per-layer cache."""
    for seg, layers in cache.items():
        for path, leaf in sh.cache_leaves(layers[0], ""):
            yield seg, len(layers), path.lstrip("/"), tuple(leaf.shape)


def test_cache_rules_match_dict_paths():
    """Decode-cache rules match the paths the port's caches produce."""
    pol = ShardingPolicy(cache_seq_tp=True)
    matched = {"kv": 0, "mla": 0, "mamba": 0, "rwkv": 0}
    for arch, key in (("granite-8b", "kv"), ("deepseek-v2-lite-16b", "mla"),
                      ("jamba-1.5-large-398b", "mamba"), ("rwkv6-1.6b", "rwkv")):
        model = build_model(get_config(arch).reduced())
        with fake_mode():
            cache = model.init_cache(4, 64, device="cpu")
        for seg, repeats, path, shape in _port_cache_leaves(cache):
            full = f"{seg}/{path}"
            spec = cache_pspec(full, (repeats,) + shape, MESH, pol)
            if f"/{key}/" in f"/{path}" or path.endswith(("rwkv_state", "rwkv_shift_att",
                                                          "rwkv_shift_ffn")):
                assert spec != P() or len(shape) + 1 < 3, f"no cache rule matched {full}"
                matched[key] += 1
    assert all(v > 0 for v in matched.values()), matched


def test_cache_seq_axis_sharded_only_with_policy():
    on = ShardingPolicy(cache_seq_tp=True)
    off = ShardingPolicy()
    shape = (2, 128, 32768, 8, 128)
    assert cache_pspec("seg0/b0/kv/k", shape, MESH, on)[2] in ("model", ("model",))
    assert cache_pspec("seg0/b0/kv/k", shape, MESH, off)[2] is None


def test_context_parallel_adds_data_axis():
    pol = ShardingPolicy(context_parallel=True, cache_seq_tp=True)
    spec = cache_pspec("seg0/b0/kv/k", (2, 1, 524288, 8, 128), MESH, pol)
    assert spec[2] == ("data", "model")


def test_layer_cache_spec_drops_the_repeats_axis():
    pol = ShardingPolicy(cache_seq_tp=True)
    spec = sh.layer_cache_pspec("seg0", 2, "b0/kv/k", (128, 32768, 8, 128), MESH, pol)
    assert spec == P(("data",), ("model",), None, None)


# ---------------------------------------------------------------------------
# Parity with the reference's rules
# ---------------------------------------------------------------------------

MESHES = {
    "d16m16": {"data": 16, "model": 16},
    "p2d16m16": {"pod": 2, "data": 16, "model": 16},
    "d32m8": {"data": 32, "model": 8},
    "p2d16m8": {"pod": 2, "data": 16, "model": 8},
    "p2d32m8": {"pod": 2, "data": 32, "model": 8},
}
POLICIES = {
    "default": {},
    "serve_params": {"serve_params": True},
    "fsdp_pod": {"fsdp_pod": True},
    "cache_seq_tp": {"cache_seq_tp": True},
    "context_parallel": {"context_parallel": True},
}
ALL_ARCHS = sorted(REF_ARCHS)
PACKED = ("smollm-360m", "deepseek-v2-lite-16b")


def _norm(spec):
    """A spec's entries as JAX's ``P`` holds them (a one-axis tuple is the
    axis name, an empty one None)."""
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def _ref_paths(tree):
    out = {}

    def visit(path, leaf):
        out[ref_sh._path_str(path)] = tuple(leaf.shape)
        return leaf

    jax.tree_util.tree_map_with_path(visit, tree)
    return out


_TREES = {}


def _trees(arch, packed):
    """(reference {path: shape}, port {path: shape}) of the reduced init."""
    key = (arch, packed)
    if key not in _TREES:
        rmodel = ref_build_model(ref_get_config(arch).reduced())
        if packed:
            from repro.core.packed import quantize_params as ref_quantize
            from repro.core.quantize import QuantPolicy as RefQuantPolicy
            from repro_torch.core.quantize import QuantPolicy

            ref = jax.eval_shape(lambda: ref_quantize(rmodel.init(jax.random.PRNGKey(0)),
                                                      RefQuantPolicy()))
            port = build_model(get_config(arch).reduced()).init(0, device="cpu",
                                                                pack=QuantPolicy())
        else:
            ref = jax.eval_shape(lambda: rmodel.init(jax.random.PRNGKey(0)))
            with fake_mode():
                port = build_model(get_config(arch).reduced()).init(0, device="cpu")
        _TREES[key] = (_ref_paths(ref), {p: tuple(t.shape) for p, t in sh.param_leaves(port)})
    return _TREES[key]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("tree", [(a, False) for a in ALL_ARCHS] + [(a, True) for a in PACKED],
                         ids=lambda t: f"{t[0]}{'-packed' if t[1] else ''}")
def test_param_rules_match_reference(tree, mesh_name):
    ref, port = _trees(*tree)
    assert port == ref  # the same leaves, paths and shapes
    mesh = FakeMesh(MESHES[mesh_name])
    for pol_kw in POLICIES.values():
        rpol, ppol = ref_sh.ShardingPolicy(**pol_kw), ShardingPolicy(**pol_kw)
        for path, shape in ref.items():
            want = _norm(ref_sh.param_pspec(path, shape, mesh, rpol))
            got = _norm(param_pspec(path, shape, mesh, ppol))
            assert got == want, (path, shape, pol_kw, got, want)


_CACHES = {}


def _caches(arch, packed):
    """(reference {path: shape} of the stacked cache, port per-layer leaves)."""
    key = (arch, packed)
    if key not in _CACHES:
        b, length = 32, 256
        rmodel = ref_build_model(ref_get_config(arch).reduced())
        model = build_model(get_config(arch).reduced())
        if packed:
            from repro.core import quantize as rq
            from repro_torch.core import quantize as pq

            old_r = rq.set_default_kv_quant(rq.KVQuant(block=8, group=16))
            old_p = pq.set_default_kv_quant(pq.KVQuant(block=8, group=16))
        try:
            ref = jax.eval_shape(lambda: rmodel.init_cache(b, length))
            with fake_mode():
                port = model.init_cache(b, length, device="cpu")
        finally:
            if packed:
                rq.set_default_kv_quant(old_r)
                pq.set_default_kv_quant(old_p)
        _CACHES[key] = (_ref_paths(ref), list(_port_cache_leaves(port)))
    return _CACHES[key]


DECODE_ARCHS = [a for a in ALL_ARCHS if ref_get_config(a).supports_decode]


@pytest.mark.parametrize("cache", [(a, False) for a in DECODE_ARCHS] + [("smollm-360m", True)],
                         ids=lambda t: f"{t[0]}{'-packed' if t[1] else ''}")
def test_cache_rules_match_reference(cache):
    ref, port = _caches(*cache)
    ref_leaves = {p: s for p, s in ref.items()}
    # the port's leaves are the reference's, one layer of each stack
    assert sorted(f"{seg}/{path}" for seg, _, path, _ in port) == sorted(ref_leaves)
    for mesh_shape in MESHES.values():
        mesh = FakeMesh(mesh_shape)
        for pol_kw in POLICIES.values():
            rpol, ppol = ref_sh.ShardingPolicy(**pol_kw), ShardingPolicy(**pol_kw)
            for seg, repeats, path, shape in port:
                full = f"{seg}/{path}"
                assert ref_leaves[full] == (repeats,) + shape, full
                want = _norm(ref_sh.cache_pspec(full, ref_leaves[full], mesh, rpol))
                got = _norm(sh.layer_cache_pspec(seg, repeats, path, shape, mesh, ppol))
                if want:
                    assert want[0] is None, (full, want)
                    want = want[1:]
                assert got == want, (full, pol_kw, mesh_shape, got, want)


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.ones(4, 8)
    assert sh.constrain(x, "dp", "tp") is x
    assert sh.active_mesh() is None


def test_constrain_spec_drops_used_and_indivisible_axes():
    pol = ShardingPolicy(context_parallel=True, cache_seq_tp=True)
    # batch 'dp' takes data, so the 'seq' axis keeps only model
    assert sh.constrain_spec((32, 64, 4), ("dp", "seq", None), MESH, pol) == P(("data",), ("model",), None)
    # 15 does not divide by 16: that dim stays whole
    assert sh.constrain_spec((32, 15), ("dp", "tp"), MESH, POL) == P(("data",), None)


def test_to_placements_refuses_axes_out_of_mesh_order():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 8})
    with pytest.raises(ValueError, match="mesh order"):
        sh.to_placements(P(("data", "pod")), mesh)


# ---------------------------------------------------------------------------
# DeviceMesh placements on the fake process group
# ---------------------------------------------------------------------------


def test_to_placements_on_fake_production_mesh():
    prog = textwrap.dedent(
        """
        import torch
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch.inputs import fake_mode
        from repro_torch.launch.mesh import fake_world, make_production_mesh, mesh_chip_count
        from repro_torch.parallel.sharding import (PSpec as P, Sharding, distribute,
                                                   param_pspec, to_placements)

        fake_world(512)
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model"), mesh.mesh_dim_names
        assert tuple(mesh.shape) == (2, 32, 8) and mesh_chip_count(mesh) == 512
        pl = to_placements(P(("pod", "data"), "model"), mesh)
        assert pl == [Shard(0), Shard(0), Shard(1)], pl
        assert to_placements(P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
        spec = param_pspec("segments/seg0/b0/mixer/wq/kernel", (2, 2048, 2048), mesh,
                           __import__("repro_torch.parallel", fromlist=["x"]).ShardingPolicy())
        assert spec == P(None, ("data",), "model"), spec
        with fake_mode():
            t = distribute(torch.empty(2, 2048, 2048), Sharding(mesh, spec))
            assert tuple(t.to_local().shape) == (2, 64, 256), t.to_local().shape
            x = distribute(torch.empty(128, 16), Sharding(mesh, P(("pod", "data"))))
            assert tuple(x.to_local().shape) == (2, 16)
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK" in res.stdout


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


def test_shapes_match_reference():
    assert [(s.name, s.kind, s.seq_len, s.global_batch) for s in SHAPES] == \
        [(s.name, s.kind, s.seq_len, s.global_batch) for s in REF_SHAPES]
    assert shape_by_name("decode_32k").global_batch == 128
    with pytest.raises(KeyError):
        shape_by_name("nope")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_applicable_matches_reference(arch):
    for s, rs in zip(SHAPES, REF_SHAPES):
        assert cell_applicable(get_config(arch), s) == ref_cell_applicable(ref_get_config(arch), rs)
