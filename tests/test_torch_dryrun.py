"""The port's dry-run (``repro_torch.launch.dryrun``, ``roofline``,
``report``, ``inputs``) against the reference's (``repro.launch``).

* The collective record: the five collectives of the reference's
  ``HLO_SAMPLE`` (``tests/test_roofline_data.py:21-33``), issued with those
  shapes on a fake process group under ``roofline.OpCounter``, give the
  reference's ``per_kind_bytes`` and ``per_kind_counts`` (the sample's
  reduce-scatter shows only its result, so it is issued over a group of
  one; its collective-permute is recorded as ``pipeline_forward`` records
  its sends, which a 2-stage pipeline on the fake group shows too).
* ``analyze_corrected`` with the H100 constants, the ``model`` axis at
  NVLink's rate and the rest at the network's.
* ``pvq_bytes_per_weight``, ``model_flops_for`` and
  ``analytic_decode_memory`` equal to the reference's formulas (the
  reference's HBM rate swapped for the H100's), ``_depth_variants`` equal
  to the reference's for every config, and ``params_total`` /
  ``params_active`` equal to the reference's ``eval_shape`` counts.
* A dry-run of reduced smollm-360m on an 8-rank fake mesh in a
  subprocess: a record with the reference's keys, the FLOPs of one rank's
  shards (below the same step's on one rank, and at least an eighth of
  it), and the depth extrapolation equal to the full trace's counts on
  this dense cell.
* The reference's two cells at full width, through ``python -m
  repro_torch.launch.dryrun``: ``smollm-360m train_4k single`` (256 GPUs,
  ``0 < useful_ratio < 1.5``, a bottleneck among the three) and
  ``gemma-2b decode_32k multi --opt-level 1`` (512 GPUs,
  ``pvq_weight_speedup > 1``).
* ``report.roofline_table`` and ``before_after_table`` render the
  reference's text from the same records.

The reference's ``launch/dryrun.py`` forces 512 host devices when it is
imported, so its ``_depth_variants`` is taken from its source instead.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro.nn.models import build_model as ref_build_model
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.inputs import params_shape
from repro_torch.nn.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_ARCHS = sorted(REF_ARCHS)


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable] + args, capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)


# ---------------------------------------------------------------------------
# The collective record
# ---------------------------------------------------------------------------

HLO_SAMPLE = """
HloModule test
ENTRY %main {
  %p0 = bf16[1024,512]{1,0} parameter(0)
  %ag = bf16[16384,512]{1,0} all-gather(%p0), dimensions={0}
  %ar = f32[1024,512]{1,0} all-reduce(%conv), to_apply=%sum
  %rs = f32[64,512]{1,0} reduce-scatter(%big), dimensions={0}
  %cp = bf16[1024,512]{1,0} collective-permute(%p0), source_target_pairs={{0,1}}
  %a2a = bf16[1024,512]{1,0} all-to-all(%p0), dimensions={0}
  %dot = f32[1024,1024]{1,0} dot(%p0, %p0)
}
"""


def test_collective_record_matches_reference_hlo_sample():
    prog = textwrap.dedent(
        """
        import json, torch
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.launch.inputs import fake_mode
        from repro_torch.launch.mesh import fake_world
        from repro_torch.launch.roofline import OpCounter, collective_bytes
        from repro_torch.parallel.pipeline import pipeline_forward

        fake_world(16)
        mesh = init_device_mesh("cpu", (16, 1), mesh_dim_names=("data", "model"))
        fm = fake_mode()
        with fm:
            c = OpCounter(mesh, fm)
            with c:
                ag = funcol.all_gather_tensor(torch.empty(1024, 512, dtype=torch.bfloat16), 0,
                                              (mesh, 0))
                ar = funcol.all_reduce(torch.empty(1024, 512), "sum", (mesh, 0))
                rs = funcol.reduce_scatter_tensor(torch.empty(64, 512), "sum", 0, (mesh, 1))
                a2a = funcol.all_to_all_single(torch.empty(1024, 512, dtype=torch.bfloat16),
                                               None, None, (mesh, 0))
                torch.mm(torch.empty(1024, 512), torch.empty(512, 1024))
                c.record("collective-permute", 1024 * 512 * 2, "data")
            assert tuple(ag.shape) == (16384, 512), ag.shape
        out = collective_bytes(c.collectives)
        out["axes"] = [r["axis"] for r in c.collectives]
        out["flops"] = c.flops
        print("RESULT", json.dumps(out))
        """
    )
    res = _run(["-c", prog])
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.split("RESULT", 1)[1])
    want = ref_roofline.collective_bytes(HLO_SAMPLE)
    assert got["per_kind_counts"] == want["per_kind_counts"]
    assert got["per_kind_bytes"] == want["per_kind_bytes"]
    assert got["total_bytes"] == want["total_bytes"]
    assert got["axes"] == ["data", "data", "model", "data", "data"]
    assert got["flops"] == 2 * 1024 * 512 * 1024  # the dot is work, not a collective


def test_pipeline_sends_are_collective_permutes():
    prog = textwrap.dedent(
        """
        import json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.launch.mesh import fake_world
        from repro_torch.launch.roofline import OpCounter, collective_bytes
        from repro_torch.parallel.pipeline import pipeline_forward

        fake_world(2)
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
        c = OpCounter(mesh)
        with c:
            pipeline_forward(lambda w, x: x @ w, torch.eye(16), torch.ones(3, 2, 16), mesh=mesh)
        print("RESULT", json.dumps(collective_bytes(c.collectives)))
        """
    )
    res = _run(["-c", prog])
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.split("RESULT", 1)[1])
    # n_micro + n_stages - 1 ticks, one (2, 16) f32 send each
    assert got["per_kind_counts"]["collective-permute"] == 4
    assert got["per_kind_bytes"]["collective-permute"] == 4 * 2 * 16 * 4
    assert got["per_axis_bytes"] == {"pod": 4 * 2 * 16 * 4}


# ---------------------------------------------------------------------------
# Roofline formulas
# ---------------------------------------------------------------------------


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    assert roofline.NET_BW == 50e9


def test_analyze_corrected_bottleneck():
    coll = {"total_bytes": 1e12, "per_kind_bytes": {}, "per_kind_counts": {},
            "per_axis_bytes": {"model": 4e11, "data": 6e11}}
    roof = roofline.analyze_corrected(flops=1e15, hbm_bytes=1e11, coll=coll, chips=256,
                                      model_flops=2e17)
    assert roof.compute_s == pytest.approx(1e15 / 989e12)
    assert roof.memory_s == pytest.approx(1e11 / 3.35e12)
    assert roof.collective_s == pytest.approx(4e11 / 450e9 + 6e11 / 50e9)
    assert roof.bottleneck == "collective"
    assert roof.useful_ratio == pytest.approx(2e17 / (1e15 * 256))
    # the reference's formula with its constants swapped for the H100's
    want = ref_roofline.analyze_corrected(flops=1e15, hbm_bytes=1e11, coll=coll, chips=256,
                                          model_flops=2e17)
    assert roof.compute_s == pytest.approx(want.compute_s * ref_roofline.PEAK_FLOPS / 989e12)
    assert roof.memory_s == pytest.approx(want.memory_s * ref_roofline.HBM_BW / 3.35e12)
    assert roof.useful_ratio == want.useful_ratio
    # no axis recorded: all of it at the network's rate
    bare = {"total_bytes": 1e12, "per_kind_bytes": {}, "per_kind_counts": {}}
    assert roofline.analyze_corrected(flops=0, hbm_bytes=0, coll=bare, chips=1,
                                      model_flops=0).collective_s == pytest.approx(1e12 / 50e9)


@pytest.mark.parametrize("group,nibble", [(256, False), (256, True), (128, False), (64, True)])
def test_pvq_bytes_per_weight(group, nibble):
    assert roofline.pvq_bytes_per_weight(group, nibble) == \
        ref_roofline.pvq_bytes_per_weight(group, nibble)


class _RefMesh:
    def __init__(self, shape):
        self.shape = shape
        self.devices = np.zeros(tuple(shape.values()))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_and_analytic_decode_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    n = 123_456_789
    for s, rs in zip(SHAPES, REF_SHAPES):
        assert roofline.model_flops_for(cfg, s, n) == ref_roofline.model_flops_for(rcfg, rs, n)
        if s.kind != "decode":
            continue
        for mesh in ({"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8}):
            got = roofline.analytic_decode_memory(cfg, s, mesh, n)
            want = ref_roofline.analytic_decode_memory(rcfg, rs, _RefMesh(mesh), n)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                if k.startswith("memory_s"):  # the same bytes over another HBM rate
                    v = v * ref_roofline.HBM_BW / roofline.HBM_BW
                assert got[k] == pytest.approx(v, rel=1e-12), (k, got[k], v)


def _ref_depth_variants():
    """The reference's ``_depth_variants``, from its source (importing its
    module would force 512 host devices on this process)."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_depth_variants")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["_depth_variants"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_depth_variants_match_reference(arch):
    small, big, extra = dryrun._depth_variants(get_config(arch))
    rsmall, rbig, rextra = _ref_depth_variants()(ref_get_config(arch))
    assert extra == rextra
    for got, want in ((small, rsmall), (big, rbig)):
        for f in ("n_layers", "encoder_layers", "unroll_layers", "first_dense", "hybrid_period"):
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    total, active = dryrun.param_counts(cfg, params_shape(build_model(cfg), max_seq=4096))
    rshape = jax.eval_shape(lambda: ref_build_model(rcfg).init(jax.random.PRNGKey(0),
                                                               max_seq=4096))
    rtotal, ractive = 0, 0

    def visit(path, leaf):
        nonlocal rtotal, ractive
        pstr = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        n = int(np.prod(leaf.shape))
        rtotal += n
        if rcfg.moe is not None and "experts" in pstr and "shared" not in pstr:
            n = int(n * rcfg.moe.top_k / rcfg.moe.n_experts)
        ractive += n
        return leaf

    jax.tree_util.tree_map_with_path(visit, rshape)
    assert (total, active) == (rtotal, ractive)


# ---------------------------------------------------------------------------
# Dry-runs
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "status", "chips", "memory_analysis",
            "cost_flops_per_chip_raw", "cost_bytes_per_chip_raw", "params_total",
            "params_active", "roofline"}
ROOF_KEYS = {"flops", "hbm_bytes", "coll_bytes", "compute_s", "memory_s", "collective_s",
             "bottleneck", "model_flops", "chips", "useful_ratio", "collectives"}


_REDUCED_PROG = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
cfg = get_config("smollm-360m").reduced()
dims = tuple(json.loads(sys.argv[1]))
out = {}
out["full"] = dryrun.run_cell("smollm-360m", "train_4k", False, cfg=cfg,
                              mesh_dims=(dims, ("data", "model")))
if dims != (1, 1):
    out["ext"] = dryrun.run_cell("smollm-360m", "train_4k", False, cfg=cfg,
                                 mesh_dims=(dims, ("data", "model")), extrapolate_depth=True)
    out["decode"] = dryrun.run_cell("smollm-360m", "decode_32k", False, cfg=cfg,
                                    mesh_dims=(dims, ("data", "model")), opt_level=1)
open(sys.argv[2], "w").write(json.dumps(out))
"""


def _reduced(tmp_path, dims):
    path = tmp_path / f"rec{dims[0]}x{dims[1]}.json"
    res = _run(["-c", _REDUCED_PROG, json.dumps(dims), str(path)])
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(path.read_text())


def test_reduced_cell_on_eight_rank_fake_mesh(tmp_path):
    out = _reduced(tmp_path, (4, 2))
    full, ext, dec = out["full"], out["ext"], out["decode"]
    for rec in (full, ext, dec):
        assert rec["status"] == "ok", rec.get("error")
        assert REF_KEYS <= set(rec) and ROOF_KEYS <= set(rec["roofline"])
        assert rec["chips"] == 8 and rec["trace_s"] >= 0
    assert "analytic_decode" in dec and "analytic_decode" not in full
    mem = full["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    # the affine depth extrapolation is exact on a dense stack
    fr, er = full["roofline"], ext["roofline"]
    assert er["flops"] == pytest.approx(fr["flops"], rel=1e-9)
    assert er["hbm_bytes"] == pytest.approx(fr["hbm_bytes"], rel=1e-9)
    assert er["collectives"]["per_kind_counts"] == fr["collectives"]["per_kind_counts"]
    assert er["coll_bytes"] == pytest.approx(fr["coll_bytes"], rel=1e-9)
    # FLOPs on the local shards: one of 8 ranks does less than the whole
    # step on one rank, the 8 together at least all of it
    whole = _reduced(tmp_path, (1, 1))["full"]
    assert whole["chips"] == 1 and whole["roofline"]["coll_bytes"] == 0
    assert fr["flops"] < whole["roofline"]["flops"] <= 8 * fr["flops"]


def _dryrun_cli(tmp_path, *args):
    res = _run(["-m", "repro_torch.launch.dryrun", "--out", str(tmp_path)] + list(args),
               timeout=900)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    return res


def test_dryrun_cell_single_pod(tmp_path):
    _dryrun_cli(tmp_path, "--arch", "smollm-360m", "--shape", "train_4k", "--mesh", "single")
    rec = json.loads((tmp_path / "smollm-360m__train_4k__single.json").read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < roof["useful_ratio"] < 1.5
    assert set(roof["collectives"]["per_axis_bytes"]) <= {"data", "model"}


def test_dryrun_decode_multi_pod(tmp_path):
    _dryrun_cli(tmp_path, "--arch", "gemma-2b", "--shape", "decode_32k", "--mesh", "multi",
                "--opt-level", "1")
    rec = json.loads((tmp_path / "gemma-2b__decode_32k__multi.json").read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 512
    assert "analytic_decode" in rec
    assert rec["analytic_decode"]["pvq_weight_speedup"] > 1.0


def test_dryrun_skips_inapplicable_cell(tmp_path):
    _dryrun_cli(tmp_path, "--arch", "smollm-360m", "--shape", "long_500k", "--mesh", "single")
    rec = json.loads((tmp_path / "smollm-360m__long_500k__single.json").read_text())
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


def _records():
    def ok(arch, shape, compute, memory, coll, useful, decode=False):
        terms = {"compute": compute, "memory": memory, "collective": coll}
        rec = {"arch": arch, "shape": shape, "mesh": "single", "status": "ok",
               "roofline": {"compute_s": compute, "memory_s": memory, "collective_s": coll,
                            "bottleneck": max(terms, key=terms.get), "useful_ratio": useful}}
        if decode:
            rec["analytic_decode"] = {"memory_s_analytic": memory / 3}
        return rec

    recs = [
        ok("smollm-360m", "train_4k", 0.05, 3.9, 0.13, 0.11),
        ok("gemma-2b", "decode_32k", 5e-6, 2e-3, 2.3e-3, 0.5, decode=True),
        ok("granite-8b", "prefill_32k", 1.2, 0.8, 2.5, 120.0),
        {"arch": "smollm-360m", "shape": "long_500k", "mesh": "single", "status": "skipped",
         "reason": "full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §4)"},
        {"arch": "rwkv6-1.6b", "shape": "train_4k", "mesh": "single", "status": "failed"},
        dict(ok("gemma-2b", "train_4k", 1.0, 2.0, 0.0, 0.7), mesh="multi"),
    ]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_report_tables_match_reference(mesh, tmp_path):
    cells = _records()
    assert report.roofline_table(cells, mesh) == ref_report.roofline_table(cells, mesh)
    opt = {k: json.loads(json.dumps(v)) for k, v in cells.items()}
    for r in opt.values():
        if r["status"] == "ok":
            r["roofline"]["memory_s"] *= 0.5
    assert report.before_after_table(cells, opt, mesh) == \
        ref_report.before_after_table(cells, opt, mesh)
    for key, rec in cells.items():
        (tmp_path / f"{'__'.join(key)}.json").write_text(json.dumps(rec))
    assert report.load(str(tmp_path)) == ref_report.load(str(tmp_path))
