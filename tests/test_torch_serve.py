"""The port's serving entry point, and its agreement with the reference.

* ``python -m repro_torch.launch.serve`` on the CPU, reduced smollm, with
  the CI flags: exits 0, crosses the KV block boundary at position 24
  during decode, and reports its agreement gate.
* The port's ``teacher_forced_logits`` on the reference's generated tokens,
  with the same (converted) packed parameters, against the reference's
  own: top-1 agreement >= 0.99 (free-running tokens need not match: one
  int8 rounding flip at a random-init near-tie rewrites the suffix), at
  the CI flags' shape and at CI's long-context smoke's (prompt 512).
* CI's long-context ``--kv-pvq`` smoke and its prompt-8 ``--pvq --act-int8``
  smoke through the port's CLI on the CPU; the latter's teacher-forced
  logits against the reference's on the same parameters and tokens.
* No module of the port, nor ``chip_smoke.py``, imports JAX or the
  reference package.
* ``tools/profile_decode``: ``--f32`` traces the f32 leg's decode too, and
  its report splits kernel v2's device time by route and by body and
  counts kernel v4's.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.launch import serve as ref_serve
from repro.nn.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import quantize as port_q
from repro_torch.launch import serve as port_serve
from repro_torch.nn.models import Model

ROOT = Path(__file__).resolve().parents[1]
CI_FLAGS = [
    "--reduced", "--batch", "2", "--prompt-len", "20", "--gen", "6", "--pvq", "--act-int8",
    "--kv-pvq", "--kv-block", "8", "--kv-group", "16", "--agreement-min", "0.99",
]


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))


def test_serve_cli_runs_the_quantized_path_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", *CI_FLAGS],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["generated_shape"] == [2, 26]
    assert report["kv_quant"] == "pvq:block8:g16:k127"
    assert report["kv_bytes_ratio_vs_f32"] == 0.312
    assert report["act_int8_top1_agreement"] >= 0.99
    # a CPU run takes the plain versions only: no kernel launches
    assert set(report["kernel_launches"].values()) == {0}


# CI's long-context PVQ-KV serve smoke (ci.yml:88-98) as CI runs it
CI_LONG_FLAGS = [
    "--arch", "smollm-360m", "--reduced", "--batch", "1", "--prompt-len", "512", "--gen", "8",
    "--pvq", "--act-int8", "--kv-pvq", "--agreement-min", "0.99",
]


def test_serve_cli_runs_cis_long_context_kv_pvq_smoke_on_cpu():
    """16 full KV blocks plus the tail: the packed leg (kernel v4's plain
    version on the CPU) crosses four 128-column attention blocks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", *CI_LONG_FLAGS],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["generated_shape"] == [1, 520]
    assert report["kv_bytes_ratio_vs_f32"] <= 0.35
    assert report["act_int8_top1_agreement"] >= 0.99
    assert set(report["kernel_launches"].values()) == {0}


# CI's int8-activation serve smoke (ci.yml:79-87) as CI runs it: no KV
# quantization, the dense cache
CI_PROMPT8_FLAGS = [
    "--arch", "smollm-360m", "--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "8",
    "--pvq", "--act-int8", "--agreement-min", "0.99",
]


def test_serve_cli_runs_cis_prompt_8_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", *CI_PROMPT8_FLAGS],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["generated_shape"] == [2, 16]
    assert "kv_quant" not in report
    assert report["act_int8_top1_agreement"] >= 0.99
    assert set(report["kernel_launches"].values()) == {0}


def test_serve_refuses_to_fall_back_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.run([*CI_FLAGS])


def _to_numpy_tree(tree):
    if isinstance(tree, ref_packed.PackedPVQ):
        return {
            "pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
            "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
            "layout": tree.layout, "scale_mode": tree.scale_mode,
        }
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _agreement_with_reference(batch, prompt, gen, kv_block, kv_group):
    """The reference's generated tokens and teacher-forced logits (reduced
    smollm, packed, int8 activations, PVQ KV cache unless ``kv_block`` is
    None), and the port's teacher-forced logits on the same tokens and
    converted parameters."""
    ref_cfg = ref_get_config("smollm-360m").reduced()
    ref_model = RefModel(ref_cfg)
    policy = ref_q.QuantPolicy(
        rules=(("embedding", 0.5, 256), ("kernel|experts", 1.0, 256)), scale_mode="ls"
    )
    ref_params = ref_packed.quantize_params(ref_model.init(jax.random.PRNGKey(0)), policy)
    tokens = np.random.default_rng(0).integers(0, 128, size=(batch, prompt)).astype(np.int32)
    with ref_q.act_quant_scope(ref_q.ActQuant()), \
            ref_q.kv_quant_scope(kv_block and ref_q.KVQuant(kv_block, kv_group)):
        seq = ref_serve.generate(ref_model, ref_params, jnp.asarray(tokens), gen=gen,
                                 cache_len=prompt + gen)
        want = ref_serve.teacher_forced_logits(ref_model, ref_params, seq, prompt_len=prompt)
    port_model = Model(get_config("smollm-360m").reduced())
    port_params = from_reference_params(_to_numpy_tree(ref_params))
    with port_q.act_quant_scope(port_q.ActQuant()), \
            port_q.kv_quant_scope(kv_block and port_q.KVQuant(kv_block, kv_group)):
        got = port_serve.teacher_forced_logits(
            port_model, port_params, torch.from_numpy(np.asarray(seq, np.int64)), prompt_len=prompt
        )
    assert got.shape == want.shape == (batch, gen, 128)
    ag = port_serve.top1_agreement(torch.from_numpy(np.array(want)), got)
    assert ag["top1_agreement"] >= 0.99, ag
    ref_ag = ref_serve.top1_agreement(want, jnp.asarray(got.numpy()))
    assert ref_ag["top1_agreement"] == ag["top1_agreement"]


def test_teacher_forced_agreement_with_reference():
    _agreement_with_reference(batch=2, prompt=20, gen=6, kv_block=8, kv_group=16)


def test_teacher_forced_agreement_with_reference_at_cis_long_context():
    """CI's prompt-512 smoke's shape and KV contract (serve's defaults:
    block 32, group 32 fitted to the head dim): 16 packed blocks, so the
    packed leg runs four 128-column attention blocks in both packages."""
    _agreement_with_reference(batch=1, prompt=512, gen=8, kv_block=32, kv_group=32)


def test_teacher_forced_agreement_with_reference_at_cis_prompt_8():
    """CI's prompt-8 smoke's shape and contract: int8 activations, the dense
    KV cache."""
    _agreement_with_reference(batch=2, prompt=8, gen=8, kv_block=None, kv_group=None)


def test_bucket_len_matches_reference():
    from repro.launch.engine import bucket_len

    for n, m in [(26, 8), (1, 32), (160, 32), (161, 32), (0, 8)]:
        assert port_serve.bucket_len(n, m) == bucket_len(n, m)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.MULTILINE)


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_profile_decode_takes_the_f32_leg_at_decode(monkeypatch):
    """``--f32`` without ``--prefill`` (the f32 leg's decode steps) passes
    the parser; with no card the tool refuses to measure."""
    from repro_torch.tools import profile_decode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_decode.main(["--f32", "--steps", "2"])


def test_profile_report_splits_v2_by_route_and_body(monkeypatch):
    """Kernel v2's device time, from a trace's kernel names: all of v2, by
    route (the Route tag) and by body; v3 apart."""
    from types import SimpleNamespace

    from repro_torch.tools import profile_decode

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "test")
    cuda = torch.autograd.DeviceType.CUDA
    traced = [
        ("void pvq::pvq_matmul_f_splitk_kernel<pvq::OneMatrix, 4, float>(float const*)", 10.0),
        ("void pvq::pvq_matmul_f_splitk_kernel<pvq::ExpertStack, 1, float>(float const*)", 30.0),
        ("void pvq::pvq_matmul_f_mma_kernel<pvq::OneMatrix, 32, float>(float const*)", 50.0),
        ("void pvq::pvq_matmul_f_kernel<pvq::ExpertStack, true, float>(float const*)", 70.0),
        ("void pvq::pvq_matmul_q_splitk_kernel<pvq::OneMatrix, 4, float>(signed char const*)", 5.0),
        ("void at::native::elementwise_kernel<128, 2>()", 1.0),
    ]
    events = [SimpleNamespace(device_type=cuda, name=name, device_time_total=us)
              for name, us in traced]
    report = profile_decode._report(
        SimpleNamespace(events=lambda: events), 1.0, 2,
        SimpleNamespace(batch=4, prompt_len=128, top=3, f32=True), SimpleNamespace(name="m"),
        "step")
    assert report["v2_ms_per_step"] == pytest.approx(0.080)
    assert report["v2_calls_per_step"] == 2.0
    assert report["v2_by_route"] == {
        "2d": {"ms_per_step": pytest.approx(0.030), "calls_per_step": 1.0},
        "batched": {"ms_per_step": pytest.approx(0.050), "calls_per_step": 1.0}}
    assert report["v2_by_body"] == {
        "splitk": {"ms_per_step": pytest.approx(0.020), "calls_per_step": 1.0},
        "mma": {"ms_per_step": pytest.approx(0.025), "calls_per_step": 0.5},
        "direct": {"ms_per_step": pytest.approx(0.035), "calls_per_step": 0.5}}
    assert report["v3_ms_per_step"] == pytest.approx(0.0025)
    assert report["kernel_launches_per_step"] == 3.0
    assert report["leg"] == "f32"
    assert report["v4_ms_per_step"] == 0.0 and report["v4_calls_per_step"] == 0.0


def test_profile_report_counts_v4(monkeypatch):
    """Kernel v4's device time and calls, from the kernel names that hold
    ``pvq_attn``; the matmul kernels apart."""
    from types import SimpleNamespace

    from repro_torch.tools import profile_decode

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "test")
    cuda = torch.autograd.DeviceType.CUDA
    traced = [("void pvq::pvq_attn_q_kernel<16>(signed char const*)", 12.0),
              ("void pvq::pvq_attn_q_kernel<16>(signed char const*)", 14.0),
              ("void pvq::pvq_matmul_q_splitk_kernel<pvq::OneMatrix, 4, float>(char)", 4.0)]
    events = [SimpleNamespace(device_type=cuda, name=name, device_time_total=us)
              for name, us in traced]
    report = profile_decode._report(
        SimpleNamespace(events=lambda: events), 1.0, 2,
        SimpleNamespace(batch=4, prompt_len=128, top=3, f32=False), SimpleNamespace(name="m"),
        "step")
    assert report["v4_ms_per_step"] == pytest.approx(0.013)
    assert report["v4_calls_per_step"] == 1.0
    assert report["v4_share_of_device_time"] == pytest.approx(26.0 / 30.0)
    assert report["v3_calls_per_step"] == 0.5


def test_profile_report_counts_the_encoder(monkeypatch):
    """The encoder's device time, calls and share of the device time, from
    the kernel names that hold ``pvq_encode``; the other kernels apart."""
    from types import SimpleNamespace

    from repro_torch.tools import profile_decode

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "test")
    cuda = torch.autograd.DeviceType.CUDA
    traced = [("void pvq_encode_warp<1>(float const*, int, int, int, int, int*, float*)", 5.0),
              ("void pvq_encode_warp<1>(float const*, int, int, int, int, int*, float*)", 5.0),
              ("void at::native::elementwise_kernel<128, 2>()", 10.0),
              ("void at::native::elementwise_kernel<128, 2>()", 20.0)]
    events = [SimpleNamespace(device_type=cuda, name=name, device_time_total=us)
              for name, us in traced]
    report = profile_decode._report(
        SimpleNamespace(events=lambda: events), 1.0, 2,
        SimpleNamespace(batch=4, prompt_len=157, top=3, f32=False), SimpleNamespace(name="m"),
        "step")
    assert report["device_ms_per_step"] == pytest.approx(0.020)
    assert report["encode_ms_per_step"] == pytest.approx(0.005)
    assert report["encode_calls_per_step"] == 1.0
    assert report["encode_share_of_device_time"] == pytest.approx(0.25)
    assert report["v4_calls_per_step"] == 0.0 and report["v3_calls_per_step"] == 0.0


def test_profile_report_counts_the_page_gather(monkeypatch):
    """The engine's page gather (``index_select``: one of two kernels by
    shape) by device time, calls and share; other index kernels apart."""
    from types import SimpleNamespace

    from repro_torch.tools import profile_decode

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "test")
    cuda = torch.autograd.DeviceType.CUDA
    traced = [("void at::native::(anonymous namespace)::indexSelectSmallIndex<signed char>()", 3.0),
              ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*)", 5.0),
              ("void at::native::index_elementwise_kernel<128, 4>()", 7.0),
              ("void at::native::elementwise_kernel<128, 2>()", 25.0)]
    events = [SimpleNamespace(device_type=cuda, name=name, device_time_total=us)
              for name, us in traced]
    report = profile_decode._report(
        SimpleNamespace(events=lambda: events), 1.0, 2,
        SimpleNamespace(batch=4, prompt_len=128, top=3, f32=False), SimpleNamespace(name="m"),
        "engine_step")
    assert report["gather_ms_per_engine_step"] == pytest.approx(0.004)
    assert report["gather_calls_per_engine_step"] == 1.0
    assert report["gather_share_of_device_time"] == pytest.approx(0.2)
