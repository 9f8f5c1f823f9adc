"""The port's serving entry point, and its agreement with the reference.

* ``python -m repro_torch.launch.serve`` on the CPU, reduced smollm, with
  the CI flags: exits 0, crosses the KV block boundary at position 24
  during decode, and reports its agreement gate.
* The port's ``teacher_forced_logits`` on the reference's generated tokens,
  with the same (converted) packed parameters, against the reference's
  own: top-1 agreement >= 0.99 (free-running tokens need not match: one
  int8 rounding flip at a random-init near-tie rewrites the suffix).
* No module of the port, nor ``chip_smoke.py``, imports JAX or the
  reference package.
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


def test_teacher_forced_agreement_with_reference():
    ref_cfg = ref_get_config("smollm-360m").reduced()
    ref_model = RefModel(ref_cfg)
    policy = ref_q.QuantPolicy(
        rules=(("embedding", 0.5, 256), ("kernel|experts", 1.0, 256)), scale_mode="ls"
    )
    ref_params = ref_packed.quantize_params(ref_model.init(jax.random.PRNGKey(0)), policy)
    tokens = np.random.default_rng(0).integers(0, 128, size=(2, 20)).astype(np.int32)
    with ref_q.act_quant_scope(ref_q.ActQuant()), ref_q.kv_quant_scope(ref_q.KVQuant(8, 16)):
        seq = ref_serve.generate(ref_model, ref_params, jnp.asarray(tokens), gen=6, cache_len=26)
        want = ref_serve.teacher_forced_logits(ref_model, ref_params, seq, prompt_len=20)
    port_model = Model(get_config("smollm-360m").reduced())
    port_params = from_reference_params(_to_numpy_tree(ref_params))
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(port_q.KVQuant(8, 16)):
        got = port_serve.teacher_forced_logits(
            port_model, port_params, torch.from_numpy(np.asarray(seq, np.int64)), prompt_len=20
        )
    assert got.shape == want.shape == (2, 6, 128)
    ag = port_serve.top1_agreement(torch.from_numpy(np.array(want)), got)
    assert ag["top1_agreement"] >= 0.99, ag
    ref_ag = ref_serve.top1_agreement(want, jnp.asarray(got.numpy()))
    assert ref_ag["top1_agreement"] == ag["top1_agreement"]


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
