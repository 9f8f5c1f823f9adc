"""``repro_torch.parallel.pipeline`` against the reference's
``repro.parallel.pipeline``.

* ``bubble_fraction`` equals the reference's.
* The reference's slow test's program, on the port: 4 gloo ranks (one
  process each, ``tests/_torch_mesh_worker.py``), 4 stages of
  ``tanh(x @ w)``, 8 microbatches of (2, 16): every rank returns the last
  stage's outputs, within 1e-5 of the sequential composition in numpy and
  of the reference's sequential composition on the same numpy inputs.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.parallel.pipeline import bubble_fraction as ref_bubble_fraction
from repro_torch.parallel.pipeline import bubble_fraction

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_stages,n_micro", [(1, 8), (2, 8), (4, 4), (4, 8), (8, 32)])
def test_bubble_fraction(n_stages, n_micro):
    assert bubble_fraction(n_stages, n_micro) == ref_bubble_fraction(n_stages, n_micro)


def test_bubble_fraction_values():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(2, 8) == pytest.approx(1 / 9)
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)


def test_pipeline_matches_sequential_over_four_ranks(tmp_path):
    n_stages, n_micro, mb, d = 4, 8, 2, 16
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(n_stages, d, d)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(n_micro, mb, d)).astype(np.float32)
    np.savez(tmp_path / "in.npz", ws=ws, xs=xs)
    args = {"world": n_stages, "store": str(tmp_path / "store"), "inputs": str(tmp_path / "in.npz"),
            "out": str(tmp_path / "out.npz")}
    (tmp_path / "args.json").write_text(json.dumps(args))
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_torch_mesh_worker.py"), "pipeline",
         str(tmp_path / "args.json")],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(tmp_path / "out.npz")["out"]

    ref = xs.astype(np.float64)
    for s in range(n_stages):
        ref = np.tanh(ref @ ws[s])
    assert out.shape == (n_micro, mb, d)
    assert float(np.max(np.abs(out - ref))) < 1e-5

    ref_jax = jnp.asarray(xs)
    for s in range(n_stages):
        ref_jax = jnp.tanh(ref_jax @ jnp.asarray(ws[s]))
    assert float(np.max(np.abs(out - np.asarray(ref_jax)))) < 1e-5
