"""Parity of the PyTorch port's configs and PVQ core with the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  Integer
results (pulses, int8 activations) must be identical; f32 results agree to
``atol=1e-6`` (the port sums groups in a fixed pairwise order, the
reference in XLA's order, so the last bits of a sum may differ).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import pvq as ref_pvq
from repro.core import quantize as ref_q
from repro_torch.configs import get_config
from repro_torch.core import packed as port_packed
from repro_torch.core import pvq as port_pvq
from repro_torch.core import quantize as port_q


def _laplace_groups(seed, g, n, zero_rows=()):
    w = np.random.default_rng(seed).laplace(size=(g, n)).astype(np.float32)
    for r in zero_rows:
        w[r] = 0.0
    return w


@pytest.mark.parametrize("reduced", [False, True])
def test_config_asdict_matches_reference(reduced):
    ref = ref_get_config("smollm-360m")
    port = get_config("smollm-360m")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.resolved_head_dim == ref.resolved_head_dim


@pytest.mark.parametrize(
    "group,d_in", [(256, 960), (256, 64), (256, 96), (256, 2560), (32, 16), (32, 64)]
)
def test_group_plans_match_reference(group, d_in):
    assert port_packed._fit_group(group, d_in) == ref_packed._fit_group(group, d_in)
    assert port_packed.matmul_plan(group, d_in) == ref_packed.matmul_plan(group, d_in)
    assert port_q.k_for(d_in, 0.5) == ref_q.k_for(d_in, 0.5)


@pytest.mark.parametrize(
    "n,k,delta_max",
    [
        (16, 12, 32),    # K <= delta_max: pure greedy
        (64, 128, 32),   # K > delta_max: bisection bulk + greedy tail
        (64, 32, 8),     # small delta: bulk allocation does most of the work
        (256, 256, 32),  # full-width matmul group, K > 127
        (32, 127, 32),   # KV cache group at full width
    ],
)
def test_quantize_direction_fast_identical(n, k, delta_max):
    w = _laplace_groups(n + k, 24, n, zero_rows=(3,))
    want = np.asarray(ref_pvq.pvq_quantize_direction_fast(jnp.asarray(w), k, delta_max=delta_max))
    got = port_pvq.pvq_quantize_direction_fast(torch.from_numpy(w), k, delta_max=delta_max)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(got.numpy()).sum(-1)[np.arange(24) != 3] == k).all()


@pytest.mark.parametrize("n,k", [(8, 5), (32, 40), (64, 64)])
def test_quantize_direction_exact_greedy_identical(n, k):
    w = _laplace_groups(7 * n + k, 12, n)
    want = np.asarray(ref_pvq.pvq_quantize_direction(jnp.asarray(w), k))
    got = port_pvq.pvq_quantize_direction(torch.from_numpy(w), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["paper", "ls"])
def test_scales_match_reference(mode):
    w = _laplace_groups(11, 40, 64, zero_rows=(0, 5))
    pulses = np.array(ref_pvq.pvq_quantize_direction_fast(jnp.asarray(w), 64))
    want = np.asarray(ref_pvq._scales(jnp.asarray(w), jnp.asarray(pulses), mode))
    got = port_pvq._scales(torch.from_numpy(w), torch.from_numpy(pulses), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[[0, 5]] == 0).all()


def _activation_input(seed, m=6, k=64):
    x = np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32) * 3.0
    x[2] = 0.0  # zero row -> zero scale, zero codes
    # row 4: max |x| = 127 so the scale is 1 and x.5 values hit the
    # half-to-even rule (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -3.5 -> -4)
    x[4] = 0.25
    x[4, :5] = [127.0, 0.5, 1.5, 2.5, -3.5]
    return x


@pytest.mark.parametrize(
    "mode,tile", [("per_row", None), ("per_tensor", None), ("per_tile", 16), ("per_tile", 32)]
)
def test_quantize_activations_match_reference(mode, tile):
    x = _activation_input(len(mode) * 10 + (tile or 0))
    kw = {} if tile is None else {"tile": tile}
    q_ref, s_ref = ref_q.quantize_activations(jnp.asarray(x), ref_q.ActQuant(mode=mode), **kw)
    q, s = port_q.quantize_activations(torch.from_numpy(x), port_q.ActQuant(mode=mode), **kw)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-6)
    assert (q.numpy()[2] == 0).all()
    if mode == "per_row":
        np.testing.assert_array_equal(q.numpy()[4, :5], [127, 0, 2, 2, -4])


def test_act_quant_granularity_spelling():
    assert port_q.ActQuant(granularity="tile").mode == "per_tile"
    with pytest.raises(ValueError):
        port_q.ActQuant(mode="per_block")
    with pytest.raises(ValueError):
        port_q.KVQuant(k=200)
