"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips without a CUDA card.  Tolerances: the encoder, kernel v3
(without the tanh-gelu epilogue) and kernel v4 are identical to their plain
versions (same float operation order, no FMA contraction, the plain
versions' fixed summation trees); kernel v2 and the gelu epilogue within
``rtol=1e-5, atol=1e-5 * max|y|`` (f32 sums in another order, ``tanhf``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import quantize as port_q
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import pvq_encode as port_enc
from repro_torch.kernels import pvq_matmul as port_mm

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")


def _close(got, want, rtol=1e-5):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@needs_cuda
@pytest.mark.parametrize("m,k,n,group", [(4, 1024, 960, 256), (7, 96, 40, 32), (3, 64, 24, 16), (2, 12, 5, 6)])
def test_cuda_matmuls_match_plain(m, k, n, group):
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(m + k)
    pulses = torch.randint(-9, 10, (k, n), generator=gen, dtype=torch.int8).to(dev)
    scales = torch.rand(k // group, n, generator=gen).to(dev)
    x = torch.randn(m, k, generator=gen).to(dev)
    bias = torch.randn(n, generator=gen).to(dev)
    for act in port_mm.ACTIVATIONS:
        got = port_mm.pvq_matmul_cuda(x, pulses, scales, bias, group=group, activation=act)
        want = port_mm.pvq_matmul_plain(x, pulses, scales, bias, group=group, activation=act)
        _close(got, want)
    xb = x.to(torch.bfloat16)
    _close(port_mm.pvq_matmul_cuda(xb, pulses, scales, group=group),
           port_mm.pvq_matmul_plain(xb, pulses, scales, group=group), rtol=1e-2)
    for mode in ("per_row", "per_tile", "per_tensor"):
        xq, a = ops._quantize_x(x, port_q.ActQuant(mode), group)
        for act in ("none", "relu", "gelu"):
            got = port_mm.pvq_matmul_q_cuda(xq, pulses, scales, a, bias, group=group, activation=act)
            want = port_mm.pvq_matmul_q_plain(xq, pulses, scales, a, bias, group=group, activation=act)
            if act == "gelu":
                _close(got, want)
            else:
                assert torch.equal(got, want), (mode, act)


@needs_cuda
@pytest.mark.parametrize("g,n,k", [(64, 256, 256), (50, 64, 128), (40, 32, 127), (30, 16, 12)])
def test_cuda_encode_matches_plain_bit_for_bit(g, n, k):
    dev = torch.device("cuda")
    w = torch.randn(g, n, generator=torch.Generator().manual_seed(g + n)).to(dev)
    w[3] = 0.0
    p, rho = port_enc.pvq_encode_batch_cuda(w, k_pulses=k)
    p_ref, rho_ref = port_enc.pvq_encode_batch_plain(w, k_pulses=k)
    assert torch.equal(p, p_ref)
    assert torch.equal(rho, rho_ref)


@needs_cuda
@pytest.mark.parametrize("n_kv", [1, 3])
@pytest.mark.parametrize("hd,group", [(64, 32), (16, 16)])
def test_cuda_attention_matches_plain(hd, group, n_kv):
    """Bit for bit, on a packed cache's (b, S, n_kv, X) planes."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(hd)
    bh, m, s, ng = 6, 3, 160, hd // group
    q_i8, a = port_q.quantize_activations(torch.randn(bh, m, hd, generator=gen))
    lead = (bh // n_kv, s, n_kv)
    kp = torch.randint(-12, 13, (*lead, hd), generator=gen, dtype=torch.int8)
    vp = torch.randint(-12, 13, (*lead, hd), generator=gen, dtype=torch.int8)
    ks = torch.rand(*lead, ng, generator=gen) * 0.2
    vs = torch.rand(*lead, ng, generator=gen) * 0.2
    kv_len = torch.tensor([0, 1, 64, 128, 129, 160], dtype=torch.int32)
    args = [t.to(dev) for t in (q_i8, a, kp, ks, vp, vs, kv_len)]
    got = port_mm.pvq_attn_q_cuda(*args, group=group, sm_scale=0.125)
    want = port_mm.pvq_attn_q_plain(*args, group=group, sm_scale=0.125)
    for name, g_, w_ in zip(("acc", "m", "l"), got, want):
        assert torch.equal(g_, w_), name


@needs_cuda
def test_ops_route_cuda_tensors_to_kernels():
    dev = torch.device("cuda")
    before = dict(LAUNCHES)
    x = torch.randn(2, 64, device=dev)
    pulses = torch.randint(-3, 4, (64, 8), dtype=torch.int8, device=dev)
    ops.pvq_matmul(x, pulses, torch.ones(1, 8, device=dev), group=64)
    ops.pvq_matmul(x, pulses, torch.ones(1, 8, device=dev), group=64, act_quant=port_q.ActQuant())
    ops.pvq_encode(torch.randn(3, 16, device=dev), k_pulses=8)
    assert LAUNCHES["pvq_matmul"] == before["pvq_matmul"] + 1
    assert LAUNCHES["pvq_matmul_q"] == before["pvq_matmul_q"] + 1
    assert LAUNCHES["pvq_encode_batch"] == before["pvq_encode_batch"] + 1
