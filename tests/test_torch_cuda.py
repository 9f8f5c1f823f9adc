"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips without a CUDA card.  The continuous-batching engine on
the reduced model gives the same tokens on the kernels as on their plain
versions, with kernel v4 at its chunked-prefill caller among them.  Tolerances: the encoder, kernel v3
(each of its three bodies: splitk, direct, mma) and its expert-batched form
(without the tanh-gelu epilogue) and kernel v4
are identical to their plain versions (same float operation order, no FMA
contraction, the plain versions' fixed summation trees); kernel v2 (each
of its three bodies: splitk, direct, mma), its batched form and the gelu epilogue
within ``rtol=1e-5, atol=1e-5 * max|y|`` (v2's group sums run in f64 in
another order, so a sum lying on an f32 rounding boundary may round the
other way; ``tanhf``); v2's bf16 output after a gelu or silu epilogue,
and v3's after a gelu epilogue, within ``rtol=1e-2`` (``tanhf``/``expf``
differ from PyTorch's in the last f32 bits, which moves a bf16 rounding by
one bf16 ulp, 2^-8 relative).
"""

import contextlib
import json
from functools import partial

import numpy as np
import pytest
import torch
from _chip_smoke_module import chip_smoke
from _encode_rows import encode_rows

from repro_torch.core import quantize as port_q
from repro_torch.kernels import LAUNCHES, V2_BODY_LAUNCHES, V3_BODY_LAUNCHES, ops
from repro_torch.kernels import pvq_encode as port_enc
from repro_torch.kernels import pvq_matmul as port_mm

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")


def _close(got, want, rtol=1e-5):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _body_launches_since(before):
    return {body: V3_BODY_LAUNCHES[body] - before[body] for body in V3_BODY_LAUNCHES}


def _v2_launches_since(before):
    return {body: V2_BODY_LAUNCHES[body] - before[body] for body in V2_BODY_LAUNCHES}


@needs_cuda
# m <= 8 splits the contraction over CTAs (splitk) when n % 16 == 0 and the
# group is a multiple of 4; the ragged rest, and m > 8 with n % 16 != 0 or a
# group not divisible by 32, read the pulses directly (the dp4a body).  v2
# takes the body of the same name on each of these shapes (its mma body, m
# > 8, needs n % 16 == 0 too)
@pytest.mark.parametrize("m,k,n,group,body", [(4, 1024, 960, 256, "splitk"), (7, 96, 40, 32, "direct"),
                                              (3, 64, 24, 16, "direct"), (2, 12, 5, 6, "direct"),
                                              (20, 96, 40, 32, "direct"), (11, 12, 5, 6, "direct")])
def test_cuda_matmuls_match_plain(m, k, n, group, body):
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(m + k)
    pulses = torch.randint(-9, 10, (k, n), generator=gen, dtype=torch.int8).to(dev)
    scales = torch.rand(k // group, n, generator=gen).to(dev)
    x = torch.randn(m, k, generator=gen).to(dev)
    bias = torch.randn(n, generator=gen).to(dev)
    before_v2 = dict(V2_BODY_LAUNCHES)
    for act in port_mm.ACTIVATIONS:
        got = port_mm.pvq_matmul_cuda(x, pulses, scales, bias, group=group, activation=act)
        want = port_mm.pvq_matmul_plain(x, pulses, scales, bias, group=group, activation=act)
        _close(got, want)
    xb = x.to(torch.bfloat16)
    _close(port_mm.pvq_matmul_cuda(xb, pulses, scales, group=group),
           port_mm.pvq_matmul_plain(xb, pulses, scales, group=group), rtol=1e-2)
    assert _v2_launches_since(before_v2) == {b: 6 if b == body else 0 for b in V2_BODY_LAUNCHES}
    before = dict(V3_BODY_LAUNCHES)
    for mode in ("per_row", "per_tile", "per_tensor"):
        xq, a = ops._quantize_x(x, port_q.ActQuant(mode), group)
        for act in ("none", "relu", "gelu"):
            got = port_mm.pvq_matmul_q_cuda(xq, pulses, scales, a, bias, group=group, activation=act)
            want = port_mm.pvq_matmul_q_plain(xq, pulses, scales, a, bias, group=group, activation=act)
            if act == "gelu":
                _close(got, want)
            else:
                assert torch.equal(got, want), (mode, act)
    assert _body_launches_since(before) == {b: 9 if b == body else 0 for b in V3_BODY_LAUNCHES}


def _v3_cases(m, k, n, group, gen, dev):
    """Pulses over the whole int8 range, rho, bias and x for a v3 check."""
    pulses = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8).to(dev)
    scales = torch.rand(k // group, n, generator=gen).to(dev)
    bias = torch.randn(n, generator=gen).to(dev)
    x = torch.randn(m, k, generator=gen).to(dev)
    return pulses, scales, bias, x


@needs_cuda
@pytest.mark.parametrize("group", [32, 64, 256])
@pytest.mark.parametrize("n", [16, 48, 320, 2560])
@pytest.mark.parametrize("k", [256, 1024])
@pytest.mark.parametrize("m", [9, 16, 60, 64, 65, 512, 513])
def test_cuda_mma_body_matches_plain(m, k, n, group):
    """The tensor-core body (every m > 8 shape here) is identical to the
    plain version: per-row, scalar and per-tile scales, bias, each
    activation, f32 and bf16 output; tanh-gelu within rtol 1e-5."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(m * 7 + k + n + group)
    pulses, scales, bias, x = _v3_cases(m, k, n, group, gen, dev)
    xq, a_row = ops._quantize_x(x, port_q.ActQuant("per_row"), group)
    xt, a_tile = ops._quantize_x(x, port_q.ActQuant("per_tile"), group)
    a_scalar = a_row.amax().reshape(1, 1)
    cases = [(xq, a_row), (xq, a_scalar)] + ([(xt, a_tile)] if k > group else [])
    before = dict(V3_BODY_LAUNCHES)
    calls = 0
    for xin, a in cases:
        for act in port_mm.ACTIVATIONS:
            got = port_mm.pvq_matmul_q_cuda(xin, pulses, scales, a, bias, group=group, activation=act)
            want = port_mm.pvq_matmul_q_plain(xin, pulses, scales, a, bias, group=group, activation=act)
            calls += 1
            if act == "gelu":
                _close(got, want)
            else:
                assert torch.equal(got, want), (tuple(a.shape), act)
        for b in (None, bias):
            got = port_mm.pvq_matmul_q_cuda(xin, pulses, scales, a, b, group=group,
                                            out_dtype=torch.bfloat16)
            assert torch.equal(got, port_mm.pvq_matmul_q_plain(
                xin, pulses, scales, a, b, group=group, out_dtype=torch.bfloat16)), tuple(a.shape)
            calls += 1
    assert _body_launches_since(before) == {"splitk": 0, "direct": 0, "mma": calls}


# (g, n, K, delta_max); rows of every kind of ``encode_rows`` (exact ties,
# zero rows, rows whose bulk is 0) wherever g >= 6
_ENCODE_CASES = [
    # the served shapes: the KV cache's groups, the embedding's, a layer's
    (40, 32, 127, 32), (50, 64, 128, 32), (64, 256, 256, 32), (30, 16, 12, 32),
    # n not a power of two, and the widest n
    (30, 12, 12, 32), (13, 48, 96, 32), (21, 200, 256, 32), (7, 1000, 1024, 32),
    (9, 1024, 1024, 32),
    # K 1, and a large bulk
    (25, 64, 1, 32), (33, 16, 1024, 32), (18, 16, 4096, 32),
    # delta_max 0 (bulk only), 1, and >= K (greedy only)
    (26, 64, 128, 0), (26, 64, 128, 1), (26, 256, 256, 300), (26, 32, 127, 127),
    # one row, and row counts that are not a multiple of a CTA's rows
    (1, 256, 256, 32), (1, 32, 127, 32), (6, 64, 128, 32), (4097, 64, 128, 32),
]


@needs_cuda
@pytest.mark.parametrize("g,n,k,delta_max", _ENCODE_CASES)
def test_cuda_encode_matches_plain_bit_for_bit(g, n, k, delta_max):
    w = torch.from_numpy(encode_rows(g * n + k + delta_max, g, n)).cuda()
    p, rho = port_enc.pvq_encode_batch_cuda(w, k_pulses=k, delta_max=delta_max)
    p_ref, rho_ref = port_enc.pvq_encode_batch_plain(w, k_pulses=k, delta_max=delta_max)
    assert torch.equal(p, p_ref)
    assert torch.equal(rho, rho_ref)


@needs_cuda
def test_cuda_encode_replays_from_a_cuda_graph():
    """The KV encode's call (a block-fill's 1280 groups of 32, K 127)
    captured in a CUDA graph and replayed on other rows gives the eager
    result for those rows, bit for bit."""
    g, n, k = 1280, 32, 127
    w = torch.from_numpy(encode_rows(5, g, n)).cuda()
    def call(): return port_enc.pvq_encode_batch_cuda(w, k_pulses=k)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # warm up off the default stream, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["pvq_encode_batch"]
    with torch.cuda.graph(graph):
        p, rho = call()
    assert LAUNCHES["pvq_encode_batch"] == before + 1
    for seed in (6, 7):
        w.copy_(torch.from_numpy(encode_rows(seed, g, n)))
        p.fill_(-99)
        rho.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        p_eager, rho_eager = call()
        assert torch.equal(p, p_eager)
        assert torch.equal(rho, rho_eager)
        assert torch.equal(p, port_enc.pvq_encode_batch_plain(w, k_pulses=k)[0])


def _attn_case(b, n_kv, m, s, hd, group, seed):
    """int8 queries and K/V planes in the packed cache's (b, S, n_kv, X)
    layout on the card; kv_len cycles through 0, 1, 127, 128, 129 and S."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    bh, ng = b * n_kv, hd // group
    q_i8, a = port_q.quantize_activations(torch.randn(bh, m, hd, generator=gen))
    lead = (b, s, n_kv)
    kp = torch.randint(-20, 21, (*lead, hd), generator=gen, dtype=torch.int8)
    vp = torch.randint(-20, 21, (*lead, hd), generator=gen, dtype=torch.int8)
    ks = torch.rand(*lead, ng, generator=gen) * 0.2
    vs = torch.rand(*lead, ng, generator=gen) * 0.2
    lens = [0, 1, 127, 128, 129, s]
    kv_len = torch.tensor([lens[i % len(lens)] for i in range(bh)], dtype=torch.int32)
    return [t.to(dev) for t in (q_i8, a, kp, ks, vp, vs, kv_len)]


def _attn_equal(got, want, what):
    for name, g_, w_ in zip(("acc", "m", "l"), got, want):
        assert torch.equal(g_, w_), (name, what)


@needs_cuda
@pytest.mark.parametrize("n_kv", [1, 3, 5])
@pytest.mark.parametrize("hd,group", [(64, 32), (16, 16)])
@pytest.mark.parametrize("m", [3, 12, 768])
@pytest.mark.parametrize("s", [160, 520, 2048])
def test_cuda_attention_matches_plain(s, m, hd, group, n_kv):
    """Bit for bit, on a packed cache's (b, S, n_kv, X) planes, with the
    plan the rule picks; m 768 is more query rows than one CTA's shared
    memory holds at hd 64 (a chunked prefill's), tiled over the grid."""
    b = 6 // n_kv + 1
    args = _attn_case(b, n_kv, m, s, hd, group, seed=s + m + hd + n_kv)
    before = LAUNCHES["pvq_attn_q"]
    got = port_mm.pvq_attn_q_cuda(*args, group=group, sm_scale=0.125)
    assert LAUNCHES["pvq_attn_q"] == before + 1
    _attn_equal(got, port_mm.pvq_attn_q_plain(*args, group=group, sm_scale=0.125),
                port_mm._v4_plan(m, s, hd, group))


@needs_cuda
@pytest.mark.parametrize("s", [160, 416, 2048])
def test_cuda_attention_at_head_dim_256_matches_plain(s):
    """Kernel v4 at gemma-2b's and paligemma-3b's decode shape (batch 4,
    one KV head, 8 query rows a KV head, hd 256, group 32; S 416 is
    paligemma's 256-patch prefix, prompt 128 and 32 tokens): the rule's
    plan is km 8, w 2, near the shared-memory limit; bit for bit."""
    args = _attn_case(4, 1, 8, s, 256, 32, seed=s + 256)
    km, w, _ = port_mm._v4_plan(8, s, 256, 32)
    assert (km, w) == (8, 2)
    assert port_mm._v4_smem_bytes(km, w, 256, 32) <= port_mm.V4_SMEM_MAX
    got = port_mm.pvq_attn_q_cuda(*args, group=32, sm_scale=1 / 16)
    _attn_equal(got, port_mm.pvq_attn_q_plain(*args, group=32, sm_scale=1 / 16), s)


@needs_cuda
@pytest.mark.parametrize("s,b", [(160, 4), (416, 4), (2048, 1)])
def test_cuda_packed_decode_at_head_dim_256_against_the_exact_oracle(s, b):
    """``decode_attention_packed`` on the card (kernel v4 at hd 256) against
    ``exact=True``: relative L2 error within 0.03, the gate of the CPU
    check (``tests/test_torch_layers_ext.py``, 0.0136-0.0147 measured)."""
    from repro_torch.core.packed import PackedKV
    from repro_torch.nn import attention as port_attn

    gen = torch.Generator().manual_seed(s)
    k, v = (torch.randn((b, s, 1, 256), generator=gen).cuda() for _ in range(2))
    q = torch.randn((b, 1, 8, 256), generator=gen).cuda()
    kv = PackedKV.from_dense(k, v, kvq=port_q.KVQuant(block=32, group=32))
    length = torch.full((b,), s - 5, device="cuda")
    before = LAUNCHES["pvq_attn_q"]
    got = port_attn.decode_attention_packed(q, kv, scale=1 / 16, length=length, filled=s)
    assert LAUNCHES["pvq_attn_q"] == before + 1
    want = port_attn.decode_attention_packed(q, kv, scale=1 / 16, length=length, filled=s,
                                             exact=True)
    assert float((got - want).norm() / want.norm()) <= 0.03


# the bias epilogue on the served paths' shapes: whisper-small's d 768
# projections (q/k/v/o, cross, FFN) at decode and prefill, starcoder2-15b's
# FFN down (24,576 -> 6,144) and gemma-2b's (16,384 -> 2,048) at decode,
# each body forced
BIAS_CASES = [(4, 768, 768, "splitk"), (4, 768, 768, "direct"), (512, 768, 3072, "mma"),
              (512, 3072, 768, "direct"), (4, 24576, 6144, "splitk"), (4, 16384, 2048, "splitk"),
              (512, 16384, 2048, "mma")]


@needs_cuda
@pytest.mark.parametrize("m,k,n,body", BIAS_CASES)
def test_cuda_bias_epilogue_every_body_matches_plain(m, k, n, body):
    """v3 with a bias: identical to the plain version on every body; v2
    with a bias within ``rtol 1e-5`` (the module's tolerances)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(m + k + n)
    pulses, scales, bias, x = _v3_cases(m, k, n, 256, gen, dev)
    xq, a = ops._quantize_x(x, port_q.ActQuant(), 256)
    before, before_v2 = dict(V3_BODY_LAUNCHES), dict(V2_BODY_LAUNCHES)
    for act in ("none", "relu"):
        got = port_mm.pvq_matmul_q_cuda(xq, pulses, scales, a, bias, group=256, activation=act,
                                        _body=body)
        want = port_mm.pvq_matmul_q_plain(xq, pulses, scales, a, bias, group=256, activation=act)
        assert torch.equal(got, want), (body, act)
        got = port_mm.pvq_matmul_cuda(x, pulses, scales, bias, group=256, activation=act,
                                      _body=body)
        _close(got, port_mm.pvq_matmul_plain(x, pulses, scales, bias, group=256, activation=act))
    assert _body_launches_since(before)[body] == 2
    assert _v2_launches_since(before_v2)[body] == 2


# the recurrent slice's new 2-D shapes at decode and prefill (512 rows:
# batch 4 x prompt 128): jamba's x_proj (n 544, so the splitk body's last
# 64-column block is half full), its dt_proj (k 512) with its bias, and
# rwkv6-1.6b's channel mix (2048 -> 7168 -> 2048)
RECURRENT_CASES = [(4, 16384, 544, False), (512, 16384, 544, False), (4, 512, 16384, True),
                   (512, 512, 16384, True), (4, 2048, 7168, False), (4, 7168, 2048, False)]


@needs_cuda
@pytest.mark.parametrize("m,k,n,with_bias", RECURRENT_CASES)
def test_cuda_recurrent_shapes_match_plain_on_the_rules_body_and_direct(m, k, n, with_bias):
    """v3 identical and v2 within ``rtol 1e-5`` of the plain versions on
    the rule's body (splitk at m 4, mma at m 512) and on the direct body."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(m + k + n)
    pulses, scales, bias, x = _v3_cases(m, k, n, 256, gen, dev)
    bias = bias if with_bias else None
    xq, a = ops._quantize_x(x, port_q.ActQuant(), 256)
    rule = "splitk" if m <= 8 else "mma"
    want_q = port_mm.pvq_matmul_q_plain(xq, pulses, scales, a, bias, group=256)
    want_f = port_mm.pvq_matmul_plain(x, pulses, scales, bias, group=256)
    before, before_v2 = dict(V3_BODY_LAUNCHES), dict(V2_BODY_LAUNCHES)
    for body in (None, "direct"):
        got = port_mm.pvq_matmul_q_cuda(xq, pulses, scales, a, bias, group=256, _body=body)
        assert torch.equal(got, want_q), body
        _close(port_mm.pvq_matmul_cuda(x, pulses, scales, bias, group=256, _body=body), want_f)
    assert _body_launches_since(before) == {b: int(b in (rule, "direct")) for b in V3_BODY_LAUNCHES}
    assert _v2_launches_since(before_v2) == {b: int(b in (rule, "direct"))
                                             for b in V2_BODY_LAUNCHES}


@needs_cuda
@pytest.mark.parametrize("s", [160, 2048])
def test_cuda_attention_at_head_dim_128_with_eight_kv_heads_matches_plain(s):
    """Kernel v4 at jamba-1.5-large-398b's attention layer (batch 4 x 8 KV
    heads, 8 query rows a KV head, hd 128, group 32): bit for bit on the
    rule's plan."""
    args = _attn_case(4, 8, 8, s, 128, 32, seed=s + 128)
    km, w, _ = port_mm._v4_plan(8, s, 128, 32)
    assert km == 8 and port_mm._v4_smem_bytes(km, w, 128, 32) <= port_mm.V4_SMEM_MAX
    got = port_mm.pvq_attn_q_cuda(*args, group=32, sm_scale=128 ** -0.5)
    _attn_equal(got, port_mm.pvq_attn_q_plain(*args, group=32, sm_scale=128 ** -0.5), s)


@needs_cuda
@pytest.mark.parametrize("e,m,k,n", [
    (16, 1, 8192, 24576),   # jamba's up/gate bank at decode (batch 4, top-2: capacity 1)
    (16, 80, 8192, 24576),  # at prefill (512 tokens: capacity 80)
    (16, 1, 24576, 8192),   # its wo bank at decode
    (160, 1, 5120, 1536),   # deepseek-v2-236b's up/gate bank at decode
    (160, 24, 1536, 5120),  # its wo bank at prefill (512 tokens, top-6: capacity 24)
])
def test_cuda_batched_kernels_at_the_recurrent_banks_match_plain(e, m, k, n):
    """The batched kernels over the new expert banks (16 experts of 8192 x
    24576, 160 of 5120 x 1536): v3 identical, v2 within ``rtol 1e-5``, on
    the rule's body (splitk at m 1, mma above 8 rows)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(e + m + k)
    pulses, scales = _bank(gen, e, k, n, 256, dev)
    x = torch.randn(e, m, k, generator=gen, device=dev)
    x_q, a = port_q.quantize_activations(x)
    body = "splitk" if m <= 8 else "mma"
    before, before_v2 = dict(V3_BODY_LAUNCHES), dict(V2_BODY_LAUNCHES)
    got = port_mm.pvq_matmul_q_batched_cuda(x_q, pulses, scales, a, group=256)
    assert torch.equal(got, port_mm.pvq_matmul_q_batched_plain(x_q, pulses, scales, a, group=256))
    _close(port_mm.pvq_matmul_batched_cuda(x, pulses, scales, group=256),
           port_mm.pvq_matmul_batched_plain(x, pulses, scales, group=256))
    assert _body_launches_since(before) == {b: int(b == body) for b in V3_BODY_LAUNCHES}
    assert _v2_launches_since(before_v2) == {b: int(b == body) for b in V2_BODY_LAUNCHES}


@needs_cuda
@pytest.mark.parametrize("s,kv_len", [(288, 0), (288, 128), (416, 256), (2048, 1920)])
def test_cuda_attention_at_the_chunk_caller_matches_plain(s, kv_len):
    """Kernel v4 as ``attention_prefill_chunk`` calls it at smollm's full
    width: one slot's gather (batch 1, 5 KV heads), a 128-token chunk's
    128 x 3 query rows, ``kv_len`` = the chunk's start (0 on a first chunk:
    the empty row, ``m = ATTN_NEG_INF`` and ``l = 0``)."""
    args = _attn_case(1, 5, 384, s, 64, 32, seed=s + kv_len)
    args[-1].fill_(kv_len)
    got = port_mm.pvq_attn_q_cuda(*args, group=32, sm_scale=0.125)
    want = port_mm.pvq_attn_q_plain(*args, group=32, sm_scale=0.125)
    _attn_equal(got, want, (s, kv_len))
    if kv_len == 0:
        assert bool((got[1] == port_mm.ATTN_NEG_INF).all()) and not bool(got[2].any())


@contextlib.contextmanager
def _plain_versions():
    """Each kernel wrapper's CUDA entry point answered by its plain version
    on the same CUDA tensors (a test-only patch of what ``ops`` reads)."""
    saved = [(mod, name, getattr(mod, name + "_cuda"))
             for mod, name in ((port_mm, "pvq_matmul"), (port_mm, "pvq_matmul_q"),
                               (port_mm, "pvq_attn_q"), (port_enc, "pvq_encode_batch"))]
    try:
        for mod, name, _ in saved:
            setattr(mod, name + "_cuda",
                    chip_smoke()._plain_for_cuda(getattr(mod, name + "_plain")))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name + "_cuda", fn)


@needs_cuda
def test_cuda_engine_tokens_match_plain_versions():
    """CI's chunked-prefill engine configuration on the reduced model on the
    card (chunks, prefix hits, batched admission, block-fill appends): the
    tokens through the kernels (the decode step captured) equal those
    through their plain versions (the eager engine: a graph would replay
    the kernels it captured), and kernel v4 ran from the chunk caller as
    well as from decode."""
    from repro_torch.configs import get_config
    from repro_torch.core.packed import quantize_params
    from repro_torch.launch.engine import PVQEngine, poisson_trace
    from repro_torch.launch.serve import serving_policy
    from repro_torch.nn import attention
    from repro_torch.nn.models import Model

    cfg = get_config("smollm-360m").reduced()
    model = Model(cfg)
    params = quantize_params(model.init(0, device="cuda"), serving_policy(cfg))
    chunk_v4 = []
    inner = attention.attention_prefill_chunk

    def counted(*a, **kw):
        before = LAUNCHES["pvq_attn_q"]
        out = inner(*a, **kw)
        chunk_v4.append(LAUNCHES["pvq_attn_q"] - before)
        return out

    def run(eager=False):
        trace = poisson_trace(6, rate=0.0, vocab=cfg.vocab_size, prompt_lens=(12, 24),
                              max_new=8, seed=2, shared_prefix=64)
        eng = PVQEngine(model, params, n_slots=2, max_len=96, prefill_chunk=2, prefill_batch=2,
                        eager=eager)
        return eng.run(trace)

    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(port_q.KVQuant(8, 16)):
        attention.attention_prefill_chunk = counted
        try:
            before = dict(LAUNCHES)
            kernels = run()
        finally:
            attention.attention_prefill_chunk = inner
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        with _plain_versions():
            before = dict(LAUNCHES)
            plain = run(eager=True)
            assert LAUNCHES == before
    assert kernels["chunks"] > 0 and kernels["prefix_hits"] > 0
    assert kernels["outputs"] == plain["outputs"]
    assert launched["pvq_attn_q"] > sum(chunk_v4) > 0
    assert launched["pvq_encode_batch"] > 0 and launched["pvq_matmul_q"] > 0


def _every_v4_plan(s, hd, group):
    """Every (km, w, passes) the plan function can return at S ``s``."""
    nblk = -(-s // port_mm.ATTN_BS)
    for km in range(1, port_mm.V4_KM_MAX + 1):
        for w in range(1, port_mm.V4_WARPS_MAX // km + 1):
            if port_mm._v4_smem_bytes(km, w, hd, group) <= port_mm.V4_SMEM_MAX:
                yield km, w, -(-nblk // w)


@needs_cuda
@pytest.mark.parametrize("s,m,hd,group", [(520, 12, 64, 32), (520, 12, 16, 16), (2048, 3, 64, 32),
                                          (300, 5, 36, 12), (200, 4, 20, 5), (150, 3, 18, 6)])
def test_cuda_attention_every_forced_plan_matches_plain(s, m, hd, group):
    """Each plan the rule can pick, forced: query-row tiles of 1 to 8, 1 to
    16 blocks a pass; head dims off the 16-byte path too
    (36 and 20: 4-byte pieces; 18: byte pieces; groups 5 and 6: byte dots)."""
    args = _attn_case(2, 3, m, s, hd, group, seed=s + m + hd)
    want = port_mm.pvq_attn_q_plain(*args, group=group, sm_scale=0.3)
    plans = list(_every_v4_plan(s, hd, group))
    assert port_mm._v4_plan(m, s, hd, group) in plans
    for plan in plans:
        _attn_equal(port_mm.pvq_attn_q_cuda(*args, group=group, sm_scale=0.3, _plan=plan),
                    want, plan)


@needs_cuda
def test_v4_shared_memory_formula_is_the_kernels():
    from repro_torch.kernels import build

    smem = build.launcher("pvq_attn_q_smem_bytes")
    for hd, group in ((64, 32), (16, 16), (128, 32), (36, 12), (20, 5)):
        for km, w, _ in _every_v4_plan(2048, hd, group):
            assert smem(km, w, hd, group) == port_mm._v4_smem_bytes(km, w, hd, group)


@needs_cuda
def test_cuda_attention_replays_from_a_cuda_graph():
    """One v4 call captured in a CUDA graph and replayed with other kv_len
    contents gives the eager result for those contents, bit for bit (the
    plan comes from the planes' capacity, never from kv_len)."""
    args = _attn_case(4, 5, 3, 2048, 64, 32, seed=7)
    kv_len = args[-1]
    def call(): return port_mm.pvq_attn_q_cuda(*args, group=32, sm_scale=0.125)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # warm up off the default stream, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["pvq_attn_q"]
    with torch.cuda.graph(graph):
        out = call()
    assert LAUNCHES["pvq_attn_q"] == before + 1
    for lens in ([2048, 0, 129, 1000, 1] * 4, [160] * 20):
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        _attn_equal(out, call(), lens)


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


def _bank(gen, e, k, n, group, dev):
    pulses = torch.randint(-9, 10, (e, k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(e, k // group, n, generator=gen, device=dev)
    return pulses, scales


@needs_cuda
@pytest.mark.parametrize(
    "e,m,k,n,group",
    [
        (64, 1, 2048, 1408, 256),   # up / gate at decode
        (64, 60, 2048, 1408, 256),  # up / gate at prefill
        (64, 1, 1536, 2048, 256),   # wo at decode
        (64, 60, 1536, 2048, 256),  # wo at prefill
        (5, 7, 96, 40, 32),         # ragged n, rows not 16-byte multiples: the direct body
        (3, 9, 128, 48, 32),        # n % 32 != 0 on 16-byte rows, m > 8: the mma body
        (2, 3, 12, 5, 6),           # a group not divisible by 4
        (2, 10, 12, 5, 6),          # the same, m > 8: pulses read directly
    ],
)
def test_cuda_batched_kernels_match_plain(e, m, k, n, group):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(e + m + k)
    pulses, scales = _bank(gen, e, k, n, group, dev)
    if m <= 8:
        body = v2_body = "splitk" if group % 4 == 0 and n % 16 == 0 else "direct"
    else:
        body = "mma" if group % 32 == 0 and n % 16 == 0 else "direct"
        v2_body = "mma" if group % 16 == 0 and n % 16 == 0 else "direct"
    before, before_v2 = dict(V3_BODY_LAUNCHES), dict(V2_BODY_LAUNCHES)
    x = torch.randn(e, m, k, generator=gen, device=dev)
    x_q, a = port_q.quantize_activations(x)
    for act in ("none", "silu"):
        got = port_mm.pvq_matmul_q_batched_cuda(x_q, pulses, scales, a, group=group, activation=act)
        want = port_mm.pvq_matmul_q_batched_plain(x_q, pulses, scales, a, group=group, activation=act)
        assert torch.equal(got, want), act
        _close(port_mm.pvq_matmul_batched_cuda(x, pulses, scales, group=group, activation=act),
               port_mm.pvq_matmul_batched_plain(x, pulses, scales, group=group, activation=act))
    if k > group:  # per-tile scales, applied beside rho
        xt, at = port_q.quantize_activations(x, port_q.ActQuant("per_tile"), tile=group)
        assert torch.equal(port_mm.pvq_matmul_q_batched_cuda(xt, pulses, scales, at, group=group),
                           port_mm.pvq_matmul_q_batched_plain(xt, pulses, scales, at, group=group))
    got = port_mm.pvq_matmul_q_batched_cuda(x_q, pulses, scales, a, group=group,
                                            out_dtype=torch.bfloat16)
    assert torch.equal(got, port_mm.pvq_matmul_q_batched_plain(
        x_q, pulses, scales, a, group=group, out_dtype=torch.bfloat16))
    xb = x.to(torch.bfloat16)
    _close(port_mm.pvq_matmul_batched_cuda(xb, pulses, scales, group=group),
           port_mm.pvq_matmul_batched_plain(xb, pulses, scales, group=group), rtol=1e-2)
    launched = _body_launches_since(before)
    assert launched[body] > 0 and sum(launched.values()) == launched[body], launched
    assert _v2_launches_since(before_v2) == {b: 3 if b == v2_body else 0 for b in V2_BODY_LAUNCHES}


@needs_cuda
@pytest.mark.parametrize(
    "e,m,k,n,group",
    [
        (64, 60, 2048, 1408, 256),  # up / gate at prefill
        (64, 60, 1536, 2048, 256),  # wo at prefill
        (3, 17, 512, 48, 32),       # ragged rows and columns inside one tile
    ],
)
def test_cuda_batched_mma_body_matches_plain(e, m, k, n, group):
    """Batched v3 at m > 8 takes the tensor-core body and is identical to
    its plain version: per-row and per-tile scales, each activation (tanh-
    gelu within rtol 1e-5), f32 and bf16 output."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(e + m + k + n)
    pulses = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(e, k // group, n, generator=gen, device=dev)
    x = torch.randn(e, m, k, generator=gen, device=dev)
    before = dict(V3_BODY_LAUNCHES)
    calls = 0
    for mode in ("per_row", "per_tile"):
        xq, a = port_q.quantize_activations(x, port_q.ActQuant(mode), tile=group)
        for act in port_mm.ACTIVATIONS:
            got = port_mm.pvq_matmul_q_batched_cuda(xq, pulses, scales, a, group=group, activation=act)
            want = port_mm.pvq_matmul_q_batched_plain(xq, pulses, scales, a, group=group, activation=act)
            calls += 1
            if act == "gelu":
                _close(got, want)
            else:
                assert torch.equal(got, want), (mode, act)
        got = port_mm.pvq_matmul_q_batched_cuda(xq, pulses, scales, a, group=group, activation="silu",
                                                out_dtype=torch.bfloat16)
        assert torch.equal(got, port_mm.pvq_matmul_q_batched_plain(
            xq, pulses, scales, a, group=group, activation="silu", out_dtype=torch.bfloat16)), mode
        calls += 1
    assert _body_launches_since(before) == {"splitk": 0, "direct": 0, "mma": calls}


@needs_cuda
def test_forced_bodies_agree_and_mma_refuses_what_it_cannot_take():
    """The private body argument runs each body on one shape (all identical;
    the splitk body on its first 8 rows), and the mma and splitk bodies
    raise on a shape outside their preconditions."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    pulses, scales, bias, x = _v3_cases(40, 512, 96, 64, gen, dev)
    xq, a = ops._quantize_x(x, port_q.ActQuant(), 64)
    for body in port_mm.V3_BODIES:
        rows = slice(0, 8) if body == "splitk" else slice(None)
        want = port_mm.pvq_matmul_q_plain(xq[rows], pulses, scales, a[rows], bias, group=64)
        assert torch.equal(port_mm.pvq_matmul_q_cuda(xq[rows], pulses, scales, a[rows], bias,
                                                     group=64, _body=body), want), body
    with pytest.raises(ValueError, match="mma body"):
        port_mm.pvq_matmul_q_cuda(xq[:, :96], pulses[:96, :40], scales[:1, :40],
                                  a, None, group=96, _body="mma")
    with pytest.raises(ValueError, match="splitk body"):  # n % 16 != 0
        port_mm.pvq_matmul_q_cuda(xq[:4], pulses[:, :40], scales[:, :40], a[:4], None,
                                  group=64, _body="splitk")
    with pytest.raises(ValueError, match="splitk body"):  # more than 8 rows
        port_mm.pvq_matmul_q_cuda(xq, pulses, scales, a, None, group=64, _body="splitk")


def _splitk_counters_are_zero():
    torch.cuda.synchronize()
    return all(int(c.abs().sum()) == 0 for c in port_mm._SPLITK_COUNTERS.values())


@needs_cuda
@pytest.mark.parametrize("n", [16, 320, 960, 2560, 40])
@pytest.mark.parametrize("ngroups", [1, 4])
@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("m", range(1, 9))
def test_cuda_splitk_body_matches_plain(m, group, ngroups, n):
    """At m <= 8 the splitk body (n 40: the direct body) is identical to the
    plain version: per-row, scalar and (over several groups) per-tile
    scales, with and without bias, each activation (tanh-gelu within rtol
    1e-5), f32 and bf16 output.  One group (k = group) and four; the plan
    splits k over CTAs on these few column blocks, into pieces of a group."""
    dev = torch.device("cuda")
    k = group * ngroups
    gen = torch.Generator().manual_seed(m * 131 + group + n + k)
    pulses, scales, bias, x = _v3_cases(m, k, n, group, gen, dev)
    xq, a_row = ops._quantize_x(x, port_q.ActQuant("per_row"), group)
    xt, a_tile = ops._quantize_x(x, port_q.ActQuant("per_tile"), group)
    cases = [(xq, a_row), (xq, a_row.amax().reshape(1, 1))] + ([(xt, a_tile)] if k > group else [])
    body = "splitk" if n % 16 == 0 else "direct"
    before = dict(V3_BODY_LAUNCHES)
    calls = 0
    for xin, a in cases:
        for act in port_mm.ACTIVATIONS:
            for b in (None, bias):
                got = port_mm.pvq_matmul_q_cuda(xin, pulses, scales, a, b, group=group,
                                                activation=act)
                want = port_mm.pvq_matmul_q_plain(xin, pulses, scales, a, b, group=group,
                                                  activation=act)
                calls += 1
                if act == "gelu":
                    _close(got, want)
                else:
                    assert torch.equal(got, want), (tuple(a.shape), act, b is None)
        got = port_mm.pvq_matmul_q_cuda(xin, pulses, scales, a, bias, group=group,
                                        activation="silu", out_dtype=torch.bfloat16)
        assert torch.equal(got, port_mm.pvq_matmul_q_plain(
            xin, pulses, scales, a, bias, group=group, activation="silu",
            out_dtype=torch.bfloat16)), tuple(a.shape)
        calls += 1
    assert _body_launches_since(before) == {b: calls if b == body else 0 for b in V3_BODY_LAUNCHES}
    assert _splitk_counters_are_zero()


@needs_cuda
@pytest.mark.parametrize(
    "e,m,k,n,group",
    [
        (64, 1, 2048, 1408, 256),  # up / gate at decode: no split, 16 stages through 4 slots
        (64, 1, 1536, 2048, 256),  # wo at decode
        (300, 5, 1024, 16, 128),   # 300 column blocks: no split, 8 stages
        (3, 8, 512, 80, 64),       # split k; the second column block is part-filled
        (2, 4, 256, 48, 4),        # the smallest group: chunks of 4 rows
    ],
)
def test_cuda_splitk_batched_matches_plain(e, m, k, n, group):
    """The batched route's splitk body is identical to the plain version:
    per-row and per-tile scales, each activation but tanh-gelu (within rtol
    1e-5), f32 and bf16 output."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(e * 3 + m + k + n)
    pulses = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(e, k // group, n, generator=gen, device=dev)
    x = torch.randn(e, m, k, generator=gen, device=dev)
    before = dict(V3_BODY_LAUNCHES)
    calls = 0
    for mode in ("per_row", "per_tile"):
        xq, a = port_q.quantize_activations(x, port_q.ActQuant(mode), tile=group)
        for act in port_mm.ACTIVATIONS:
            for out_dtype in (torch.float32, torch.bfloat16):
                got = port_mm.pvq_matmul_q_batched_cuda(xq, pulses, scales, a, group=group,
                                                        activation=act, out_dtype=out_dtype)
                want = port_mm.pvq_matmul_q_batched_plain(xq, pulses, scales, a, group=group,
                                                          activation=act, out_dtype=out_dtype)
                calls += 1
                if act == "gelu":
                    _close(got, want, rtol=1e-5 if out_dtype == torch.float32 else 1e-2)
                else:
                    assert torch.equal(got, want), (mode, act, out_dtype)
    assert _body_launches_since(before) == {"splitk": calls, "direct": 0, "mma": 0}
    assert _splitk_counters_are_zero()


@needs_cuda
@pytest.mark.parametrize("e,m,k,n,group", [(1, 4, 1024, 960, 256), (1, 1, 2048, 102400, 256),
                                           (64, 1, 2048, 1408, 256), (3, 8, 512, 80, 64)])
def test_cuda_splitk_calls_in_a_row_leave_the_counters_at_zero(e, m, k, n, group):
    """Three calls in a row on one stream give the same result bit for bit:
    the last CTA of each column block resets its arrival counter."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(k + n)
    pulses = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(e, k // group, n, generator=gen, device=dev)
    xq, a = port_q.quantize_activations(torch.randn(e, m, k, generator=gen, device=dev))
    if e == 1:
        want = port_mm.pvq_matmul_q_plain(xq[0], pulses[0], scales[0], a[0], group=group)
        outs = [port_mm.pvq_matmul_q_cuda(xq[0], pulses[0], scales[0], a[0], group=group)
                for _ in range(3)]
    else:
        want = port_mm.pvq_matmul_q_batched_plain(xq, pulses, scales, a, group=group)
        outs = [port_mm.pvq_matmul_q_batched_cuda(xq, pulses, scales, a, group=group)
                for _ in range(3)]
    for i, got in enumerate(outs):
        assert torch.equal(got, want), i
    assert _splitk_counters_are_zero()


@needs_cuda
@pytest.mark.parametrize("batched", [False, True])
def test_cuda_splitk_body_replays_from_a_cuda_graph(batched):
    """One call captured in a CUDA graph and replayed twice gives the eager
    result bit for bit (a split-k shape: scratch, counters and all)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    e, m, k, n, group = (3, 8, 512, 80, 64) if batched else (1, 4, 1024, 960, 256)
    pulses = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(e, k // group, n, generator=gen, device=dev)
    xq, a = port_q.quantize_activations(torch.randn(e, m, k, generator=gen, device=dev))
    if batched:
        def call(): return port_mm.pvq_matmul_q_batched_cuda(xq, pulses, scales, a, group=group)
    else:
        def call(): return port_mm.pvq_matmul_q_cuda(xq[0], pulses[0], scales[0], a[0], group=group)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # warm up off the default stream, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(V3_BODY_LAUNCHES)
    with torch.cuda.graph(graph):
        out = call()
    assert _body_launches_since(before)["splitk"] == 1
    for replay in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), replay
    assert _splitk_counters_are_zero()


@needs_cuda
def test_ops_route_stacked_banks_to_the_batched_kernels():
    from repro_torch.core.packed import pack_matmul

    dev = torch.device("cuda")
    bank = pack_matmul(torch.randn(4, 96, 40, device=dev), group=64, k=64)
    x = torch.randn(4, 3, 96, device=dev)
    before = dict(LAUNCHES)
    ops.packed_matmul_stacked(x, bank)
    ops.packed_matmul_stacked(x, bank, act_quant=port_q.ActQuant())
    assert LAUNCHES["pvq_matmul_batched"] == before["pvq_matmul_batched"] + 1
    assert LAUNCHES["pvq_matmul_q_batched"] == before["pvq_matmul_q_batched"] + 1


def _v2_tol(dtype, act):
    return 1e-2 if dtype == torch.bfloat16 and act in ("gelu", "silu") else 1e-5


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [32, 64, 256])
@pytest.mark.parametrize("m", [9, 60, 65, 512])
def test_cuda_v2_mma_body_matches_plain(m, group, dtype):
    """Kernel v2 at m > 8 takes the f64 tensor-core body, 2-D and batched
    over 3 experts, and agrees with its plain version: f32 and bf16 x, with
    and without bias, each activation; n 80 leaves a part-filled column
    block, m 65 a part-filled row block."""
    dev = torch.device("cuda")
    k, n, e = 512, 80, 3
    gen = torch.Generator(device=dev).manual_seed(m * 31 + group)
    pulses = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(e, k // group, n, generator=gen, device=dev)
    bias = torch.randn(n, generator=gen, device=dev)
    x = torch.randn(e, m, k, generator=gen, device=dev).to(dtype)
    before = dict(V2_BODY_LAUNCHES)
    calls = 0
    for act in port_mm.ACTIVATIONS:
        for b in (None, bias):
            got = port_mm.pvq_matmul_cuda(x[0], pulses[0], scales[0], b, group=group, activation=act)
            want = port_mm.pvq_matmul_plain(x[0], pulses[0], scales[0], b, group=group,
                                            activation=act)
            assert got.dtype == dtype
            _close(got, want, rtol=_v2_tol(dtype, act))
            calls += 1
        got = port_mm.pvq_matmul_batched_cuda(x, pulses, scales, group=group, activation=act)
        want = port_mm.pvq_matmul_batched_plain(x, pulses, scales, group=group, activation=act)
        _close(got, want, rtol=_v2_tol(dtype, act))
        calls += 1
    assert _v2_launches_since(before) == {"direct": 0, "mma": calls, "splitk": 0}


@needs_cuda
def test_forced_v2_bodies_agree_and_mma_refuses_what_it_cannot_take():
    """The private body argument runs each v2 body on one shape (each agrees
    with the plain version; the splitk body on the first 8 rows), and the
    mma and splitk bodies raise on operands outside their preconditions
    instead of running the direct body."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    k, n, group = 512, 96, 64
    pulses = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(k // group, n, generator=gen, device=dev)
    x = torch.randn(40, k, generator=gen, device=dev)
    before = dict(V2_BODY_LAUNCHES)
    for body in port_mm.V2_BODIES:
        rows = slice(0, 8) if body == "splitk" else slice(None)
        want = port_mm.pvq_matmul_plain(x[rows], pulses, scales, group=group)
        _close(port_mm.pvq_matmul_cuda(x[rows], pulses, scales, group=group, _body=body), want)
    assert _v2_launches_since(before) == {"direct": 1, "mma": 1, "splitk": 1}
    before = dict(V2_BODY_LAUNCHES)
    with pytest.raises(ValueError, match="v2 splitk body"):  # more than 8 rows
        port_mm.pvq_matmul_cuda(x, pulses, scales, group=group, _body="splitk")
    with pytest.raises(ValueError, match="v2 splitk body"):  # n % 16 != 0
        port_mm.pvq_matmul_cuda(x[:4], pulses[:, :40], scales[:, :40], group=group, _body="splitk")
    with pytest.raises(ValueError, match="v2 splitk body"):  # n % 16 != 0, batched
        port_mm.pvq_matmul_batched_cuda(x[None, :4, :96], pulses[None, :96, :40],
                                        scales[None, :1, :40], group=96, _body="splitk")
    with pytest.raises(ValueError, match="v2 mma body"):  # n % 16 != 0
        port_mm.pvq_matmul_cuda(x, pulses[:, :40], scales[:, :40], group=group, _body="mma")
    with pytest.raises(ValueError, match="v2 mma body"):  # a group not a multiple of 16
        port_mm.pvq_matmul_cuda(x[:, :96], pulses[:96], scales[:4], group=24, _body="mma")
    with pytest.raises(ValueError, match="v2 mma body"):
        port_mm.pvq_matmul_batched_cuda(x[None, :, :96], pulses[None, :96], scales[None, :4],
                                        group=24, _body="mma")
    assert _v2_launches_since(before) == {"direct": 0, "mma": 0, "splitk": 0}


def _v2_cases(e, m, k, n, group, dtype, gen, dev):
    """Pulses over the whole int8 range, rho, bias and x (``dtype``) for a v2
    check over ``e`` matrices."""
    pulses = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8, device=dev)
    scales = torch.rand(e, k // group, n, generator=gen, device=dev)
    bias = torch.randn(n, generator=gen, device=dev)
    x = torch.randn(e, m, k, generator=gen, device=dev).to(dtype)
    return pulses, scales, bias, x


@needs_cuda
@pytest.mark.parametrize("n", [16, 320, 960, 2560, 40])
@pytest.mark.parametrize("ngroups", [1, 4])
@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("m", range(1, 9))
def test_cuda_v2_splitk_body_matches_plain(m, group, ngroups, n):
    """At m <= 8 kernel v2 takes the splitk body (n 40: the direct body) and
    agrees with its plain version: f32 and bf16 x, with and without bias,
    each activation.  One group (k = group) and four; the plan splits k over
    CTAs on these few column blocks, into pieces of a group."""
    dev = torch.device("cuda")
    k = group * ngroups
    gen = torch.Generator(device=dev).manual_seed(m * 131 + group + n + k)
    body = "splitk" if n % 16 == 0 else "direct"
    before = dict(V2_BODY_LAUNCHES)
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        pulses, scales, bias, x = _v2_cases(1, m, k, n, group, dtype, gen, dev)
        for act in port_mm.ACTIVATIONS:
            for b in (None, bias):
                got = port_mm.pvq_matmul_cuda(x[0], pulses[0], scales[0], b, group=group,
                                              activation=act)
                want = port_mm.pvq_matmul_plain(x[0], pulses[0], scales[0], b, group=group,
                                                activation=act)
                assert got.dtype == dtype
                _close(got, want, rtol=_v2_tol(dtype, act))
                calls += 1
    assert _v2_launches_since(before) == {b: calls if b == body else 0 for b in V2_BODY_LAUNCHES}
    assert _splitk_counters_are_zero()


@needs_cuda
@pytest.mark.parametrize(
    "e,m,k,n,group",
    [
        (64, 1, 2048, 1408, 256),  # up / gate at decode: no split, 8 stages through 3 slots
        (64, 1, 1536, 2048, 256),  # wo at decode
        (300, 5, 1024, 16, 128),   # 300 column blocks: no split, 8 stages
        (3, 8, 512, 80, 64),       # split k; the second column block is part-filled
        (2, 4, 256, 48, 4),        # the smallest group: chunks of 4 rows
    ],
)
def test_cuda_v2_splitk_batched_matches_plain(e, m, k, n, group):
    """The batched route's v2 splitk body agrees with the plain version: f32
    and bf16 x, each activation."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(e * 5 + m + k + n)
    before = dict(V2_BODY_LAUNCHES)
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        pulses, scales, _, x = _v2_cases(e, m, k, n, group, dtype, gen, dev)
        for act in port_mm.ACTIVATIONS:
            got = port_mm.pvq_matmul_batched_cuda(x, pulses, scales, group=group, activation=act)
            want = port_mm.pvq_matmul_batched_plain(x, pulses, scales, group=group, activation=act)
            assert got.dtype == dtype
            _close(got, want, rtol=_v2_tol(dtype, act))
            calls += 1
    assert _v2_launches_since(before) == {"direct": 0, "mma": 0, "splitk": calls}
    assert _splitk_counters_are_zero()


@needs_cuda
@pytest.mark.parametrize("e,m,k,n,group", [(1, 4, 1024, 960, 256), (1, 1, 2048, 102400, 256),
                                           (64, 1, 2048, 1408, 256), (3, 8, 512, 80, 64)])
def test_cuda_v2_splitk_calls_in_a_row_and_among_v3_calls_leave_the_counters_at_zero(
        e, m, k, n, group):
    """Three v2 calls in a row on one stream, then v2 and v3 calls in turn
    (the two splitk bodies share the stream's arrival counters), give the
    same results bit for bit: the last CTA of each column block resets its
    counter."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(k + n + 1)
    pulses, scales, _, x = _v2_cases(e, m, k, n, group, torch.float32, gen, dev)
    xq, a = port_q.quantize_activations(x)
    if e == 1:
        def v2(): return port_mm.pvq_matmul_cuda(x[0], pulses[0], scales[0], group=group)
        def v3(): return port_mm.pvq_matmul_q_cuda(xq[0], pulses[0], scales[0], a[0], group=group)
        want = port_mm.pvq_matmul_plain(x[0], pulses[0], scales[0], group=group)
    else:
        def v2(): return port_mm.pvq_matmul_batched_cuda(x, pulses, scales, group=group)
        def v3(): return port_mm.pvq_matmul_q_batched_cuda(xq, pulses, scales, a, group=group)
        want = port_mm.pvq_matmul_batched_plain(x, pulses, scales, group=group)
    before, before_v3 = dict(V2_BODY_LAUNCHES), dict(V3_BODY_LAUNCHES)
    first = v2()
    _close(first, want)
    outs = [v2() for _ in range(2)]
    want_q = v3()
    for _ in range(2):
        outs.append(v2())
        assert torch.equal(v3(), want_q)
    for i, got in enumerate(outs):
        assert torch.equal(got, first), i
    assert _v2_launches_since(before)["splitk"] == 5
    assert _body_launches_since(before_v3)["splitk"] == 3
    assert _splitk_counters_are_zero()


@needs_cuda
@pytest.mark.parametrize("batched", [False, True])
def test_cuda_v2_splitk_body_replays_from_a_cuda_graph(batched):
    """One v2 call captured in a CUDA graph and replayed twice gives the
    eager result bit for bit (a split-k shape: scratch, counters and all)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    e, m, k, n, group = (3, 8, 512, 80, 64) if batched else (1, 4, 1024, 960, 256)
    pulses, scales, bias, x = _v2_cases(e, m, k, n, group, torch.float32, gen, dev)
    if batched:
        def call(): return port_mm.pvq_matmul_batched_cuda(x, pulses, scales, group=group)
    else:
        def call(): return port_mm.pvq_matmul_cuda(x[0], pulses[0], scales[0], bias, group=group,
                                                   activation="silu")
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # warm up off the default stream, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(V2_BODY_LAUNCHES)
    with torch.cuda.graph(graph):
        out = call()
    assert _v2_launches_since(before)["splitk"] == 1
    for replay in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), replay
    assert _splitk_counters_are_zero()


# ---------------------------------------------------------------------------
# the captured decode step (launch.capture, serve._lockstep, the engine)
# ---------------------------------------------------------------------------


def _reduced_packed(arch):
    from repro_torch.configs import get_config
    from repro_torch.core.packed import quantize_params
    from repro_torch.launch.serve import serving_policy
    from repro_torch.nn.models import Model

    cfg = get_config(arch).reduced()
    model = Model(cfg)
    return model, quantize_params(model.init(0, device="cuda"), serving_policy(cfg))


def _packed_kv_leaves(cache):
    from repro_torch.core.packed import is_packed_kv

    return [e["kv"] for seg in cache.values() for layer in seg for e in layer.values()
            if "kv" in e and is_packed_kv(e["kv"])]


@needs_cuda
def test_cuda_captured_decode_matches_eager_across_block_fills():
    """Reduced smollm (``--pvq --act-int8 --kv-pvq``, KV block 8), prompt 13
    and 13 steps: the captured step (its no-fill graph, then the fill graph
    at positions 15 and 23, replayed) against the host-int eager step on the
    same prefill: identical logits and tokens every step, and identical
    ``PackedKV`` planes and rings at the end; two captures."""
    from repro_torch.launch import serve

    model, params = _reduced_packed("smollm-360m")
    gen = torch.Generator().manual_seed(21)
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 13), generator=gen).cuda()
    feed = torch.randint(0, model.cfg.vocab_size, (2, 13), generator=gen).cuda()
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(port_q.KVQuant(8, 16)):
        _, eager_cache = model.prefill(params, {"tokens": prompt}, cache_len=32)
        _, cache = model.prefill(params, {"tokens": prompt}, cache_len=32)
        key = serve._step_key(params, cache)
        captures = serve.TRACE_COUNTS["decode_step"]
        eager = serve._lockstep(model, params, eager_cache, prompt, eager=True)
        captured = serve._lockstep(model, params, cache, prompt, eager=False)
        for i in range(13):
            want_logits, want_tok = eager(feed[:, i : i + 1], 13 + i)
            got_logits, got_tok = captured(feed[:, i : i + 1], 13 + i)
            assert torch.equal(got_logits, want_logits), i
            assert torch.equal(got_tok, want_tok), i
    static = serve._captured_step(model)[key]
    assert sorted(static.graphs) == [False, True]
    assert serve.TRACE_COUNTS["decode_step"] == captures + 2
    for a, b in zip(_packed_kv_leaves(eager_cache), _packed_kv_leaves(static.cache)):
        for name in ("k_pulses", "k_scales", "v_pulses", "v_scales", "tail_k", "tail_v"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@needs_cuda
@pytest.mark.parametrize("arch,kv", [("smollm-360m", True), ("deepseek-v2-lite-16b", False),
                                     ("rwkv6-1.6b", True), ("jamba-1.5-large-398b", True),
                                     ("deepseek-v2-236b", False)])
def test_cuda_captured_serve_legs_match_eager_and_a_second_generate_captures_nothing(arch, kv):
    """``generate`` and both legs' ``teacher_forced_logits`` captured against
    eager on the same parameters and prompts: identical tokens and logits
    (the recurrent models' graphs write each new state into the static
    cache, so every replay reads the last one's);
    a second ``generate`` of the same shape (another prompt, another prompt
    length in the bucket) adds no capture; the kernel launch counts of the
    captured calls (replays accounted) equal the eager calls'."""
    from repro_torch import kernels
    from repro_torch.launch import serve

    model, params = _reduced_packed(arch)
    gen = torch.Generator().manual_seed(22)
    seq = torch.randint(0, model.cfg.vocab_size, (2, 30), generator=gen).cuda()
    kvq = port_q.KVQuant(8, 16) if kv else None
    counts = {}
    for eager in (True, False):
        kernels.reset_launches()
        with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(kvq):
            tokens = serve.generate(model, params, seq[:, :20], gen=10, cache_len=30, eager=eager)
            legs = [serve.teacher_forced_logits(model, params, tokens, prompt_len=20, eager=eager)]
        legs.append(serve.teacher_forced_logits(model, params, tokens, prompt_len=20, eager=eager))
        torch.cuda.synchronize()
        counts[eager] = (kernels.launches(), kernels.v3_body_launches(),
                         kernels.v2_body_launches())
        if eager:
            want_tokens, want_legs = tokens, legs
    assert torch.equal(tokens, want_tokens)
    for got, want in zip(legs, want_legs):
        assert torch.equal(got, want)
    assert counts[False] == counts[True]
    captures = serve.TRACE_COUNTS["decode_step"]
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(kvq):
        again = serve.generate(model, params, seq[:, 3:21], gen=10, cache_len=28)
        want = serve.generate(model, params, seq[:, 3:21], gen=10, cache_len=28, eager=True)
    assert serve.TRACE_COUNTS["decode_step"] == captures
    assert torch.equal(again, want)


def _engines_both_ways(eng_kw, lens, shared):
    """Reduced smollm through the eager and the captured engine on one
    trace (6 requests, 8 new tokens, KV block 8): ``({eager: (report,
    engine, trace_counts after warmup)}, prompt lengths)``."""
    from repro_torch.launch.engine import PVQEngine, poisson_trace

    model, params = _reduced_packed("smollm-360m")
    runs = {}
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(port_q.KVQuant(8, 16)):
        for eager in (True, False):
            trace = poisson_trace(6, rate=0.0, vocab=model.cfg.vocab_size, prompt_lens=lens,
                                  max_new=8, seed=2, shared_prefix=shared)
            eng = PVQEngine(model, params, eager=eager, **eng_kw)
            eng.warmup([len(r.prompt) for r in trace])
            warm = dict(eng.trace_counts)
            runs[eager] = (eng.run(trace), eng, warm)
    return runs, [len(r.prompt) for r in trace]


def _assert_same_tokens_and_pages(runs):
    from repro_torch.launch.engine import _paged_leaves

    (want, eager_eng, _), (got, eng, _) = runs[True], runs[False]
    assert want["trace_counts"] == {"decode": 0, "prefill": 0, "graft": 0, "chunk": 0}
    assert got["outputs"] == want["outputs"]
    for a, b in zip(_paged_leaves(eager_eng.cache), _paged_leaves(eng.cache)):
        real = slice(0, a.trash_page)
        for name in ("k_pages", "k_page_scales", "v_pages", "v_page_scales"):
            assert torch.equal(getattr(a, name)[real], getattr(b, name)[real]), name
        assert torch.equal(a.tail_k, b.tail_k) and torch.equal(a.tail_v, b.tail_v)


@needs_cuda
def test_cuda_captured_engine_matches_eager_engine():
    """CI's chunked engine configuration on reduced smollm: the captured
    engine (its decode graphs and its chunk graph captured by ``warmup``,
    none in the run: the reference's ``trace_counts`` with two decode
    graphs) against the eager engine on the same trace: identical tokens
    and identical bytes in every real page and tail ring of every layer."""
    runs, _ = _engines_both_ways(dict(n_slots=2, max_len=96, prefill_chunk=2, prefill_batch=2),
                                 (12, 24), 64)
    got, _, warm = runs[False]
    want = {**chip_smoke().REFERENCE_TRACE_COUNTS["ci engine chunked"], "decode": 2}
    assert warm == want == {"decode": 2, "prefill": 0, "graft": 0, "chunk": 1}
    assert got["trace_counts"] == warm and got["chunks"] > 0 and got["prefix_hits"] > 0
    _assert_same_tokens_and_pages(runs)


# (engine arguments, prompt lengths, shared prefix, chip_smoke run name):
# CI's saturating smoke, and one that admits short prompts in batches of
# up to 2 rows (buckets 8 and 16) and streams the long ones in chunks
CAPTURED_ENGINE_CASES = {
    "ci_saturate": (dict(n_slots=3, max_len=24), (6, 12), 0, "ci engine saturate"),
    "batched_and_chunked": (dict(n_slots=3, max_len=40, prefill_chunk=2, prefill_batch=2),
                            (6, 30), 0, None),
}


@needs_cuda
@pytest.mark.parametrize("case", list(CAPTURED_ENGINE_CASES))
def test_cuda_captured_prefill_graft_and_chunk_match_eager_engine(case):
    """The warm-up captures one prefill and one graft graph a prompt bucket
    (at ``prefill_batch`` rows) and one chunk graph, the run none: the
    reference's ``trace_counts`` for the same flags with two decode graphs
    (CI's from ``REFERENCE_TRACE_COUNTS``); the replays give the eager
    engine's tokens and real pages."""
    eng_kw, lens, shared, run = CAPTURED_ENGINE_CASES[case]
    smoke = chip_smoke()
    runs, prompt_lens = _engines_both_ways(eng_kw, lens, shared)
    got, eng, warm = runs[False]
    want = smoke.reference_trace_counts(prompt_lens, eng.page, eng.chunk_tokens)
    if run is not None:
        assert want == smoke.REFERENCE_TRACE_COUNTS[run]
    assert warm == {**want, "decode": 2} and got["trace_counts"] == warm
    assert warm["prefill"] > 0 and got["prefill_batches"] > 0
    if eng.chunk_tokens:
        assert got["chunks"] > 0 and got["prefill_rows"] < 2 * got["prefill_batches"]
    _assert_same_tokens_and_pages(runs)


@needs_cuda
def test_cuda_failed_engine_capture_raises_and_does_not_fall_back(monkeypatch):
    """A chunk body that fails while it is being captured (its eager first
    run succeeds): ``warmup`` raises, no chunk graph is kept or counted, and
    the next chunk raises again instead of running eagerly."""
    from repro_torch.launch.engine import PVQEngine

    model, params = _reduced_packed("smollm-360m")
    body = PVQEngine._chunk_body

    def failing(self):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("injected capture failure")
        return body(self)

    monkeypatch.setattr(PVQEngine, "_chunk_body", failing)
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(port_q.KVQuant(8, 16)):
        eng = PVQEngine(model, params, n_slots=2, max_len=48, prefill_chunk=2)
        with pytest.raises(RuntimeError, match="injected capture failure"):
            eng.warmup([12])
        assert eng.trace_counts["chunk"] == 0
        assert not [key for key in eng._graphs if key[0] == "chunk"]
        with pytest.raises(RuntimeError, match="injected capture failure"):
            eng.warmup([12])


# ---------------------------------------------------------------------------
# the autotuner's choices on the card
# ---------------------------------------------------------------------------

# smollm-360m's decode and prefill GEMMs (k padded to the group) and
# deepseek-v2-lite-16b's up/gate bank (64 experts) at decode and prefill:
# (m, k, n, group, experts)
TUNE_SHAPES = [(4, 1024, 960, 256, None), (4, 1024, 2560, 256, None), (4, 2560, 960, 256, None),
               (512, 1024, 2560, 256, None), (1, 2048, 1408, 256, 64), (60, 2048, 1408, 256, 64)]


@contextlib.contextmanager
def _tune_cache(tmp_path, monkeypatch, entries=None):
    from repro_torch.kernels import autotune

    path = tmp_path / "tune.json"
    if entries is not None:
        path.write_text(json.dumps(entries))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(path))
    autotune.clear_memory_cache()
    try:
        yield path
    finally:
        autotune.clear_memory_cache()


def _matmul_operands(m, k, n, group, e, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if e is None else (e,)
    pulses = torch.randint(-9, 10, (*lead, k, n), generator=gen, device="cuda", dtype=torch.int8)
    scales = torch.rand((*lead, k // group, n), generator=gen, device="cuda") * 0.01
    x = torch.randn((*lead, m, k), generator=gen, device="cuda")
    x_q, a = port_q.quantize_activations(x, port_q.ActQuant())
    return x, x_q, a, pulses, scales


@needs_cuda
@pytest.mark.parametrize("m,k,n,group,e", TUNE_SHAPES)
def test_cuda_every_matmul_candidate_gives_the_rules_result(m, k, n, group, e):
    """Each candidate the autotuner may pick, forced: v3 bit for bit the
    rule's output, v2 the rule's values (max |diff| 0)."""
    from repro_torch.kernels import autotune

    x, x_q, a, pulses, scales = _matmul_operands(m, k, n, group, e, seed=m + n)
    if e is None:
        v3 = partial(port_mm.pvq_matmul_q_cuda, x_q, pulses, scales, a, None, group=group)
        v2 = partial(port_mm.pvq_matmul_cuda, x, pulses, scales, None, group=group)
    else:
        v3 = partial(port_mm.pvq_matmul_q_batched_cuda, x_q, pulses, scales, a, group=group)
        v2 = partial(port_mm.pvq_matmul_batched_cuda, x, pulses, scales, group=group)
    for dtype, fn in ((torch.int8, v3), (torch.float32, v2)):
        want = fn()
        cands = autotune.candidate_tiles(m, k, n, group, dtype, e)
        assert len(cands) >= 2
        for body, chunk in cands:
            got = fn(_body=body, _chunk=chunk or None)
            assert torch.equal(got, want), (dtype, body, chunk, float((got - want).abs().max()))


@needs_cuda
def test_cuda_tuned_entries_reach_the_launch(tmp_path, monkeypatch):
    """A cache entry's body and chunk are what ``ops`` launches (the splitk
    plan as the wrapper builds it), and a tuned v4 plan too; the outputs
    equal the rule's."""
    from repro_torch.kernels import autotune

    m, k, n, group = 4, 1024, 960, 256
    x, x_q, a, pulses, scales = _matmul_operands(m, k, n, group, None, seed=3)
    aq = port_q.ActQuant()
    want = ops.pvq_matmul(x, pulses, scales, group=group, act_quant=aq)
    assert port_mm._v3_decode_plan(1, m, k, n, group)[1] != 256
    name = torch.cuda.get_device_name(0).replace(" ", "_")
    key = autotune.cache_key(m, k, n, group, torch.int8, name)
    plans = []
    inner = port_mm._splitk_buffers

    def recorded(plan, *rest, **kw):
        plans.append(tuple(plan))
        return inner(plan, *rest, **kw)

    monkeypatch.setattr(port_mm, "_splitk_buffers", recorded)
    for entry, body, plan in (({"body": "splitk", "chunk": 256}, "splitk", (64, 256, 4)),
                              ({"body": "direct", "chunk": 0}, "direct", (0, 0, 0))):
        with _tune_cache(tmp_path, monkeypatch, {key: {**entry, "us": 1.0, "candidates": 6}}):
            before = dict(V3_BODY_LAUNCHES)
            plans.clear()
            got = ops.pvq_matmul(x, pulses, scales, group=group, act_quant=aq)
            assert _body_launches_since(before) == {b: int(b == body) for b in V3_BODY_LAUNCHES}
            assert plans == [plan]
            assert torch.equal(got, want)
    # kernel v4: a tuned (km, w) that is not the rule's
    args = _attn_case(2, 5, 3, 160, 64, 32, seed=4)
    rule = port_mm._v4_plan(3, 160, 64, 32)
    akey = autotune.attn_cache_key(3, 64, 160, 32, torch.int8, name)
    with _tune_cache(tmp_path, monkeypatch, {akey: {"km": 1, "w": 1, "us": 1.0,
                                                    "candidates": 6}}):
        assert autotune.get_attn_tiles(3, 64, 160, group=32) == (1, 1) != rule[:2]
    _attn_equal(port_mm.pvq_attn_q_cuda(*args, group=32, sm_scale=0.3, _plan=(1, 1, 2),
                                        _tuned=True),
                port_mm.pvq_attn_q_cuda(*args, group=32, sm_scale=0.3), "tuned (1, 1)")


@needs_cuda
def test_cuda_operands_that_do_not_fit_a_tuned_mma_entry_take_the_rule(tmp_path, monkeypatch):
    """Pulse rows off the 16-byte path (n 40) under an mma entry: the call
    runs the rule's body (direct) and gives the rule's result."""
    from repro_torch.kernels import autotune

    m, k, n, group = 16, 64, 40, 32
    x, x_q, a, pulses, scales = _matmul_operands(m, k, n, group, None, seed=5)
    name = torch.cuda.get_device_name(0).replace(" ", "_")
    entries = {autotune.cache_key(m, k, n, group, dt, name): {"body": "mma", "chunk": 0,
                                                               "us": 1.0, "candidates": 2}
               for dt in (torch.int8, torch.float32)}
    aq = port_q.ActQuant()
    with _tune_cache(tmp_path, monkeypatch, entries):
        before, before_v2 = dict(V3_BODY_LAUNCHES), dict(V2_BODY_LAUNCHES)
        got_q = ops.pvq_matmul(x, pulses, scales, group=group, act_quant=aq)
        got_f = ops.pvq_matmul(x, pulses, scales, group=group)
        assert autotune.tune_stats()["by_key"]  # both calls looked the entries up
    assert _body_launches_since(before) == {"splitk": 0, "direct": 1, "mma": 0}
    assert _v2_launches_since(before_v2) == {"direct": 1, "mma": 0, "splitk": 0}
    assert torch.equal(got_q, port_mm.pvq_matmul_q_plain(x_q, pulses, scales, a, group=group))
    _close(got_f, port_mm.pvq_matmul_plain(x, pulses, scales, group=group))


@needs_cuda
def test_cuda_autotune_persists_a_fitting_entry_and_a_second_call_hits(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune

    with _tune_cache(tmp_path, monkeypatch) as path:
        counts = (dict(LAUNCHES), dict(V3_BODY_LAUNCHES))
        ent = autotune.autotune(4, 1024, 960, group=256, dtype=torch.int8, reps=3)
        att = autotune.autotune_attn(3, 64, 160, group=32, reps=3, bh=20)
        enc = autotune.autotune_encode(1280, 32, 127, reps=3)
        # the timing launches are not counted
        assert (dict(LAUNCHES), dict(V3_BODY_LAUNCHES)) == counts
        cands = autotune.candidate_tiles(4, 1024, 960, 256, torch.int8)
        assert (ent["body"], ent["chunk"]) in cands and ent["candidates"] == len(cands)
        assert ent["us"] <= ent["rule_us"] and ent["rule"] == list(cands[0])
        assert (att["km"], att["w"]) in autotune.attn_candidates(3, 64, 160, 32)
        assert enc["delta_max"] in (32, 64)
        assert len(json.loads(path.read_text())) == 3
        monkeypatch.setattr(autotune, "_time_us", lambda *a, **k: pytest.fail("re-searched"))
        autotune.clear_memory_cache()
        assert autotune.autotune(4, 1024, 960, group=256, dtype=torch.int8) == ent
        assert autotune.get_tiles(4, 1024, 960, group=256, dtype=torch.int8, search=True) == \
            (ent["body"], ent["chunk"])
        assert autotune.get_attn_tiles(3, 64, 160, group=32, search=True) == (att["km"], att["w"])
        assert autotune.get_encode_params(1280, 32, 127, search=True) == enc["delta_max"]


def _artifact_trees(arch, n_over_k=2.0):
    """(model, packed params of seed 0 on the card) for a reduced ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.core.packed import quantize_params
    from repro_torch.launch.serve import serving_policy
    from repro_torch.nn.models import Model

    cfg = get_config(arch).reduced()
    model = Model(cfg)
    return model, quantize_params(model.init(0, device="cuda"), serving_policy(cfg, n_over_k))


@needs_cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_cuda_artifact_loads_onto_the_card_with_identical_leaves(tmp_path, arch):
    """A ``.pvqz`` written from packed parameters on the card loads back onto
    the card into a fresh-seed target: every packed leaf's pulses and scales
    and every raw leaf identical, on the card, pulses contiguous."""
    from repro_torch.checkpoint import load_pvqz, write_pvqz
    from repro_torch.core.packed import is_packed, sorted_leaves

    model, qparams = _artifact_trees(arch)
    write_pvqz(tmp_path / "m.pvqz", qparams)
    restored = load_pvqz(tmp_path / "m.pvqz", target=model.init(123, device="cuda"))
    want = dict(sorted_leaves(qparams))
    got = dict(sorted_leaves(restored))
    assert list(got) == list(want)
    for path, leaf in want.items():
        if is_packed(leaf):
            mine = got[path]
            assert mine.pulses.is_cuda and mine.pulses.is_contiguous()
            assert torch.equal(mine.pulses, leaf.pulses) and torch.equal(mine.scales, leaf.scales)
            assert (mine.group, mine.k, mine.shape, mine.dtype, mine.layout) == (
                leaf.group, leaf.k, leaf.shape, leaf.dtype, leaf.layout)
        else:
            assert got[path].is_cuda and got[path].dtype == leaf.dtype
            assert torch.equal(got[path], leaf)


@needs_cuda
def test_cuda_export_load_prefill_logits_bitwise(tmp_path):
    """``export --arch`` on the card (the encoder kernel packs), then
    ``load_pvqz`` onto the card: prefill logits through the kernels are
    bitwise equal to those of the in-memory packed tree of the same seed."""
    from repro_torch.checkpoint import load_pvqz
    from repro_torch.core.quantize import ActQuant, act_quant_scope
    from repro_torch.launch import export

    before = LAUNCHES["pvq_encode_batch"]
    report, rc = export.run(["--arch", "smollm-360m", "--reduced", "--n-over-k", "2.0",
                             "--out", str(tmp_path / "sm.pvqz")])
    assert rc == 0 and LAUNCHES["pvq_encode_batch"] > before
    model, qparams = _artifact_trees("smollm-360m")
    restored = load_pvqz(tmp_path / "sm.pvqz", target=model.init(123, device="cuda"))
    toks = (torch.arange(16, dtype=torch.int64, device="cuda").reshape(2, 8)
            % model.cfg.vocab_size)
    for aq in (None, ActQuant()):
        with act_quant_scope(aq):
            lm, _ = model.prefill(qparams, {"tokens": toks}, cache_len=8)
            la, _ = model.prefill(restored, {"tokens": toks}, cache_len=8)
        assert torch.equal(lm, la)


@needs_cuda
@pytest.mark.parametrize("group", [256, 128])
@pytest.mark.parametrize("net_id", ["A", "B", "C", "D"])
def test_cuda_paper_net_kernel_apply_matches_plain(net_id, group):
    """The §VII nets at published width: ``pvq_kernel_encode`` on the
    encoder kernel is identical to its plain version, and ``kernel_apply``
    at m 4 and 2048 through v3 (``ActQuant``, identical) and v2 (f32, within
    rtol 1e-5), the 10-column heads on the direct bodies."""
    from repro_torch.configs.paper_nets import PAPER_NETS
    from repro_torch.nn.sequential import SequentialNet

    net = SequentialNet(PAPER_NETS[net_id])
    params = net.init(0, device="cuda")
    before = LAUNCHES["pvq_encode_batch"]
    kp = net.pvq_kernel_encode(params, group=group)
    assert LAUNCHES["pvq_encode_batch"] > before
    with _plain_versions():
        kp_plain = net.pvq_kernel_encode(params, group=group)
    for name, sub in kp.items():
        assert torch.equal(sub["kernel"].pulses, kp_plain[name]["kernel"].pulses)
        assert torch.equal(sub["kernel"].scales, kp_plain[name]["kernel"].scales)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for m in (4, 2048):
        x = torch.randn(m, *net.cfg.input_shape, generator=gen, device="cuda")
        for aq in (None, port_q.ActQuant()):
            before_v3, before_v2 = dict(V3_BODY_LAUNCHES), dict(V2_BODY_LAUNCHES)
            got = net.kernel_apply(params, kp, x, group=group, act_quant=aq)
            bodies = (_body_launches_since(before_v3) if aq else _v2_launches_since(before_v2))
            assert bodies["direct"] == 1  # the 10-column head
            assert sum(bodies.values()) == len(kp)
            with _plain_versions():
                want = net.kernel_apply(params, kp, x, group=group, act_quant=aq)
            assert got.shape == (m, 10) and bool(torch.isfinite(got).all())
            if aq is None:
                _close(got, want)
            else:
                assert torch.equal(got, want)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_qat_ste_encoder_matches_plain(dtype):
    """``--pvq-qat``'s projection on the card: the STE over a stacked
    smollm-shaped leaf (2 x 960 x 320, group 256, K 256) and a reduced
    step's leaves launches the encoder and gives the plain version's
    values exactly, with the gradient straight through."""
    from repro_torch.launch.train import qat_projector

    gen = torch.Generator(device="cuda").manual_seed(4)
    params = {"seg": {"wk": {"kernel": (torch.randn(2, 960, 320, generator=gen, device="cuda")
                                        * 0.03).to(dtype)}},
              "norm": {"rms_scale": torch.ones(960, device="cuda", dtype=dtype)}}
    project = qat_projector(256)
    before = LAUNCHES["pvq_encode_batch"]
    got = project(params)
    assert LAUNCHES["pvq_encode_batch"] == before + 1
    with _plain_versions():
        want = project(params)
    assert LAUNCHES["pvq_encode_batch"] == before + 1
    assert got["norm"]["rms_scale"] is params["norm"]["rms_scale"]  # not projected
    assert got["seg"]["wk"]["kernel"].dtype == dtype
    assert torch.equal(got["seg"]["wk"]["kernel"], want["seg"]["wk"]["kernel"])
    w = params["seg"]["wk"]["kernel"].detach().requires_grad_(True)
    out = project({"seg": {"wk": {"kernel": w}}})["seg"]["wk"]["kernel"]
    (g,) = torch.autograd.grad(out.float().sum(), (w,))
    assert torch.equal(g, torch.ones_like(w))


@needs_cuda
def test_cuda_checkpoint_round_trip_of_device_tensors(tmp_path):
    """A ``(params, AdamWState)`` of device tensors (bf16 params, f32
    moments) and a packed leaf: saved asynchronously, restored onto the card
    bit for bit, the step a host int."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.packed import pack_matmul
    from repro_torch.optim import AdamW

    gen = torch.Generator(device="cuda").manual_seed(5)
    params = {"w": {"kernel": torch.randn(96, 64, generator=gen, device="cuda").bfloat16()},
              "ln": {"rms_scale": torch.ones(64, device="cuda", dtype=torch.bfloat16)},
              "pk": {"kernel": pack_matmul(torch.randn(300, 48, generator=gen, device="cuda"),
                                           group=256, k=256)}}
    opt = AdamW()
    dense = {k: v for k, v in params.items() if k != "pk"}
    grads = {k: {n: torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype)
                 for n, t in v.items()} for k, v in dense.items()}
    new, opt_state, _ = opt.update(grads, opt.init(dense), dense)
    state = (dict(new, pk=params["pk"]), opt_state)
    ck = Checkpointer(tmp_path)
    ck.save(4, state, block=False)
    ck.wait()
    zero = lambda t: torch.zeros_like(t)  # noqa: E731
    target = ({"w": {"kernel": zero(new["w"]["kernel"])},
               "ln": {"rms_scale": zero(new["ln"]["rms_scale"])}, "pk": params["pk"]},
              type(opt_state)(step=0, mu={k: {n: zero(t) for n, t in v.items()}
                                          for k, v in opt_state.mu.items()},
                              nu={k: {n: zero(t) for n, t in v.items()}
                                  for k, v in opt_state.nu.items()}))
    got, step = ck.restore(target)
    assert step == 4 and got[1].step == 1
    for key in ("w", "ln"):
        for name, t in state[0][key].items():
            r = got[0][key][name]
            assert r.device.type == "cuda" and r.dtype == t.dtype and torch.equal(r, t)
        for tree, want in ((got[1].mu, state[1].mu), (got[1].nu, state[1].nu)):
            for name, t in want[key].items():
                assert tree[key][name].device.type == "cuda" and torch.equal(tree[key][name], t)
    pk = got[0]["pk"]["kernel"]
    assert pk.pulses.device.type == "cuda"
    assert torch.equal(pk.pulses, params["pk"]["kernel"].pulses)
    assert torch.equal(pk.scales, params["pk"]["kernel"].scales)


@needs_cuda
def test_one_rank_nccl_mesh_train_step_is_launch_train_step(tmp_path):
    """``launch.steps.make_train_step`` on a world-size-1 NCCL group and
    ``make_debug_mesh(1, 1)`` (parameters, moments and batch as DTensors)
    gives ``launch.train``'s step, reduced smollm-360m on the card: loss,
    grad norm and params identical over two steps."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenLoader, TokenTask
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.sharding import distribute, full_tree

    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    optimizer = AdamW(lr=3e-3)
    state, step_fn = train.make_state_and_step(model, optimizer, seed=0, device="cuda")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        bundle = make_train_step(model, optimizer, mesh, ShapeConfig("t", "train", 16, 4), seed=0)
        loader = TokenLoader(TokenTask(cfg.vocab_size, seed=0), 4, 16, seed=0, device="cuda")
        params, opt, _ = bundle.distribute(state[0], state[1], loader.device_batch(0))
        for step in range(2):
            batch = loader.device_batch(step)
            state, want = step_fn(state, batch)
            laid = {k: distribute(v, bundle.in_shardings[2][k]) for k, v in batch.items()}
            params, opt, got = bundle.run(params, opt, laid)
            for k in ("loss", "grad_norm"):
                assert float(full_tree(got[k])) == float(want[k]), (step, k)
        for a, b in zip(tree_leaves(full_tree(params)), tree_leaves(state[0])):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
