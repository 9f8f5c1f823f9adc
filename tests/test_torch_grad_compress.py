"""PVQ gradient compression and ``packed_update`` in the port
(``repro_torch.optim.grad_compress``, ``repro_torch.core.packed``): the
reference's ``tests/test_grad_compress.py`` (without ``cross_pod_mean``, a
collective of the multi-device code) and ``tests/test_packed.py:265-300``
in the port's terms, then the port against the reference on the same numpy
inputs.

* ``compress_decompress``: pulses identical to the reference's (``ls``
  through the encoder's plain version, ``paper`` through the exact core
  encoder), so the decoded gradient within ``rtol=1e-6`` (rho's float
  sums); five error-feedback steps: decoded and EF state within
  ``rtol=1e-5, atol=1e-6 * max|want|`` (the residual is a difference of
  nearly equal numbers).
* ``wire_bytes``: equal.
* ``packed_update`` on matmul, stacked and flat leaves: pulses identical,
  scales within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as ref_packed
from repro.optim import grad_compress as ref_gc
from repro_torch.convert import from_reference_params
from repro_torch.core.packed import is_packed, pack_matmul, packed_update
from repro_torch.optim import AdamW
from repro_torch.optim.grad_compress import (
    CompressionConfig,
    compress_decompress,
    make_ef_compressor,
    wire_bytes,
)


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


def _laplace(seed, *shape):
    return np.random.default_rng(seed).laplace(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_grad_compress.py in the port's terms
# ---------------------------------------------------------------------------


def test_channel_preserves_direction_energy():
    cfg = CompressionConfig(group=256, n_over_k=2.0)
    g = torch.from_numpy(_laplace(0, 4096))
    q = compress_decompress(g, cfg)
    cos = torch.sum(g * q) / (torch.linalg.norm(g) * torch.linalg.norm(q))
    assert float(cos) > 0.85


def test_channel_exact_as_k_grows():
    g = torch.from_numpy(_laplace(1, 2048))
    errs = []
    for n_over_k in (8.0, 2.0, 0.25):
        q = compress_decompress(g, CompressionConfig(group=256, n_over_k=n_over_k))
        errs.append(float(torch.linalg.norm(q - g) / torch.linalg.norm(g)))
    assert errs == sorted(errs, reverse=True)
    assert errs[-1] < 0.08  # K = 4 * group -> a few % error


def test_small_leaves_pass_through():
    g = torch.ones(10)
    assert torch.equal(compress_decompress(g, CompressionConfig(min_size=1024)), torch.ones(10))


def test_error_feedback_unbiased_mean():
    """With EF the time-average of the decoded gradients approaches the true
    gradient (the compression error does not accumulate)."""
    cfg = CompressionConfig(group=128, n_over_k=8.0)  # aggressive compression
    init, apply = make_ef_compressor(cfg)
    g_true = {"w": torch.from_numpy(_laplace(2, 1024))}
    ef = init(g_true)
    acc = torch.zeros(1024)
    n = 120
    for _ in range(n):
        dec, ef = apply(g_true, ef)
        acc = acc + dec["w"]
    rel = float(torch.linalg.norm(acc / n - g_true["w"]) / torch.linalg.norm(g_true["w"]))
    assert rel < 0.05


def test_wire_bytes_ratio():
    cfg = CompressionConfig(group=256, n_over_k=2.0)
    grads = {"a": torch.zeros((1024, 64)), "b": torch.zeros(128)}
    comp, raw = wire_bytes(grads, cfg)
    assert raw == 4 * (1024 * 64 + 128)
    assert comp < 0.3 * raw  # the large leaf ~1.016 B a value, the small one raw


def test_compressed_training_converges():
    """AdamW on EF-compressed gradients reaches (near) the plain loss."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    y = x @ torch.from_numpy(_laplace(5, 32))

    def loss_fn(w):
        return torch.mean((x @ w - y) ** 2)

    def train(compressed: bool, steps=150):
        opt = AdamW(lr=3e-2, weight_decay=0.0)
        w = {"w": torch.zeros(32)}
        st = opt.init(w)
        init, apply = make_ef_compressor(CompressionConfig(group=32, n_over_k=2.0, min_size=16))
        ef = init(w)
        for _ in range(steps):
            wt = w["w"].detach().requires_grad_(True)
            g = {"w": torch.autograd.grad(loss_fn(wt), (wt,))[0]}
            if compressed:
                g, ef = apply(g, ef)
            w, st, _ = opt.update(g, st, w)
        return float(loss_fn(w["w"]))

    l_plain = train(False)
    l_comp = train(True)
    assert l_comp < 10 * max(l_plain, 1e-6) + 1e-3


# ---------------------------------------------------------------------------
# tests/test_packed.py:265-300 in the port's terms
# ---------------------------------------------------------------------------


def _packed_2d(seed=0, d_in=64, d_out=32, group=64, n_over_k=2.0):
    w = torch.from_numpy(_laplace(seed, d_in, d_out)) * 0.1
    return w, pack_matmul(w, group=group, n_over_k=n_over_k)


def test_grad_compress_passes_packed_leaves_through():
    cfg = CompressionConfig(group=64, n_over_k=2.0, min_size=16)
    _, pk = _packed_2d()
    g = {"dense": torch.from_numpy(_laplace(14, 1024)), "frozen": pk}
    assert compress_decompress(pk, cfg) is pk
    init, apply = make_ef_compressor(cfg)
    ef = init(g)
    dec, _ = apply(g, ef)
    assert dec["frozen"] is pk  # the packed leaf untouched
    assert dec["dense"].shape == (1024,)
    comp, raw = wire_bytes(g, cfg)
    assert raw == 4 * 1024  # the packed leaf never crosses the wire


def test_packed_update_reencodes_on_same_pyramid():
    _, pk = _packed_2d(n_over_k=1.0)
    delta = torch.from_numpy(np.random.default_rng(15).normal(size=(64, 32)).astype(
        np.float32)) * 0.01
    pk2 = packed_update(pk, delta)
    assert is_packed(pk2)
    assert (pk2.group, pk2.k, pk2.shape, pk2.layout) == (pk.group, pk.k, pk.shape, pk.layout)
    target = pk.dequantize() + delta
    rel = float(torch.linalg.norm(pk2.dequantize() - target) / torch.linalg.norm(target))
    assert rel < 0.45


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale_mode", ["ls", "paper"])
@pytest.mark.parametrize("group,n_over_k,n", [(256, 2.0, 4096), (128, 8.0, 1000),
                                               (256, 1.0, 70_000)])
def test_compress_decompress_matches_reference(group, n_over_k, n, scale_mode):
    cfg = dict(group=group, n_over_k=n_over_k, scale_mode=scale_mode)
    g = _laplace(20 + n, n) * 1e-3
    want = np.asarray(ref_gc.compress_decompress(jnp.asarray(g), ref_gc.CompressionConfig(**cfg)))
    got = compress_decompress(torch.from_numpy(g), CompressionConfig(**cfg)).numpy()
    # same pulses: the decoded values agree to rho's rounding, and their
    # zeros (no pulse) coincide
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_error_feedback_matches_reference():
    cfg = dict(group=128, n_over_k=4.0, min_size=64)
    ref_init, ref_apply = ref_gc.make_ef_compressor(ref_gc.CompressionConfig(**cfg))
    init, apply = make_ef_compressor(CompressionConfig(**cfg))
    grads = [{"w": _laplace(30 + i, 64, 40) * 0.01, "b": _laplace(40 + i, 16)} for i in range(5)]
    ref_ef = ref_init(jax.tree.map(jnp.asarray, grads[0]))
    ef = init({k: torch.from_numpy(v) for k, v in grads[0].items()})
    for g in grads:
        want_dec, ref_ef = ref_apply(jax.tree.map(jnp.asarray, g), ref_ef)
        dec, ef = apply({k: torch.from_numpy(v) for k, v in g.items()}, ef)
        for k in g:
            for got, want in ((dec[k], want_dec[k]), (ef[k], ref_ef[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-6 * float(np.abs(want).max()), err_msg=k)
        np.testing.assert_array_equal(dec["b"].numpy(), g["b"])  # below min_size: raw
    shapes = {"a": (1024, 64), "b": (128,), "c": (3, 1000)}
    c = ref_gc.CompressionConfig(**cfg)
    assert wire_bytes({k: torch.zeros(s) for k, s in shapes.items()}, CompressionConfig(**cfg)) \
        == ref_gc.wire_bytes({k: jnp.zeros(s) for k, s in shapes.items()}, c)


def _ref_dict(pk):
    return {"pulses": np.asarray(pk.pulses), "scales": np.asarray(pk.scales), "group": pk.group,
            "k": pk.k, "shape": pk.shape, "dtype": pk.dtype, "layout": pk.layout,
            "scale_mode": pk.scale_mode}


@pytest.mark.parametrize("kind", ["matmul", "stacked", "flat"])
def test_packed_update_matches_reference(kind):
    rng = np.random.default_rng(50)
    if kind == "flat":
        w = rng.normal(size=(64, 48)).astype(np.float32) * 0.02
        ref_pk = ref_packed.pack_flat(jnp.asarray(w), group=256, n_over_k=0.5, row_align=48)
    else:
        shape = (100, 72) if kind == "matmul" else (3, 96, 40)
        w = rng.laplace(size=shape).astype(np.float32) * 0.1
        ref_pk = ref_packed.pack_matmul(jnp.asarray(w), group=64, n_over_k=1.0)
    delta = rng.normal(size=w.shape).astype(np.float32) * 0.01
    want = ref_packed.packed_update(ref_pk, jnp.asarray(delta))
    pk = from_reference_params(_ref_dict(ref_pk))
    got = packed_update(pk, torch.from_numpy(delta))
    assert (got.group, got.k, got.shape, got.dtype, got.layout, got.scale_mode) == (
        want.group, want.k, tuple(want.shape), want.dtype, want.layout, want.scale_mode)
    np.testing.assert_array_equal(got.pulses.numpy(), np.asarray(want.pulses))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=1e-6, atol=0)
    assert not torch.equal(got.pulses, pk.pulses)  # the update moved the code
