"""Packed weights and the packed KV cache: the port against the JAX reference.

The reference's reduced smollm parameters (JAX init) go through numpy into
the port (``repro_torch.convert``), then both packages pack them with the
serving policy.  Pulses must be identical and scales identical up to
``atol=1e-6`` (rho is ``<w, p> / ||p||^2``, a float sum the port takes in a
fixed pairwise order and XLA in its own); dense views ``atol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.nn.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))


def to_numpy_tree(tree):
    """Reference pytree -> nested dicts of numpy (PackedPVQ -> dict)."""
    if isinstance(tree, ref_packed.PackedPVQ):
        return {
            "pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
            "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
            "layout": tree.layout, "scale_mode": tree.scale_mode,
        }
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _policy(mod, cfg):
    return mod.QuantPolicy(
        rules=(("embedding", cfg.pvq.n_over_k_embed, cfg.pvq.group),
               ("kernel|experts", 1.0, cfg.pvq.group)),
        scale_mode="ls",
    )


@pytest.fixture(scope="module")
def packed_pair():
    cfg = ref_get_config("smollm-360m").reduced()
    ref_params = RefModel(cfg).init(jax.random.PRNGKey(3))
    ref_q_params = ref_packed.quantize_params(ref_params, _policy(ref_q, cfg))
    port_params = from_reference_params(to_numpy_tree(ref_params))
    port_q_params = port_packed.quantize_params(port_params, _policy(port_q, get_config("smollm-360m").reduced()))
    return ref_q_params, port_q_params


def test_quantize_params_packs_the_same_leaves(packed_pair):
    ref_q_params, port_q_params = packed_pair
    ref_leaves = ref_packed.packed_leaves(ref_q_params)
    port_leaves = port_packed.packed_leaves(port_q_params)
    assert sorted(port_leaves) == sorted(ref_leaves)
    for path, ref in ref_leaves.items():
        port = port_leaves[path]
        assert (port.group, port.k, port.shape, port.dtype, port.layout) == (
            ref.group, ref.k, tuple(ref.shape), ref.dtype, ref.layout
        ), path


@pytest.mark.parametrize(
    "path",
    [
        "embed/embedding",  # flat layout, group 64, K 128 > 127: clamp + refit
        "segments/seg0/b0/mixer/wq/kernel",  # matmul layout, group 64, stacked
        "segments/seg0/b0/mixer/wk/kernel",
        "segments/seg0/b0/ffn/wi_gate/kernel",
        "segments/seg0/b0/ffn/wo/kernel",  # d_in 96: group 32
    ],
)
def test_quantize_params_pulses_and_scales(packed_pair, path):
    ref = ref_packed.packed_leaves(packed_pair[0])[path]
    port = port_packed.packed_leaves(packed_pair[1])[path]
    np.testing.assert_array_equal(port.pulses.numpy(), np.asarray(ref.pulses))
    np.testing.assert_allclose(port.scales.numpy(), np.asarray(ref.scales), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        port.dequantize(torch.float32).numpy(), np.asarray(ref.dequantize(jnp.float32)), atol=1e-5
    )


def test_packed_stats_bytes_match(packed_pair):
    ref = ref_packed.packed_stats(packed_pair[0], entropy=False)
    port = port_packed.packed_stats(packed_pair[1])
    for key in ("packed_tensors", "packed_bytes", "replaced_dense_bytes", "untouched_bytes"):
        assert port[key] == ref[key], key


def _kv_inputs(seed, b=2, s=21, n_kv=2, hd=16):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, n_kv, hd)).astype(np.float32)
    return k, v


@pytest.mark.parametrize("block,group", [(8, 16), (8, 8)])
def test_packed_kv_from_dense_matches(block, group):
    k, v = _kv_inputs(block + group)
    ref = ref_packed.PackedKV.from_dense(
        jnp.asarray(k), jnp.asarray(v), kvq=ref_q.KVQuant(block=block, group=group)
    )
    port = port_packed.PackedKV.from_dense(
        torch.from_numpy(k), torch.from_numpy(v), kvq=port_q.KVQuant(block=block, group=group)
    )
    for name in ("k_pulses", "v_pulses", "tail_k", "tail_v"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-6)
    kd, vd = port.dense_kv(21)
    kr, vr = ref.dense_kv(21)
    np.testing.assert_allclose(kd.numpy(), np.asarray(kr), atol=1e-5)
    np.testing.assert_allclose(vd.numpy(), np.asarray(vr), atol=1e-5)


def test_packed_kv_append_across_block_boundary():
    """Appends at positions 21..25 cross the block boundary at 24: the ring
    is encoded into the planes there, then refilled from slot 0."""
    k, v = _kv_inputs(7, s=21)
    kvq_r, kvq_p = ref_q.KVQuant(block=8, group=16), port_q.KVQuant(block=8, group=16)
    ref = ref_packed.PackedKV.from_dense(jnp.asarray(k), jnp.asarray(v), kvq=kvq_r)
    port = port_packed.PackedKV.from_dense(torch.from_numpy(k), torch.from_numpy(v), kvq=kvq_p)
    pad = 11  # serve pads the planes out to the cache length
    ref = ref_packed.PackedKV(
        **{n: jnp.pad(getattr(ref, n), ((0, 0), (0, pad), (0, 0), (0, 0)))
           for n in ("k_pulses", "k_scales", "v_pulses", "v_scales")},
        tail_k=ref.tail_k, tail_v=ref.tail_v, block=ref.block, group=ref.group, k=ref.k,
        dtype=ref.dtype,
    )
    port = port.pad_seq(pad)
    rng = np.random.default_rng(8)
    for pos in range(21, 26):
        kn = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
        vn = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
        ref = ref.append(jnp.asarray(kn), jnp.asarray(vn), jnp.int32(pos))
        port.append(torch.from_numpy(kn), torch.from_numpy(vn), pos)
    np.testing.assert_array_equal(port.k_pulses.numpy(), np.asarray(ref.k_pulses))
    np.testing.assert_array_equal(port.v_pulses.numpy(), np.asarray(ref.v_pulses))
    np.testing.assert_allclose(port.v_scales.numpy(), np.asarray(ref.v_scales), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.tail_k.numpy(), np.asarray(ref.tail_k))
    assert (port.k_pulses[:, 16:24] != 0).any()  # the block at 16..23 was encoded
    kd, vd = port.dense_kv(26)
    kr, vr = ref.dense_kv(26)
    np.testing.assert_allclose(kd.numpy()[:, :26], np.asarray(kr)[:, :26], atol=1e-5)
    np.testing.assert_allclose(vd.numpy()[:, :26], np.asarray(vr)[:, :26], atol=1e-5)


def test_packed_kv_byte_accounting():
    port = port_packed.PackedKV.init(1, 40, 5, 64, kvq=port_q.KVQuant(), dtype=torch.float32,
                                     device="cpu")
    ref = ref_packed.PackedKV.init(1, 40, 5, 64, kvq=ref_q.KVQuant(), dtype=jnp.float32)
    assert port.max_len == ref.max_len == 64
    assert port.packed_bytes_per_token == ref.packed_bytes_per_token
    assert port.dense_bytes_per_token == ref.dense_bytes_per_token
