"""The ``.pvqz`` artifact slice: the port against the JAX reference.

* ``codes``, ``enumeration`` and ``bitstream`` (numpy in both packages):
  every public function gives identical arrays, ints and bytes on the same
  seeded inputs, and the reference's property tests run on the port,
  each example also held identical to the reference.
* ``pulse_stream``, ``pulse_groups`` and ``packed_stats(entropy=True)``
  are identical on the reference's packed reduced smollm-360m and
  deepseek-v2-lite-16b converted into the port (``from_reference_params``).
* ``write_pvqz`` of the converted parameters writes the reference's file
  byte for byte, for ``auto`` and each forced codec; a file from either
  package loads into the other with identical pulses, scales and raw
  leaves (a bfloat16 leaf and a scalar included).
* CRC corruption, a failed write and a bad magic raise, as in
  ``tests/test_artifact.py``.
* The reference's CI gates in the port's form, on the CPU: reduced smollm
  export at N/K 2.0, ``serve --artifact --act-int8 --agreement-min 0.99``,
  prefill logits bit-exact against the in-memory ``quantize_params`` tree
  loaded into a fresh-seed target, reduced deepseek experts <= 2.5
  bits/weight; ``--pvq-sim``'s report equals the reference's on the same
  dense parameters.

Tolerances: none, every comparison is exact, except ``pvq_encode``'s
scales (``atol=1e-6``: rho is a float sum the port takes in a fixed
pairwise order and XLA in its own).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.checkpoint import artifact as ref_art
from repro.configs import get_config as ref_get_config
from repro.core import bitstream as ref_bs
from repro.core import codes as ref_codes
from repro.core import enumeration as ref_enum
from repro.core import packed as ref_packed
from repro.core import packing as ref_packing
from repro.core import pvq as ref_pvq
from repro.core import quantize as ref_q
from repro.nn.models import Model as RefModel
from repro_torch.checkpoint import artifact as port_art
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import bitstream as port_bs
from repro_torch.core import codes as port_codes
from repro_torch.core import enumeration as port_enum
from repro_torch.core import packed as port_packed
from repro_torch.core import pvq as port_pvq
from repro_torch.core import quantize as port_q
from repro_torch.launch import export as port_export
from repro_torch.launch import serve as port_serve
from repro_torch.nn.models import build_model

MODELS = ("smollm-360m", "deepseek-v2-lite-16b")
N_OVER_K = 2.0  # CI's artifact ratio


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


def _sparse_values(rng, n, density=0.25, lo=-130, hi=130):
    """Pulse-like test vector: mostly zeros, values spanning int8 overflow."""
    v = rng.integers(lo, hi + 1, size=n)
    return (v * (rng.random(n) < density)).astype(np.int64)


def _rand_rows(rng, g, n, k, clamp_hi=1):
    """Random pyramid rows with L1 <= k, all-zero rows among them."""
    rows = np.zeros((g, n), np.int64)
    for i in range(g):
        budget = int(rng.integers(0, k + 1))
        while budget > 0:
            m = int(rng.integers(1, min(budget, clamp_hi) + 1))
            rows[i, rng.integers(0, n)] += m * int(rng.choice([-1, 1]))
            budget -= m
    return rows


def _same(a, b):
    """Exact equality of nested results: arrays (dtype and shape too),
    bytes, numbers, dicts, lists, tuples and generators."""
    if inspect.isgenerator(a):
        a, b = list(a), list(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# codes, enumeration, bitstream: identical outputs on the same inputs
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_V = _sparse_values(_RNG, 700, density=0.3)
_V7 = _sparse_values(_RNG, 41 * 16, density=0.3, lo=-7, hi=7)
_ROWS = _rand_rows(_RNG, 30, 64, 51, clamp_hi=5)
_ROWS_SMALL = _rand_rows(_RNG, 12, 8, 4)
_GOLOMB = ref_codes.golomb_encode(_V)
_RLE = ref_codes.rle_encode(_V)
_GOLOMB_CH = ref_bs.golomb_encode_chunked(_V, 64)
_RLE_CH = ref_bs.rle_encode_chunked(_V, 64)
_ENUM = ref_bs.enum_encode_groups(_ROWS, 51)
_RANKS = ref_enum.vector_to_index_batch(_ROWS, 51)
_IDX = ref_enum.pack_indices(_ROWS_SMALL[np.abs(_ROWS_SMALL).sum(1) == 4])
_N_IDX = int((np.abs(_ROWS_SMALL).sum(1) == 4).sum())
_GROUPS7 = _V7.reshape(41, 16)
_CODES, _LENGTHS = ref_bs.golomb_lengths_codes(_V)

# (module, function, args): every public function of the three modules
CASES = [
    ("codes", "zigzag", (_V,)),
    ("codes", "unzigzag", (ref_codes.zigzag(_V),)),
    ("codes", "golomb_length", (_V,)),
    ("codes", "golomb_encode", (_V,)),
    ("codes", "golomb_decode", (_GOLOMB[0], _GOLOMB[1], _V.size)),
    ("codes", "rle_flat_pairs", (_V,)),
    ("codes", "rle_bits", (_V,)),
    ("codes", "rle_encode", (_V,)),
    ("codes", "rle_decode", (_RLE[0], _RLE[1], _RLE[2], _V.size)),
    ("codes", "huffman_escape_bits", (_V,)),
    ("codes", "pulse_histogram", (_V,)),
    ("codes", "compression_report", (_V7, 16, 8)),
    ("enumeration", "num_points", (64, 51)),
    ("enumeration", "index_bits", (256, 128)),
    ("enumeration", "vector_to_index", (_ROWS_SMALL[1].tolist(),)),
    ("enumeration", "index_to_vector", (1234, 8, 4)),
    ("enumeration", "enumerate_all", (3, 2)),
    ("enumeration", "pack_indices", (_ROWS_SMALL[np.abs(_ROWS_SMALL).sum(1) == 4],)),
    ("enumeration", "unpack_indices", (_IDX, _N_IDX, 8, 4)),
    ("enumeration", "limb_count", (64, 130)),
    ("enumeration", "enum_table_bytes", (64, 130)),
    ("enumeration", "enum_supported", (64, 130)),
    ("enumeration", "enum_tables", (16, 9)),
    ("enumeration", "vector_to_index_batch", (_ROWS, 51)),
    ("enumeration", "index_to_vector_batch", (_RANKS, np.abs(_ROWS).sum(1), 64, 51)),
    ("bitstream", "pack_bits", (_CODES, _LENGTHS)),
    ("bitstream", "golomb_lengths_codes", (_V,)),
    ("bitstream", "auto_chunk", (2_460_000,)),
    ("bitstream", "golomb_encode_chunked", (_V, 64)),
    ("bitstream", "golomb_decode_chunked", (_GOLOMB_CH[0], _GOLOMB_CH[1], _V.size, 64)),
    ("bitstream", "rle_encode_chunked", (_V, 64)),
    ("bitstream", "rle_decode_chunked", (_RLE_CH[0], _RLE_CH[1], _RLE_CH[3], _V.size, 64)),
    ("bitstream", "enum_sub_width", (256,)),
    ("bitstream", "enum_stream_bits", (_ROWS, 51)),
    ("bitstream", "enum_encode_groups", (_ROWS, 51)),
    ("bitstream", "enum_decode_groups", (_ENUM[0], 30, 64, 51)),
    ("bitstream", "encode_pulses", (_GROUPS7, "golomb")),
    ("bitstream", "decode_pulses", (*ref_bs.encode_pulses(_GROUPS7, "rle", chunk=100), 16)),
    ("bitstream", "measured_bits", (_V7,)),
    ("bitstream", "choose_codec", (_V7, _GROUPS7, 32)),
]
MODULES = {"codes": (ref_codes, port_codes), "enumeration": (ref_enum, port_enum),
           "bitstream": (ref_bs, port_bs)}


@pytest.mark.parametrize("mod,fn,args", CASES, ids=[f"{m}.{f}" for m, f, _ in CASES])
def test_codec_function_identical_to_reference(mod, fn, args):
    ref_mod, port_mod = MODULES[mod]
    _same(getattr(ref_mod, fn)(*args), getattr(port_mod, fn)(*args))


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_every_public_codec_function_is_ported_and_covered(mod):
    ref_mod, port_mod = MODULES[mod]
    public = {name for name, fn in vars(ref_mod).items()  # lru_cache'd ones too
              if callable(fn) and not isinstance(fn, type) and not name.startswith("_")
              and getattr(fn, "__module__", None) == ref_mod.__name__}
    assert all(callable(getattr(port_mod, name, None)) for name in public)
    assert public == {fn for m, fn, _ in CASES if m == mod}
    constants = {name for name in vars(ref_mod) if name.isupper() and not name.startswith("_")}
    for name in constants:
        assert getattr(port_mod, name) == getattr(ref_mod, name), name


@pytest.mark.parametrize("codec", ["golomb", "rle", "enum", "nibble", "int8"])
def test_encode_pulses_identical_for_every_codec(codec):
    want = ref_bs.encode_pulses(_GROUPS7, codec, k_max=64, chunk=100)
    got = port_bs.encode_pulses(_GROUPS7, codec, k_max=64, chunk=100)
    _same(want, got)
    _same(ref_bs.decode_pulses(*want, 16), port_bs.decode_pulses(*got, 16))
    np.testing.assert_array_equal(port_bs.decode_pulses(*got, 16), _GROUPS7)


def test_nibbles_identical_to_the_reference_packing():
    packed, shape = ref_packing.pack_nibbles(_V7)
    _same((packed, shape), port_bs.pack_nibbles(_V7))
    _same(ref_packing.unpack_nibbles(packed, shape), port_bs.unpack_nibbles(packed, shape))


def test_codec_errors_match_the_reference():
    with pytest.raises(ValueError, match="exceeds k_max"):
        port_bs.enum_encode_groups(np.asarray([[3, -3]]), 4)
    with pytest.raises(ValueError, match="nibble"):
        port_bs.encode_pulses(np.asarray([9]), "nibble")
    with pytest.raises(ValueError, match="unknown pulse codec"):
        port_bs.encode_pulses(np.asarray([1]), "zstd")


# --- the reference's property tests, each example held to the reference ---


@settings(max_examples=20, deadline=None)
@given(n=st.integers(0, 3000), chunk=st.integers(1, 600), seed=st.integers(0, 2**31 - 1))
def test_prop_golomb_chunked_roundtrip(n, chunk, seed):
    v = _sparse_values(np.random.default_rng(seed), n)
    got = port_bs.golomb_encode_chunked(v, chunk)
    _same(ref_bs.golomb_encode_chunked(v, chunk), got)
    blob, offsets, nbits, chunk = got
    assert nbits == (int(port_codes.golomb_length(v).sum()) if n else 0)
    np.testing.assert_array_equal(port_bs.golomb_decode_chunked(blob, offsets, n, chunk), v)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(0, 3000), chunk=st.integers(1, 600), seed=st.integers(0, 2**31 - 1))
def test_prop_rle_chunked_roundtrip(n, chunk, seed):
    v = _sparse_values(np.random.default_rng(seed), n, density=0.1)
    got = port_bs.rle_encode_chunked(v, chunk)
    _same(ref_bs.rle_encode_chunked(v, chunk), got)
    blob, offsets, nbits, n_pairs, chunk = got
    _, ref_bits, ref_pairs = port_codes.rle_encode(v)
    assert (nbits, n_pairs) == (ref_bits, ref_pairs)
    np.testing.assert_array_equal(port_bs.rle_decode_chunked(blob, offsets, n_pairs, n, chunk), v)


@settings(max_examples=15, deadline=None)
@given(g=st.integers(1, 8), n=st.integers(2, 24), k=st.integers(1, 12),
       seed=st.integers(0, 2**31 - 1))
def test_prop_enum_groups_roundtrip(g, n, k, seed):
    rows = _rand_rows(np.random.default_rng(seed), g, n, k)
    blob, total = port_bs.enum_encode_groups(rows, k)
    _same(ref_bs.enum_encode_groups(rows, k), (blob, total))
    assert total == port_bs.enum_stream_bits(rows, k)
    assert len(blob) == -(-total // 8)
    got = port_bs.enum_decode_groups(blob, g, n, k, sub=port_bs.enum_sub_width(n))
    np.testing.assert_array_equal(got, rows)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 12), k=st.integers(1, 12), seed=st.integers(0, 2**31 - 1))
def test_prop_enumeration_roundtrip_random_points(n, k, seed):
    idx = int(np.random.default_rng(seed).integers(0, min(port_enum.num_points(n, k), 2**62)))
    v = port_enum.index_to_vector(idx, n, k)
    assert v == ref_enum.index_to_vector(idx, n, k)
    assert sum(abs(x) for x in v) == k
    assert port_enum.vector_to_index(v) == idx == ref_enum.vector_to_index(v)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(2, 48), k=st.integers(1, 40), g=st.integers(1, 12),
       seed=st.integers(0, 2**31 - 1))
def test_prop_batch_roundtrip(n, k, g, seed):
    rows = _rand_rows(np.random.default_rng(seed), g, n, k, clamp_hi=min(k, 5))
    ranks = port_enum.vector_to_index_batch(rows, k)
    _same(ref_enum.vector_to_index_batch(rows, k), ranks)
    got = port_enum.index_to_vector_batch(ranks, np.abs(rows).sum(axis=1), n, k)
    np.testing.assert_array_equal(got, rows)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 300))
def test_prop_golomb_and_rle_roundtrip(seed, n):
    v = _sparse_values(np.random.default_rng(seed), n, density=0.3)
    blob, nbits = port_codes.golomb_encode(v)
    _same(ref_codes.golomb_encode(v), (blob, nbits))
    np.testing.assert_array_equal(port_codes.golomb_decode(blob, nbits, n), v)
    rle = port_codes.rle_encode(v)
    _same(ref_codes.rle_encode(v), rle)
    np.testing.assert_array_equal(port_codes.rle_decode(*rle, n), v)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_prop_nibble_roundtrip(seed):
    v = np.random.default_rng(seed).integers(-7, 8, size=(5, 13))
    packed, shape = port_bs.pack_nibbles(v)
    _same(ref_packing.pack_nibbles(v), (packed, shape))
    np.testing.assert_array_equal(port_bs.unpack_nibbles(packed, shape), v)


# ---------------------------------------------------------------------------
# PVQ codes and the dequantized simulation (--pvq-sim)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group,k,mode", [(16, 8, "paper"), (64, 32, "ls"), (256, 512, "ls")])
def test_pvq_encode_grouped_matches_reference(group, k, mode):
    w = np.random.default_rng(group + k).laplace(size=(3, 1000)).astype(np.float32)
    ref = ref_pvq.pvq_encode_grouped(jnp.asarray(w), group, k, mode)
    got = port_pvq.pvq_encode_grouped(torch.from_numpy(w), group, k, mode)
    np.testing.assert_array_equal(got.pulses.numpy(), np.asarray(ref.pulses))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale), atol=1e-6, rtol=0)
    assert got.k == ref.k
    np.testing.assert_allclose(port_pvq.pvq_decode_grouped(got, 1000).numpy(),
                               np.asarray(ref_pvq.pvq_decode_grouped(ref, 1000)), atol=1e-5)


def _to_numpy_tree(tree):
    if isinstance(tree, ref_packed.PackedPVQ):
        return {"pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
                "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
                "layout": tree.layout, "scale_mode": tree.scale_mode}
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _policy(mod, cfg):
    return mod.QuantPolicy(
        rules=(("embedding", cfg.pvq.n_over_k_embed, cfg.pvq.group),
               ("kernel|experts", N_OVER_K, cfg.pvq.group)),
        scale_mode="ls",
    )


def _sim_report(total_bits):
    return {k: round(v, 3) for k, v in total_bits.items() if "ratio" in k or "bits_per" in k}


def test_pvq_sim_report_matches_reference_on_the_same_dense_params():
    cfg = ref_get_config("smollm-360m").reduced()
    ref_params = RefModel(cfg).init(jax.random.PRNGKey(5))
    ref_deq, ref_codes_, ref_stats = ref_q.quantize_tree(ref_params, _policy(ref_q, cfg))
    port_deq, port_codes_, port_stats = port_q.quantize_tree(
        from_reference_params(_to_numpy_tree(ref_params)), _policy(port_q, cfg))
    assert list(port_codes_) == list(ref_codes_)
    for path, ref in ref_codes_.items():
        np.testing.assert_array_equal(port_codes_[path].pulses.numpy(), np.asarray(ref.pulses))
    for path, st_ in ref_stats.items():
        assert {k: v for k, v in port_stats[path].items() if k != "rel_err"} == {
            k: v for k, v in st_.items() if k != "rel_err"}
    assert _sim_report(port_q.total_bits(port_codes_)) == _sim_report(ref_q.total_bits(ref_codes_))
    assert port_q.total_bits(port_codes_, "rle") == ref_q.total_bits(ref_codes_, "rle")
    ref_rep = ref_q.tree_compression_report(ref_codes_)
    _same(ref_rep, port_q.tree_compression_report(port_codes_))
    # the dequantized tree the simulation serves
    flat = dict(port_packed.sorted_leaves(port_deq))
    for path, leaf in port_packed.sorted_leaves(_to_numpy_tree(ref_deq)):
        np.testing.assert_allclose(flat[path].float().numpy(), np.asarray(leaf, np.float32),
                                   atol=1e-6, rtol=0)


def test_serve_pvq_sim_on_cpu():
    report, rc = port_serve.run(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
                                 "8", "--gen", "4", "--pvq-sim", "--n-over-k", "2.0"])
    assert rc == 0
    assert report["pvq_mode"] == "dequant-sim"
    assert report["pvq_tensors"] > 0
    assert {"bits_per_weight", "vs_fp32_ratio", "vs_bf16_ratio"} <= set(report)
    assert report["generated_shape"] == [2, 12]


# ---------------------------------------------------------------------------
# pulse geometry, size reports and the file: converted reduced models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packed_models():
    """{arch: (reference packed params, port params converted from them)}
    at the serving policy, N/K 2.0."""
    out = {}
    for arch in MODELS:
        cfg = ref_get_config(arch).reduced()
        ref_params = RefModel(cfg).init(jax.random.PRNGKey(0))
        q = ref_packed.quantize_params(ref_params, _policy(ref_q, cfg))
        out[arch] = (q, from_reference_params(_to_numpy_tree(q)))
    return out


@pytest.mark.parametrize("arch", MODELS)
def test_pulse_stream_and_groups_identical(packed_models, arch):
    ref, port = packed_models[arch]
    ref_leaves, port_leaves = ref_packed.packed_leaves(ref), port_packed.packed_leaves(port)
    assert sorted(port_leaves) == sorted(ref_leaves)
    stacked = 0
    for path, want in ref_leaves.items():
        got = port_leaves[path]
        _same(ref_packed.pulse_stream(want), port_packed.pulse_stream(got))
        _same(ref_packed.pulse_groups(want), port_packed.pulse_groups(got))
        stacked += got.pulses.ndim > 2
    assert stacked  # layer stacks (and deepseek's expert axis) are covered


@pytest.mark.parametrize("arch", MODELS)
def test_packed_stats_entropy_identical(packed_models, arch):
    ref, port = packed_models[arch]
    want = ref_packed.packed_stats(ref)
    assert "entropy_bits_per_weight" in want
    _same(want, port_packed.packed_stats(port))
    _same(ref_packed.packed_stats(ref, entropy=False),
          port_packed.packed_stats(port, entropy=False))


@pytest.mark.parametrize("arch", MODELS)
def test_dequantize_params_identical(packed_models, arch):
    ref, port = packed_models[arch]
    flat = dict(port_packed.sorted_leaves(port_packed.dequantize_params(port)))
    for path, leaf in port_packed.sorted_leaves(_to_numpy_tree(ref_packed.dequantize_params(ref))):
        np.testing.assert_array_equal(flat[path].float().numpy(), np.asarray(leaf, np.float32))


@pytest.mark.parametrize("codec,chunk", [("auto", None), ("golomb", None), ("golomb", 100),
                                         ("rle", None), ("enum", None), ("int8", None),
                                         ("nibble", None)])
@pytest.mark.parametrize("arch", MODELS)
def test_write_pvqz_byte_identical(packed_models, tmp_path, arch, codec, chunk):
    ref, port = packed_models[arch]
    meta = {"kind": "arch", "arch": arch, "reduced": True, "n_over_k": N_OVER_K, "seed": 0}
    try:
        want = ref_art.write_pvqz(tmp_path / "ref.pvqz", ref, codec=codec, chunk=chunk, meta=meta)
    except ValueError as e:  # the nibble codec refuses |pulse| > 7, as the port must
        with pytest.raises(ValueError, match=str(e).split(" requires")[0]):
            port_art.write_pvqz(tmp_path / "port.pvqz", port, codec=codec, chunk=chunk, meta=meta)
        assert list(tmp_path.iterdir()) == []
        return
    got = port_art.write_pvqz(tmp_path / "port.pvqz", port, codec=codec, chunk=chunk, meta=meta)
    assert (tmp_path / "port.pvqz").read_bytes() == (tmp_path / "ref.pvqz").read_bytes()
    for rep in (want, got):
        rep.pop("path")
        for leaf in rep["leaves"].values():
            leaf.pop("encode_s", None)
            leaf.pop("encode_mb_s", None)
    _same(want, got)


def _assert_port_leaf_equal(got, want):
    """A port leaf against a reference one (PackedPVQ or array)."""
    if isinstance(want, ref_packed.PackedPVQ):
        assert port_packed.is_packed(got) and got.pulses.dtype == torch.int8
        np.testing.assert_array_equal(got.pulses.numpy(), np.asarray(want.pulses))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
        assert (got.group, got.k, got.shape, got.dtype, got.layout, got.scale_mode) == (
            want.group, want.k, tuple(want.shape), want.dtype, want.layout, want.scale_mode)
        assert got.pulses.is_contiguous()
    else:
        want = np.asarray(want)
        assert port_packed.dtype_name(got.dtype) == str(want.dtype)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("arch", MODELS)
def test_each_packages_file_loads_into_the_other(packed_models, tmp_path, arch, prefetch):
    ref, port = packed_models[arch]
    ref_art.write_pvqz(tmp_path / "ref.pvqz", ref)
    port_art.write_pvqz(tmp_path / "port.pvqz", port)
    is_packed = ref_packed.is_packed
    want = {ref_q._path_str(p): leaf  # the reference's flatten order: sorted keys
            for p, leaf in jax.tree_util.tree_leaves_with_path(ref, is_leaf=is_packed)}
    got = dict(port_art.iter_pvqz(tmp_path / "ref.pvqz", prefetch=prefetch, device="cpu"))
    assert list(got) == list(want)
    for path, leaf in want.items():
        _assert_port_leaf_equal(got[path], leaf)
    # the port's file into the reference, against the reference's own tree
    back = ref_art.load_pvqz(tmp_path / "port.pvqz", target=ref)
    for path, leaf in ref_packed.packed_leaves(ref).items():
        mine = ref_packed.packed_leaves(back)[path]
        np.testing.assert_array_equal(np.asarray(mine.pulses), np.asarray(leaf.pulses))
        np.testing.assert_array_equal(np.asarray(mine.scales), np.asarray(leaf.scales))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back, is_leaf=is_packed),
                                jax.tree_util.tree_leaves_with_path(ref, is_leaf=is_packed)):
        assert pa == pb
        if not is_packed(a):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# a mixed tree: every leaf kind, unsorted insertion order
# ---------------------------------------------------------------------------


def _ref_packed_of(pk):
    return ref_packed.PackedPVQ(
        pulses=jnp.asarray(pk.pulses.numpy()), scales=jnp.asarray(pk.scales.numpy()),
        group=pk.group, k=pk.k, shape=pk.shape, dtype=pk.dtype, layout=pk.layout,
        scale_mode=pk.scale_mode)


def _mixed_trees():
    rng = np.random.default_rng(11)
    lap = lambda *s: torch.from_numpy(rng.laplace(size=s).astype(np.float32) * 0.1)  # noqa: E731
    clamp = torch.full((256,), 0.01)
    clamp[3] = 10.0
    port = {
        "stack": {"kernel": port_packed.pack_matmul(lap(3, 64, 64), group=64, n_over_k=2.0)},
        "a": {"kernel": port_packed.pack_matmul(lap(100, 72), group=64, n_over_k=5.0)},
        "emb": {"embedding": port_packed.pack_flat(lap(64, 48), group=256, n_over_k=0.5,
                                                   row_align=48)},
        "clamp": {"kernel": port_packed.pack_flat(clamp, group=256, n_over_k=1.0)},
        "ln": torch.ones(64),
        "bf": torch.full((4, 4), 1.5, dtype=torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
    }
    assert int(port["clamp"]["kernel"].pulses.abs().max()) == 127  # K > 127 clamp
    ref = {key: ({k: _ref_packed_of(v) for k, v in sub.items()} if isinstance(sub, dict)
                 else jnp.asarray(sub.float().numpy()).astype(
                     jnp.bfloat16 if sub.dtype == torch.bfloat16 else sub.numpy().dtype))
           for key, sub in port.items()}
    return port, ref


def test_mixed_tree_byte_identical_and_restored_both_ways(tmp_path):
    port, ref = _mixed_trees()
    ref_art.write_pvqz(tmp_path / "ref.pvqz", ref, meta={"arch": "unit-test"})
    report = port_art.write_pvqz(tmp_path / "port.pvqz", port, meta={"arch": "unit-test"})
    assert (tmp_path / "port.pvqz").read_bytes() == (tmp_path / "ref.pvqz").read_bytes()
    assert report["bits_per_weight"] < 8.0
    toc = port_art.read_toc(tmp_path / "port.pvqz")
    assert [r["path"] for r in toc["leaves"]] == sorted(
        ["stack/kernel", "a/kernel", "emb/embedding", "clamp/kernel", "ln", "bf", "step"])
    bf = next(r for r in toc["leaves"] if r["path"] == "bf")
    assert (bf["dtype"], bf["stored_dtype"]) == ("bfloat16", "float32")
    assert next(r for r in toc["leaves"] if r["path"] == "stack/kernel")["stack"] == [3]
    got = port_art.load_pvqz(tmp_path / "ref.pvqz", target=port, device="cpu")
    assert list(got) == list(port)  # the target's structure and order
    for key, sub in ref.items():
        if isinstance(sub, dict):
            for k, leaf in sub.items():
                _assert_port_leaf_equal(got[key][k], leaf)
        else:
            _assert_port_leaf_equal(got[key], sub)
    assert got["bf"].dtype == torch.bfloat16 and got["step"].dtype == torch.int32
    back = ref_art.load_pvqz(tmp_path / "port.pvqz", target=ref)
    assert back["bf"].dtype == jnp.bfloat16 and int(back["step"]) == 7
    np.testing.assert_array_equal(np.asarray(back["stack"]["kernel"].pulses),
                                  port["stack"]["kernel"].pulses.numpy())
    nested = port_art.load_pvqz(tmp_path / "port.pvqz", device="cpu")
    assert nested["stack"]["kernel"].pulses.shape == (3, 64, 64)
    assert port_packed.is_packed(nested["a"]["kernel"]) and nested["ln"].dtype == torch.float32


def test_forced_enum_codec_on_small_groups(tmp_path):
    w = torch.from_numpy(np.random.default_rng(6).laplace(size=(40, 8)).astype(np.float32) * 0.1)
    tree = {"w": {"kernel": port_packed.pack_flat(w, group=8, n_over_k=2.0)}}
    report = port_art.write_pvqz(tmp_path / "e.pvqz", tree, codec="enum")
    assert report["leaves"]["w/kernel"]["codec"] == "enum"
    got = port_art.load_pvqz(tmp_path / "e.pvqz", target=tree, device="cpu")["w"]["kernel"]
    assert torch.equal(got.pulses, tree["w"]["kernel"].pulses)
    assert torch.equal(got.scales, tree["w"]["kernel"].scales)


def test_pvqz_crc_detects_corruption(tmp_path):
    w = torch.from_numpy(np.random.default_rng(9).laplace(size=(64, 32)).astype(np.float32) * 0.1)
    tree = {"w": {"kernel": port_packed.pack_matmul(w, group=64, n_over_k=4.0)}}
    path = tmp_path / "c.pvqz"
    port_art.write_pvqz(path, tree)
    raw = bytearray(path.read_bytes())
    raw[16] ^= 0xFF  # flip a pulse-stream byte
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        port_art.load_pvqz(path, target=tree, device="cpu")


def test_pvqz_failed_write_preserves_existing_artifact(tmp_path):
    clamp = torch.full((256,), 0.01)
    clamp[3] = 10.0
    pk = port_packed.pack_flat(clamp, group=256, n_over_k=1.0)
    assert int(pk.pulses.abs().max()) > 7  # the nibble codec will raise
    tree = {"w": {"kernel": pk}}
    path = tmp_path / "m.pvqz"
    port_art.write_pvqz(path, tree)
    good = path.read_bytes()
    with pytest.raises(ValueError, match="nibble"):
        port_art.write_pvqz(path, tree, codec="nibble")
    assert path.read_bytes() == good
    assert list(tmp_path.glob(".*tmp*")) == []  # a failed write leaves no tmp
    got = port_art.load_pvqz(path, target=tree, device="cpu")["w"]["kernel"]
    assert torch.equal(got.pulses, pk.pulses)


def test_pvqz_rejects_non_artifact(tmp_path):
    path = tmp_path / "junk.pvqz"
    path.write_bytes(b"definitely not a pvqz file")
    with pytest.raises(ValueError, match="magic"):
        port_art.read_toc(path)


# ---------------------------------------------------------------------------
# the reference's CI gates (ci.yml:34-77, 155-164) in the port's form
# ---------------------------------------------------------------------------


def test_ci_artifact_gates_on_cpu(tmp_path):
    """Reduced smollm exported at N/K 2.0; ``serve --artifact --act-int8
    --agreement-min 0.99`` passes and serves the tokens of the in-memory
    ``--pvq`` parameters; the loaded tree's prefill logits are bit-exact
    against ``quantize_params`` of the same init, loaded into a fresh-seed
    target."""
    path = str(tmp_path / "sm.pvqz")
    report, rc = port_export.run(["--arch", "smollm-360m", "--reduced", "--n-over-k", "2.0",
                                  "--out", path, "--device", "cpu"])
    assert rc == 0 and report["packed_numel"] > 0
    codecs = {v["codec"] for v in report["leaves"].values()}
    assert "enum" in codecs  # the auto rule's pick for most leaves
    flags = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4",
             "--act-int8", "--agreement-min", "0.99"]
    served, rc, art_state = port_serve.run(
        flags + ["--artifact", path, "--metrics-out", str(tmp_path / "obs-art")], return_state=True)
    assert rc == 0, served
    assert served["pvq_mode"] == "artifact" and served["artifact"] == path
    assert served["artifact_bytes"] == report["file_bytes"]
    assert served["artifact_meta"] == {"kind": "arch", "arch": "smollm-360m-smoke",
                                       "reduced": True, "n_over_k": 2.0, "seed": 0}
    assert served["pvq_tensors"] == len(report["leaves"]) - sum(
        v["codec"] == "raw" for v in report["leaves"].values())
    assert served["artifact_decode_s"] >= 0 and set(served["artifact_decode_mb_s"]) <= codecs
    assert (tmp_path / "obs-art" / "metrics.jsonl").read_text().count("artifact.cold_start_s")
    _, rc, mem_state = port_serve.run(flags + ["--pvq", "--n-over-k", "2.0"],
                                      return_state=True)
    assert rc == 0
    assert torch.equal(art_state["seq"], mem_state["seq"])
    assert torch.equal(art_state["logits_q"], mem_state["logits_q"])

    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    qparams = port_packed.quantize_params(model.init(0, device="cpu"),
                                          port_serve.serving_policy(cfg, 2.0))
    restored = port_art.load_pvqz(path, target=model.init(123, device="cpu"), device="cpu")
    mem_leaves = dict(port_packed.sorted_leaves(qparams))
    for key, leaf in port_packed.sorted_leaves(restored):
        want = mem_leaves[key]
        if port_packed.is_packed(want):
            assert torch.equal(leaf.pulses, want.pulses) and torch.equal(leaf.scales, want.scales)
        else:
            assert torch.equal(leaf, want)
    toks = torch.arange(16, dtype=torch.int64).reshape(2, 8) % cfg.vocab_size
    lm, _ = model.prefill(qparams, {"tokens": toks}, cache_len=8)
    la, _ = model.prefill(restored, {"tokens": toks}, cache_len=8)
    assert torch.equal(lm, la)


def test_ci_deepseek_expert_export_gate_on_cpu(tmp_path):
    report, rc = port_export.run(["--arch", "deepseek-v2-lite-16b", "--reduced", "--n-over-k",
                                  "2.0", "--out", str(tmp_path / "dsl.pvqz"),
                                  "--max-expert-bits-per-weight", "2.5", "--device", "cpu"])
    assert rc == 0, report.get("gate_fail")
    assert report["expert_leaves"] == 3 and report["expert_bits_per_weight"] <= 2.5
    report, rc = port_export.run(["--arch", "deepseek-v2-lite-16b", "--reduced", "--n-over-k",
                                  "2.0", "--out", str(tmp_path / "dsl.pvqz"),
                                  "--max-expert-bits-per-weight", "1.0", "--device", "cpu"])
    assert rc == 1 and "expert bits/weight" in report["gate_fail"]


def test_engine_serves_an_artifact_on_cpu(tmp_path):
    path = str(tmp_path / "sm.pvqz")
    assert port_export.run(["--reduced", "--n-over-k", "2.0", "--out", path,
                            "--device", "cpu"])[1] == 0
    flags = ["--reduced", "--device", "cpu", "--prompt-len", "12", "--gen", "4", "--engine",
             "--engine-slots", "2", "--requests", "3", "--rate", "0", "--act-int8", "--kv-pvq",
             "--kv-block", "8", "--kv-group", "16"]
    art, rc, art_state = port_serve.run(flags + ["--artifact", path], return_state=True)
    assert rc == 0 and art["pvq_mode"] == "artifact"
    _, rc, mem_state = port_serve.run(flags + ["--pvq", "--n-over-k", "2.0"],
                                      return_state=True)
    assert rc == 0 and art_state["outputs"] == mem_state["outputs"]


def test_cli_flags_follow_the_reference(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):  # --act-int8 needs --pvq or --artifact
        port_serve.run(["--reduced", "--device", "cpu", "--act-int8"])
    with pytest.raises(SystemExit):  # --arch and --paper-net exclude each other
        port_export.run(["--arch", "smollm-360m", "--paper-net", "A",
                         "--out", str(tmp_path / "x.pvqz"), "--device", "cpu"])
    # the card is the default: without one the entry points raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_export.run(["--reduced", "--out", str(tmp_path / "x.pvqz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_export.run(["--paper-net", "A", "--out", str(tmp_path / "x.pvqz")])
    assert list(tmp_path.iterdir()) == []
