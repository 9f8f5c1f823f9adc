"""The port's ``Checkpointer`` (``repro_torch.checkpoint.checkpointer``):
the reference's ``tests/test_checkpoint.py`` in the port's terms, then the
two packages against each other.

* Round trips: raw leaves bit-exact; ``PackedPVQ`` leaves restore their
  identical pulses and scales under every codec (``pvq-packed`` nibble and
  int8, ``pvq-golomb``); ``compress='pvq'`` is lossy on dense matrices only
  (relative error < 0.35 at N/K 1 on Laplacian weights, as the reference
  test gates).
* A ``(params, AdamWState)`` state converted from the reference's
  (``convert``), bf16 leaves, packed leaves and the 0-d step counter
  included: the port writes the reference's directory file for file and
  byte for byte, ``COMMIT``'s timestamp aside, under ``compress=None``
  with either packed codec.  Under ``compress='pvq'`` the two packages'
  core encoders give identical pulses and scales within 1e-6 relative (a
  float sum in another order), so every other file is byte-identical.
* Each package restores the other's checkpoint to identical leaves.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.nn.models import build_model as ref_build_model
from repro.optim import AdamW as RefAdamW
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import from_reference_opt_state, from_reference_params
from repro_torch.core.packed import is_packed, pack_flat, pack_matmul
from repro_torch.optim.adamw import AdamWState


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


def _laplace(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).laplace(size=shape).astype(np.float32))


def _state(seed=0):
    return {
        "params": {"w": _laplace(seed, 64, 128), "scale": torch.ones(128)},
        "opt": {"mu": torch.from_numpy(np.random.default_rng(seed + 100).normal(
            size=(64, 128)).astype(np.float32)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py in the port's terms
# ---------------------------------------------------------------------------


def test_roundtrip_exact(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state()
    ck.save(10, state)
    restored, step = ck.restore(_zeros_like(state))
    assert step == 10
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_async_save_then_restore(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state(1)
    ck.save(5, state, block=False)
    ck.wait()
    _, step = ck.restore(state)
    assert step == 5


def test_keep_last_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = _state(2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.all_steps() == [3, 4]


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _state(3))
    # a crash mid-write: a step directory without COMMIT
    broken = tmp_path / "step_000000099"
    broken.mkdir()
    (broken / "manifest.json").write_text(json.dumps({"step": 99, "leaves": {}}))
    assert ck.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(_state(3))


def test_pvq_compressed_checkpoint(tmp_path):
    ck = Checkpointer(tmp_path, compress="pvq", pvq_n_over_k=1.0, pvq_group=256,
                      min_compress_size=1024)
    state = {"params": {"w": _laplace(4, 128, 64)}}
    ck.save(1, state)
    restored, _ = ck.restore(state)
    w0, w1 = state["params"]["w"].numpy(), restored["params"]["w"].numpy()
    rel = np.linalg.norm(w1 - w0) / np.linalg.norm(w0)
    assert rel < 0.35  # lossy but close at N/K 1
    man = json.loads((tmp_path / "step_000000001" / "manifest.json").read_text())
    assert man["leaves"]["params/w"]["codec"] == "pvq"
    pulses_file = tmp_path / "step_000000001" / "params__w.pulses.npy"
    assert pulses_file.stat().st_size < 128 * 64 * 4 / 2  # < fp32/2


@pytest.mark.parametrize("packed_codec", ["packed", "golomb"])
def test_packed_leaf_roundtrip_bit_exact(tmp_path, packed_codec):
    """A PackedPVQ leaf restores to identical int8 pulses and f32 scales,
    with no re-encode, under any compress mode and either codec."""
    pk = pack_matmul(_laplace(6, 100, 72) * 0.1, group=64, n_over_k=4.0)  # nibble-packable
    pe = pack_flat(torch.from_numpy(np.random.default_rng(7).normal(
        size=(64, 32)).astype(np.float32)) * 0.02, group=32, n_over_k=0.5, row_align=32)
    state = {"params": {"w": {"kernel": pk}, "emb": {"embedding": pe}},
             "step": torch.tensor(3, dtype=torch.int32)}
    for compress in (None, "pvq"):
        d = tmp_path / str(compress)
        ck = Checkpointer(d, compress=compress, packed_codec=packed_codec)
        ck.save(1, state)
        restored, _ = ck.restore(state)
        for got, want in ((restored["params"]["w"]["kernel"], pk),
                          (restored["params"]["emb"]["embedding"], pe)):
            assert is_packed(got)
            assert got.pulses.dtype == torch.int8
            assert torch.equal(got.pulses, want.pulses)
            assert torch.equal(got.scales, want.scales)
            assert (got.group, got.k, got.shape, got.dtype, got.layout, got.scale_mode) == (
                want.group, want.k, want.shape, want.dtype, want.layout, want.scale_mode)
        # stored as the code, not expanded weights
        man = json.loads((d / "step_000000001" / "manifest.json").read_text())
        entry = man["leaves"]["params/w/kernel"]
        if packed_codec == "golomb":
            assert entry["codec"] == "pvq-golomb"
        else:
            assert (entry["codec"], entry["pulse_format"]) == ("pvq-packed", "nibble")
    with pytest.raises(ValueError, match="packed_codec"):
        Checkpointer(tmp_path / "bad", packed_codec="zip")


def test_pvq_checkpoint_skips_small_and_nonmatrix(tmp_path):
    ck = Checkpointer(tmp_path, compress="pvq", min_compress_size=10**6)
    state = _state(5)
    ck.save(2, state)
    man = json.loads((tmp_path / "step_000000002" / "manifest.json").read_text())
    assert all(e["codec"] == "raw" for e in man["leaves"].values())
    restored, _ = ck.restore(state)
    assert torch.equal(state["params"]["w"], restored["params"]["w"])


# ---------------------------------------------------------------------------
# the two packages: one directory, restored both ways
# ---------------------------------------------------------------------------


def _ref_pk_dict(pk):
    return {"pulses": np.asarray(pk.pulses), "scales": np.asarray(pk.scales), "group": pk.group,
            "k": pk.k, "shape": pk.shape, "dtype": pk.dtype, "layout": pk.layout,
            "scale_mode": pk.scale_mode}


def _ref_to_numpy(tree):
    if ref_packed.is_packed(tree):
        return _ref_pk_dict(tree)
    if isinstance(tree, dict):
        return {k: _ref_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ref_train_state():
    """The reference's ``(params, AdamWState)`` of a reduced smollm-360m in
    bf16 after one AdamW update (moments non-zero, step 1), with packed
    leaves beside the dense ones: a nibble matmul leaf, an int8 one (K 256,
    clamped) and a flat embedding."""
    import dataclasses

    cfg = dataclasses.replace(ref_get_config("smollm-360m").reduced(), param_dtype="bfloat16")
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0), max_seq=16)
    opt = RefAdamW(lr=1e-3)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    grads = jax.tree.map(lambda p: jax.random.laplace(next(keys), p.shape).astype(p.dtype),
                         params)
    params, opt_state, _ = opt.update(grads, opt.init(params), params)
    w = jax.random.laplace(jax.random.PRNGKey(2), (100, 72)) * 0.1
    params = dict(params, packed={
        "nib": {"kernel": ref_packed.pack_matmul(w, group=64, n_over_k=4.0)},
        "i8": {"kernel": ref_packed.pack_matmul(w, group=256, k=256)},
        "emb": {"embedding": ref_packed.pack_flat(w[:64, :64], group=32, n_over_k=0.5,
                                                  row_align=64)},
    })
    return params, opt_state


def _port_state(ref_state):
    params, opt_state = ref_state
    return (from_reference_params(_ref_to_numpy(params)),
            from_reference_opt_state(jax.tree.map(np.asarray, opt_state)))


def _dir_files(d):
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("compress,packed_codec",
                         [(None, "packed"), (None, "golomb"), ("pvq", "packed")])
def test_port_writes_the_reference_directory(tmp_path, ref_train_state, compress, packed_codec):
    kw = dict(compress=compress, packed_codec=packed_codec, min_compress_size=1024)
    RefCheckpointer(tmp_path / "ref", **kw).save(12, ref_train_state)
    state = _port_state(ref_train_state)
    assert isinstance(state[1], AdamWState) and state[1].step == 1
    Checkpointer(tmp_path / "port", **kw).save(12, state)
    ref_dir, port_dir = tmp_path / "ref" / "step_000000012", tmp_path / "port" / "step_000000012"
    assert _dir_files(port_dir) == _dir_files(ref_dir)
    man = json.loads((port_dir / "manifest.json").read_text())
    keys = list(man["leaves"])
    assert keys[0] == "0/embed/embedding" and "1/.step" in keys
    assert keys.index("1/.step") < keys.index("1/.mu/embed/embedding") < keys.index(
        "1/.nu/embed/embedding")
    assert man["leaves"]["1/.step"] == {"shape": [], "dtype": "int32", "codec": "raw"}
    emb = man["leaves"]["0/embed/embedding"]
    assert emb["dtype"] == "bfloat16"
    assert emb.get("stored_dtype") == (None if compress == "pvq" else "float32")
    pvq_scales = {k.replace("/", "__") + ".scales.npy" for k, e in man["leaves"].items()
                  if e["codec"] == "pvq"}
    assert bool(pvq_scales) == (compress == "pvq")
    for name in _dir_files(ref_dir):
        if name == "COMMIT":
            continue
        a, b = (port_dir / name).read_bytes(), (ref_dir / name).read_bytes()
        if name in pvq_scales:
            assert len(a) == len(b)
            np.testing.assert_allclose(np.load(port_dir / name), np.load(ref_dir / name),
                                       rtol=1e-6, atol=0, err_msg=name)
        else:
            assert a == b, name


def test_each_package_restores_the_others_checkpoint(tmp_path, ref_train_state):
    state = _port_state(ref_train_state)
    RefCheckpointer(tmp_path / "ref").save(3, ref_train_state)
    Checkpointer(tmp_path / "port").save(3, state)

    # the reference's directory into a zeroed port state
    def zeroed(tree):
        if isinstance(tree, dict):
            return {k: zeroed(v) for k, v in tree.items()}
        return tree if is_packed(tree) else torch.zeros_like(tree)

    target = (zeroed(state[0]), AdamWState(step=0, mu=zeroed(state[1].mu),
                                           nu=zeroed(state[1].nu)))
    got, step = Checkpointer(tmp_path / "ref").restore(target)
    assert step == 3 and got[1].step == 1 and isinstance(got[1].step, int)
    from repro_torch.checkpoint.checkpointer import _flatten

    want_flat, got_flat = _flatten(state), _flatten(got)
    assert list(got_flat) == list(want_flat)
    for key, want in want_flat.items():
        have = got_flat[key]
        if is_packed(want):
            assert torch.equal(have.pulses, want.pulses) and torch.equal(have.scales,
                                                                        want.scales)
        elif isinstance(want, int):
            assert have == want
        else:
            assert have.dtype == want.dtype and torch.equal(have, want), key

    # the port's directory into the reference's own structure
    back, step = RefCheckpointer(tmp_path / "port").restore(ref_train_state)
    assert step == 3
    is_pk = ref_packed.is_packed
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back, is_leaf=is_pk),
                                jax.tree_util.tree_leaves_with_path(ref_train_state,
                                                                    is_leaf=is_pk)):
        assert pa == pb
        if is_pk(b):
            np.testing.assert_array_equal(np.asarray(a.pulses), np.asarray(b.pulses))
            np.testing.assert_array_equal(np.asarray(a.scales), np.asarray(b.scales))
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
