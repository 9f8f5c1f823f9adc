"""The port's autotuner (``repro_torch.kernels.autotune``) on the CPU,
mirroring ``tests/test_autotune.py``: key format, kernel-version
invalidation, the persistent cache and its memory mirror, cache hits that
never search, the stats and telemetry names, the rules as the heuristics,
the candidate lists, the encoder's ``delta_max`` floor, no search during a
capture, a tuned ``delta_max`` against the reference's encoder, and
``serve --tune`` against the reference's ``--tune``.

On the CPU a search times one candidate, the rule's, through the plain
version; the card's search over every candidate is in
``tests/test_torch_cuda.py``.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, ops
from repro_torch.kernels import pvq_encode as port_enc
from repro_torch.kernels import pvq_matmul as port_mm
from repro_torch.launch import serve as port_serve
from repro_torch.runtime import obs


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """Point both packages' caches at fresh files, reset the mirror and stats."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "ref_tune.json"))
    monkeypatch.delenv("REPRO_TORCH_PVQ_AUTOTUNE", raising=False)
    autotune.clear_memory_cache()
    autotune.reset_tune_stats()
    yield path
    autotune.clear_memory_cache()
    autotune.reset_tune_stats()


@pytest.fixture
def enabled_registry():
    prev = obs.set_enabled(True)
    obs.registry().clear()
    yield obs.registry()
    obs.set_enabled(prev)
    obs.registry().clear()


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def test_cache_key_format_dtype_split_and_expert_suffix(monkeypatch):
    kv, schema = port_mm.KERNEL_VERSION, autotune._SCHEMA
    assert autotune.cache_key(4, 1024, 960, 256, torch.int8, "cpu") == \
        f"4x1024x960:g256:int8:cpu:kv{kv}:{schema}"
    k_f32 = autotune.cache_key(4, 1024, 960, 256, torch.float32, "cpu")
    assert k_f32 == f"4x1024x960:g256:float32:cpu:kv{kv}:{schema}"
    assert autotune.cache_key(1, 2048, 1408, 256, torch.int8, "cpu", e=64) == \
        f"1x2048x1408:g256:int8:cpu:kv{kv}:{schema}:e64"
    assert autotune.attn_cache_key(3, 64, 160, 32, torch.int8, "cpu") == \
        f"attn3x64x160:g32:int8:cpu:kv{kv}:{schema}"
    assert autotune.encode_cache_key(40320, 256, 256, torch.float32, "cpu") == \
        f"enc40320x256:k256:float32:cpu:ekv{port_enc.ENCODE_KERNEL_VERSION}:{schema}"
    assert autotune.backend("cpu") == "cpu" and autotune.backend(torch.device("cpu")) == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    autotune._card_name.cache_clear()
    try:
        assert autotune.backend(torch.device("cuda", 0)) == "NVIDIA_H100_80GB_HBM3"
    finally:
        autotune._card_name.cache_clear()


def test_kernel_version_bumps_change_every_key(monkeypatch):
    combos = [(8, 128, 128, 128, torch.float32, "cpu", None),
              (16, 256, 512, 64, torch.bfloat16, "NVIDIA_H100_80GB_HBM3", None),
              (8, 128, 128, 128, torch.int8, "cpu", None),
              (1, 2048, 1408, 256, torch.int8, "NVIDIA_H100_80GB_HBM3", 64)]
    attn = [(3, 64, 160, 32, torch.int8, "cpu"), (384, 64, 416, 32, torch.int8, "cpu")]
    encs = [(40320, 256, 256, torch.float32, "cpu"), (1280, 32, 127, torch.float32, "cpu")]

    def keys():
        return ({autotune.cache_key(*c) for c in combos}, {autotune.attn_cache_key(*a) for a in attn},
                {autotune.encode_cache_key(*c) for c in encs})

    mat0, attn0, enc0 = keys()
    monkeypatch.setattr(autotune, "KERNEL_VERSION", autotune.KERNEL_VERSION + 1)
    mat1, attn1, enc1 = keys()
    assert len(mat1) == len(combos) and mat0.isdisjoint(mat1) and attn0.isdisjoint(attn1)
    assert enc1 == enc0  # the encoder has its own version
    monkeypatch.setattr(autotune, "ENCODE_KERNEL_VERSION", autotune.ENCODE_KERNEL_VERSION + 1)
    assert keys()[2].isdisjoint(enc0)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def test_autotune_persists_cache_file(tune_cache):
    entry = autotune.autotune(4, 128, 64, group=32, dtype=torch.int8, reps=2, device="cpu")
    assert {"body", "chunk", "us", "candidates"} <= set(entry)
    assert (entry["body"], entry["chunk"]) == autotune.heuristic_tiles(4, 128, 64, 32, torch.int8)
    assert entry["rule"] == [entry["body"], entry["chunk"]] and entry["candidates"] == 1
    on_disk = json.loads(tune_cache.read_text())
    assert on_disk[autotune.cache_key(4, 128, 64, 32, torch.int8, "cpu")] == entry
    att = autotune.autotune_attn(3, 16, 40, group=16, reps=2, device="cpu")
    assert {"km", "w", "us", "candidates"} <= set(att)
    ent = autotune.autotune_encode(8, 64, 16, reps=2, device="cpu")
    assert {"delta_max", "us", "candidates"} <= set(ent) and "bg" not in ent
    assert len(json.loads(tune_cache.read_text())) == 3
    assert not list(tune_cache.parent.glob("*.tmp"))  # the atomic write left no temp file


def test_second_call_hits_without_searching(tune_cache, monkeypatch):
    e1 = autotune.autotune(4, 128, 64, group=32, reps=2, device="cpu")
    a1 = autotune.autotune_attn(3, 16, 40, group=16, reps=2, device="cpu")
    n1 = autotune.autotune_encode(8, 64, 16, reps=2, device="cpu")

    def boom(*a, **k):
        raise AssertionError("search ran despite a cache hit")

    monkeypatch.setattr(autotune, "_time_us", boom)
    assert autotune.autotune(4, 128, 64, group=32, reps=2, device="cpu") == e1
    assert autotune.get_tiles(4, 128, 64, group=32, search=True, device="cpu") == \
        (e1["body"], e1["chunk"])
    assert autotune.get_attn_tiles(3, 16, 40, group=16, search=True, device="cpu") == \
        (a1["km"], a1["w"])
    assert autotune.get_encode_params(8, 64, 16, search=True, device="cpu") == n1["delta_max"]
    st = autotune.tune_stats()
    assert (st["hits"], st["misses"], st["searches"]) == (4, 3, 3)


def test_cache_survives_memory_reset_and_follows_the_env_var(tune_cache, monkeypatch, tmp_path):
    entry = autotune.autotune(4, 128, 64, group=32, reps=2, device="cpu")
    autotune.clear_memory_cache()
    monkeypatch.setattr(autotune, "_time_us", lambda *a, **k: pytest.fail("re-searched"))
    assert autotune.get_tiles(4, 128, 64, group=32, search=True, device="cpu") == \
        (entry["body"], entry["chunk"])
    # a new path is read anew: the entry is not there
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "other.json"))
    autotune.reset_tune_stats()
    assert autotune.get_tiles(4, 128, 64, group=32, search=False, device="cpu") == \
        autotune.heuristic_tiles(4, 128, 64, 32)
    assert autotune.tune_stats()["misses"] == 1
    assert autotune.cache_path() == tmp_path / "other.json"
    monkeypatch.delenv("REPRO_TORCH_PVQ_TUNE_CACHE")
    assert autotune.cache_path().parts[-3:] == (".cache", "repro_torch", "pvq_tune_cache.json")


def test_stale_version_entries_are_never_served(tune_cache):
    key = autotune.cache_key(4, 128, 64, 32, torch.int8, "cpu")
    kv = f"kv{port_mm.KERNEL_VERSION}"
    poison = {"body": "direct", "chunk": 0, "us": 0.0, "candidates": 1}
    stale = {key.replace(kv, f"kv{port_mm.KERNEL_VERSION + 1}"),
             key.replace(f":{autotune._SCHEMA}", ":v0")}
    tune_cache.write_text(json.dumps({k: poison for k in stale}))
    autotune.clear_memory_cache()
    assert autotune.get_tiles(4, 128, 64, group=32, dtype=torch.int8, search=False,
                              device="cpu") == ("splitk", 32)


def test_env_var_turns_search_on_a_miss_on(tune_cache, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PVQ_AUTOTUNE", "1")
    assert autotune.get_tiles(4, 128, 64, group=32, device="cpu") == \
        autotune.heuristic_tiles(4, 128, 64, 32)
    assert autotune.tune_stats()["searches"] == 1 and tune_cache.exists()


# ---------------------------------------------------------------------------
# stats and telemetry
# ---------------------------------------------------------------------------


def test_tune_stats_has_the_references_fields(tune_cache):
    from repro.kernels import autotune as ref_autotune

    autotune.get_tiles(4, 128, 64, group=32, search=False, device="cpu")
    st = autotune.tune_stats()
    assert set(st) == set(ref_autotune.tune_stats()) == {"hits", "misses", "searches",
                                                         "search_s", "by_key"}
    key = autotune.cache_key(4, 128, 64, 32, torch.float32, "cpu")
    assert st["by_key"] == {key: {"hits": 0, "misses": 1, "searches": 0}}


def test_obs_counter_names_are_the_references(tune_cache, enabled_registry):
    autotune.autotune(4, 128, 64, group=32, reps=2, device="cpu")  # miss + search
    autotune.get_tiles(4, 128, 64, group=32, search=False, device="cpu")  # hit
    autotune.get_tiles(8, 128, 64, group=32, search=False, device="cpu")  # miss
    assert obs.counter("autotune.lookups").value == 3
    assert obs.counter("autotune.hit").value == 1
    assert obs.counter("autotune.miss").value == 2
    assert obs.counter("autotune.search").value == 1
    names = {r["name"] for r in enabled_registry.snapshot()}
    assert {"autotune.lookups", "autotune.hit", "autotune.miss", "autotune.search",
            "autotune.search_s"} <= names


def test_ops_look_up_every_call_on_the_cpu_route(tune_cache):
    """Every matmul, v4 and encode call looks its key up before the route
    is chosen (the batched key carries the expert count)."""
    from repro_torch.core import quantize as port_q
    from repro_torch.core.packed import PackedKV, pack_matmul

    gen = torch.Generator().manual_seed(0)
    bank = pack_matmul(torch.randn(3, 64, 32, generator=gen), group=32, n_over_k=1.0)
    kv = PackedKV.from_dense(torch.randn(2, 48, 2, 16, generator=gen),
                             torch.randn(2, 48, 2, 16, generator=gen),
                             kvq=port_q.KVQuant(block=8, group=8))
    autotune.reset_tune_stats()  # packing encoded through ops too
    ops.pvq_matmul(torch.randn(4, 64, generator=gen),
                   torch.randint(-3, 4, (64, 32), generator=gen, dtype=torch.int8),
                   torch.rand(2, 32, generator=gen), group=32, act_quant=port_q.ActQuant())
    ops.packed_matmul_stacked(torch.randn(3, 2, 64, generator=gen), bank)
    ops.pvq_encode(torch.randn(5, 16, generator=gen), k_pulses=16)
    ops.pvq_attn_decode(torch.randn(2, 1, 8, 16, generator=gen), kv, torch.tensor([48, 21]),
                        sm_scale=0.25)
    st = autotune.tune_stats()
    # m = 4 query heads a kv head over the planes' extent 48
    assert set(st["by_key"]) == {
        autotune.cache_key(4, 64, 32, 32, torch.int8, "cpu"),
        autotune.cache_key(2, 64, 32, 32, torch.float32, "cpu", e=3),
        autotune.encode_cache_key(5, 16, 16, torch.float32, "cpu"),
        autotune.attn_cache_key(4, 16, 48, 8, torch.int8, "cpu")}
    assert (st["hits"], st["misses"], st["searches"]) == (0, 4, 0)


# ---------------------------------------------------------------------------
# the rules, the candidates
# ---------------------------------------------------------------------------

SHAPES = [(4, 1024, 960, 256, None), (4, 2560, 960, 256, None), (512, 1024, 2560, 256, None),
          (1, 2048, 1408, 256, 64), (60, 1536, 2048, 256, 64), (4, 2048, 102400, 256, None),
          (7, 96, 40, 32, None), (2, 64, 64, 64, None), (16, 64, 40, 32, None),
          (8, 96, 48, 24, None), (3, 64, 32, 64, 3)]


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,group,e", SHAPES)
def test_get_tiles_without_search_is_the_rule(tune_cache, m, k, n, group, e, dtype):
    got = autotune.get_tiles(m, k, n, group=group, dtype=dtype, e=e, search=False, device="cpu")
    if dtype == torch.int8:
        body = port_mm._v3_body(m, k, n, group, 0, 0)
    else:
        body = port_mm._v2_body(m, k, n, group, 0, 0, dtype)
    chunk = port_mm._v3_decode_plan(e or 1, m, k, n, group)[1] if body == "splitk" else 0
    assert got == (body, chunk) == autotune.heuristic_tiles(m, k, n, group, dtype, e)
    assert not tune_cache.exists()


@pytest.mark.parametrize("m,hd,s,group", [(3, 64, 160, 32), (384, 64, 416, 32), (3, 64, 2048, 32),
                                          (1, 16, 30, 16), (12, 36, 300, 12), (768, 64, 2048, 32)])
def test_attn_and_encode_rules_without_search(tune_cache, m, hd, s, group):
    assert autotune.get_attn_tiles(m, hd, s, group=group, search=False, device="cpu") == \
        port_mm._v4_plan(m, s, hd, group)[:2]
    assert autotune.get_encode_params(m, hd, 32, search=False, device="cpu") == \
        port_enc.DELTA_MAX == 32
    cands = autotune.attn_candidates(m, hd, s, group)
    assert cands[0] == port_mm._v4_plan(m, s, hd, group)[:2]
    assert len(set(cands)) == len(cands) > 0
    nblk = -(-s // port_mm.ATTN_BS)
    for km, w in cands:
        assert port_mm._check_v4_plan((km, w, -(-nblk // w)), s, hd, group)
        assert km <= max(m, cands[0][0]) and w <= max(nblk, cands[0][1])
    assert not tune_cache.exists()


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("m,k,n,group,e", SHAPES)
def test_candidates_start_with_the_rule_and_keep_the_splitk_invariants(m, k, n, group, e, dtype):
    cands = autotune.candidate_tiles(m, k, n, group, dtype, e)
    assert cands[0] == autotune.heuristic_tiles(m, k, n, group, dtype, e)
    assert len(set(cands)) == len(cands) and ("direct", 0) in cands
    tiles = (e or 1) * -(-n // port_mm.SPLITK_COLS)
    partial = 4 if dtype == torch.int8 else 8
    for body, chunk in cands[1:]:
        if body == "splitk":
            assert m <= 8
            cols, c, splits = port_mm._splitk_plan("splitk", e or 1, m, k, n, group, chunk)
            assert (cols, c, splits) == (port_mm.SPLITK_COLS, chunk, k // chunk)
            assert chunk == k or (group % chunk == 0 and chunk % 4 == 0)
            # k splits only below the counters' count of column blocks
            assert splits == 1 or tiles < port_mm.SPLITK_TARGET_CTAS
            # the partials, written and read back, stay within the pulse bytes
            assert splits == 1 or 2 * partial * m * splits <= k
        elif body == "mma":
            assert m > 8
        else:
            assert (body, chunk) == ("direct", 0)


def test_encode_candidates_never_lower_delta_max():
    cands = autotune.encode_candidates()
    assert cands[0] == autotune.ENCODE_DEFAULT == port_enc.DELTA_MAX
    assert all(d >= 32 for d in cands) and 64 in cands and len(set(cands)) == len(cands)


def test_a_hand_edited_lower_delta_max_is_raised_to_the_rule(tune_cache):
    key = autotune.encode_cache_key(8, 64, 16, torch.float32, "cpu")
    tune_cache.write_text(json.dumps({key: {"delta_max": 8, "us": 1.0, "candidates": 2}}))
    autotune.clear_memory_cache()
    assert autotune.get_encode_params(8, 64, 16, device="cpu") == 32


def test_no_search_while_a_stream_captures(tune_cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(autotune, "_time_us", lambda *a, **k: pytest.fail("searched in a capture"))
    assert autotune.get_tiles(4, 128, 64, group=32, search=True, device="cpu") == \
        autotune.heuristic_tiles(4, 128, 64, 32)
    assert autotune.get_attn_tiles(3, 16, 40, group=16, search=True, device="cpu") == \
        port_mm._v4_plan(3, 40, 16, 16)[:2]
    assert autotune.get_encode_params(8, 64, 16, search=True, device="cpu") == 32
    st = autotune.tune_stats()
    assert (st["hits"], st["misses"], st["searches"]) == (0, 3, 0)
    assert not tune_cache.exists()


# ---------------------------------------------------------------------------
# a tuned choice that the operands do not fit: the rule's runs
# ---------------------------------------------------------------------------


def test_tuned_choices_that_do_not_fit_give_way_to_the_rule():
    x = torch.zeros(16, 64, dtype=torch.int8)
    w = torch.zeros(64, 40, dtype=torch.int8)  # n % 16 != 0: no mma, no splitk
    assert port_mm._pick_body("mma", 16, 64, 40, 32, x, w, tuned=True) == "direct"
    assert port_mm._pick_body("splitk", 4, 64, 40, 32, x[:4], w, tuned=True) == "direct"
    assert port_mm._pick_body("bogus", 4, 64, 40, 32, x[:4], w, tuned=True) == "direct"
    assert port_mm._pick_v2_body("mma", 16, 64, 40, 32, x.float(), w, tuned=True) == "direct"
    with pytest.raises(ValueError, match="mma body"):
        port_mm._pick_body("mma", 16, 64, 40, 32, x, w)
    # a chunk the counters cannot serve (k split at 64 experts x 22 column blocks)
    rule = port_mm._v3_decode_plan(64, 1, 2048, 1408, 256)
    assert port_mm._splitk_plan("splitk", 64, 1, 2048, 1408, 256, 64, tuned=True) == rule
    with pytest.raises(ValueError, match="splitk bodies take"):
        port_mm._splitk_plan("splitk", 64, 1, 2048, 1408, 256, 64)
    assert port_mm._splitk_plan("mma", 1, 16, 64, 64, 32, 32) == (0, 0, 0)
    assert port_mm._pick_v4_plan((8, 16, 1), 3, 2048, 64, 32, tuned=True) == \
        port_mm._v4_plan(3, 2048, 64, 32)
    with pytest.raises(ValueError, match="does not fit"):
        port_mm._pick_v4_plan((8, 16, 1), 3, 2048, 64, 32)


# ---------------------------------------------------------------------------
# a tuned delta_max against the reference's encoder
# ---------------------------------------------------------------------------


def test_tuned_delta_max_64_matches_the_reference_encoder(tune_cache):
    from repro.kernels.pvq_encode import pvq_encode_batch

    g, n, k = 64, 256, 256
    w = (np.random.default_rng(1).normal(size=(g, n)) ** 3).astype(np.float32)
    wt = torch.from_numpy(w)
    p32 = ops.pvq_encode(wt, k_pulses=k)[0]
    key = autotune.encode_cache_key(g, n, k, torch.float32, "cpu")
    tune_cache.write_text(json.dumps({key: {"delta_max": 64, "us": 1.0, "candidates": 2}}))
    autotune.clear_memory_cache()
    p64, rho64 = ops.pvq_encode(wt, k_pulses=k)
    assert bool((p64 != p32).any())  # the tail bound changes these rows
    p_ref, rho_ref = pvq_encode_batch(jnp.asarray(w), k_pulses=k, delta_max=64, interpret=True)
    np.testing.assert_array_equal(p64.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(rho64.numpy(), np.asarray(rho_ref), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# serve --tune against the reference's
# ---------------------------------------------------------------------------

TUNE_ARGV = ["--arch", "smollm-360m", "--reduced", "--batch", "2", "--prompt-len", "20",
             "--gen", "6", "--pvq", "--act-int8", "--kv-pvq", "--kv-block", "8",
             "--kv-group", "16", "--agreement-min", "0.99", "--tune"]
ENGINE_FLAGS = ["--engine", "--prefill-chunk", "2", "--prefill-batch", "2", "--requests", "3",
                "--engine-slots", "2"]
TUNE_KEYS = {"tuned_tiles", "tune_cache", "tune_wall_s", "tune_stats"}


class _Stop(Exception):
    pass


def _reference_tune_report(argv, monkeypatch):
    """The reference's ``serve --tune`` report up to the end of its tuning:
    its timing is a constant (no interpret-mode kernel runs), and packing,
    the next step, stops the serve and hands back the report."""
    from repro.kernels import autotune as ref_autotune
    from repro.launch import serve as ref_serve

    monkeypatch.setattr(ref_autotune, "_time_candidate", lambda *a, **k: 1e-3)
    monkeypatch.setattr(ref_autotune, "pvq_attn_q", lambda *a, **k: (jnp.zeros(()),))
    ref_autotune.clear_memory_cache()
    seen = {}

    def stop(*a, **k):
        seen.update(sys._getframe(1).f_locals["report"])
        raise _Stop

    monkeypatch.setattr(ref_serve, "quantize_params", stop)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(_Stop):
        ref_serve.main()
    ref_autotune.clear_memory_cache()
    return seen


@pytest.mark.parametrize("engine", [False, True])
def test_serve_tune_reports_the_references_keys_and_hits_on_a_second_run(
        tune_cache, monkeypatch, engine):
    argv = TUNE_ARGV + (ENGINE_FLAGS if engine else [])
    ref = _reference_tune_report(argv, monkeypatch)
    report, rc, state = port_serve.run(["--device", "cpu", *argv], return_state=True)
    assert rc == 0, report
    assert TUNE_KEYS <= set(report) and TUNE_KEYS <= set(ref)
    assert set(report["tuned_tiles"]) == set(ref["tuned_tiles"])
    assert report["tune_cache"] == str(tune_cache)
    first = report["tune_stats"]
    assert first["searches"] == first["misses"] > 0
    for key, entry in report["tuned_tiles"].items():
        assert set(entry) == ({"km", "w", "us"} if key.startswith("attn")
                              else {"body", "chunk", "us"})
    again, rc2, state2 = port_serve.run(["--device", "cpu", *argv], return_state=True)
    st = again["tune_stats"]
    assert rc2 == 0 and st["searches"] == st["misses"] == 0
    assert st["hits"] == first["hits"] + first["misses"] and set(st["by_key"]) == set(first["by_key"])
    assert again["tuned_tiles"] == report["tuned_tiles"]
    untuned, _, plain = port_serve.run(["--device", "cpu", *[f for f in argv if f != "--tune"]],
                                       return_state=True)
    assert "tuned_tiles" not in untuned
    if engine:
        assert state["outputs"] == state2["outputs"] == plain["outputs"]
    else:
        assert torch.equal(state["seq"], state2["seq"]) and torch.equal(state["seq"], plain["seq"])
        assert torch.equal(state2["logits_f"], plain["logits_f"])
