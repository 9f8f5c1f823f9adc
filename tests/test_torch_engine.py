"""The port's continuous-batching engine against the JAX reference's.

* ``PageAllocator``: the same operations give the same page ids,
  refcounts, cached pool and lookups; ``poisson_trace``: the same trace.
* ``PagedKV`` ``graft``, ``graft_chunk`` and ``append`` on the same numpy
  K/V: pulse pages bit-identical (the trash page excluded: the port never
  writes it), scale pages within ``atol 1e-6`` (rho is a float sum the port
  takes in a fixed pairwise order and XLA in its own, as
  ``tests/test_torch_packed.py`` states for ``PackedKV``), tail rings
  within ``atol 1e-5``; a chunked graft equals one whole graft bit for bit.
* ``attention_prefill_chunk`` against the reference's (its v4 in interpret
  mode) on the first, a middle and the final chunk of a context, GQA with
  3 query heads a KV head: ``atol 3e-2 * max|out|``, the tolerance of
  ``tests/test_torch_model.py``.
* Both engines on the same trace (rate 0, no EOS) and the same converted
  packed parameters, in CI's two engine configurations and one that
  evicts: every schedule counter of the report is identical.  With CI's
  int8 activations the port's tokens score >= 0.99 in the reference's
  ``engine_token_agreement`` wherever the reference's own tokens do; in
  CI's chunked configuration at CI's seed the reference's own tokens score
  0.9792 there (its chunk path reads the prompt back from packed pages), and
  the port's may score one token below that.  With f32 activations (the
  KV cache still PVQ) the two engines' tokens are identical: what differs
  under int8 is the one-code rounding of half-quantum ties that
  ``tests/test_torch_model.py`` measures.
* The no-leakage, EOS-stopping and capacity cases of ``tests/test_engine.py``
  through the port; ``serve --engine`` with CI's flags on the CPU (no
  ``--min-speedup``: a loaded CPU worker's clock is no test), its
  telemetry, and its refusal to run without a card.
* The engine's captured step bodies (device tables, the trash-scatter
  fill, the chunk at device indices) against its host-index steps:
  identical tokens and real pages.  Both reports hold the reference's
  ``trace_counts`` keys (all 0 on the CPU).  The reference's counts for
  CI's two engine configurations are ``chip_smoke.py``'s
  ``REFERENCE_TRACE_COUNTS``, which the card's runs hold the port's
  captures to, and its rule for a run without evictions
  (``chip_smoke.reference_trace_counts``) gives them in all three
  configurations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _chip_smoke_module import chip_smoke

from repro.configs import get_config as ref_get_config
from repro.core import packed as ref_packed
from repro.core import quantize as ref_q
from repro.launch import engine as ref_engine
from repro.launch import serve as ref_serve
from repro.nn import attention as ref_attn
from repro.nn.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_params
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.nn import attention as port_attn
from repro_torch.nn.models import Model
from repro_torch.runtime import obs, telemetry

KVQ_BLOCK, KVQ_GROUP = 8, 16


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PVQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    # and the port's, whose delta_max and choices would follow it
    monkeypatch.setenv("REPRO_TORCH_PVQ_TUNE_CACHE", str(tmp_path / "torch_tune.json"))


def _numpy_tree(tree):
    if isinstance(tree, ref_packed.PackedPVQ):
        return {
            "pulses": np.asarray(tree.pulses), "scales": np.asarray(tree.scales),
            "group": tree.group, "k": tree.k, "shape": tree.shape, "dtype": tree.dtype,
            "layout": tree.layout, "scale_mode": tree.scale_mode,
        }
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# Host half: allocator and trace
# ---------------------------------------------------------------------------


def _allocator_ops(seed, n_ops=400, n_pages=6):
    """A random sequence of allocator operations: (op, argument)."""
    rng = np.random.default_rng(seed)
    names = ["alloc", "alloc_many", "free", "register", "share", "lookup", "free_bad"]
    ops = []
    for _ in range(n_ops):
        op = names[int(rng.integers(len(names)))]
        ops.append((op, int(rng.integers(0, n_pages + 1)), f"key{int(rng.integers(0, 5))}"))
    return ops


def _apply(al, op, arg, key, held):
    """Apply one operation; returns its observable result."""
    if op == "alloc":
        pid = al.alloc()
        if pid is not None:
            held.append(pid)
        return pid
    if op == "alloc_many":
        ids = al.alloc_many(arg % 3 + 1)
        if ids is not None:
            held.extend(ids)
        return ids
    if op == "free" and held:
        pid = held.pop(arg % len(held))
        al.free([pid])
        return pid
    if op == "register" and held:
        al.register(held[arg % len(held)], key)
        return None
    if op == "share":
        pid = al.lookup(key)
        ok = pid is not None and al.share(pid)
        if ok:
            held.append(pid)
        return ok
    if op == "lookup":
        return al.lookup(key)
    if op == "free_bad":  # the trash page, or a page nobody holds
        bad = al.trash if arg % 2 else next(
            (p for p in range(al.n_pages) if al.refcount(p) == 0), al.trash)
        with pytest.raises(ValueError):
            al.free([bad])
        return "raised"
    return None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_allocator_matches_reference(seed):
    n_pages = 6
    ref, port = ref_engine.PageAllocator(n_pages), port_engine.PageAllocator(n_pages)
    held_r, held_p = [], []
    for op, arg, key in _allocator_ops(seed, n_pages=n_pages):
        assert _apply(ref, op, arg, key, held_r) == _apply(port, op, arg, key, held_p), op
        assert (ref.available, ref.used, ref.cached) == (port.available, port.used, port.cached)
        assert [ref.refcount(p) for p in range(n_pages)] == [port.refcount(p) for p in range(n_pages)]
        assert [ref.lookup(f"key{i}") for i in range(5)] == [port.lookup(f"key{i}") for i in range(5)]
    assert held_r == held_p


@pytest.mark.parametrize("rate,shared", [(0.0, 0), (5.0, 0), (2.0, 16)])
def test_poisson_trace_matches_reference(rate, shared):
    kw = dict(rate=rate, vocab=128, prompt_lens=(3, 13), max_new=7, eos_id=5, seed=9,
              shared_prefix=shared)
    ref = ref_engine.poisson_trace(12, **kw)
    port = port_engine.poisson_trace(12, **kw)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.eos_id, r.arrival) for r in ref] == \
        [(r.rid, r.prompt, r.max_new_tokens, r.eos_id, r.arrival) for r in port]


def test_bucket_len_is_shared_with_serve():
    for n, m in [(26, 8), (1, 32), (160, 32), (161, 32), (0, 8)]:
        assert port_engine.bucket_len(n, m) == ref_engine.bucket_len(n, m) == port_serve.bucket_len(n, m)


# ---------------------------------------------------------------------------
# PagedKV against the reference's
# ---------------------------------------------------------------------------

N_KV, HD = 2, 16


def _kv(seed, s):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, s, N_KV, HD)).astype(np.float32),
            rng.standard_normal((1, s, N_KV, HD)).astype(np.float32))


def _pools(paged, pages):
    """The pool's planes at ``pages`` and its tail rings, as numpy."""
    idx = np.asarray(pages)
    names = ("k_pages", "k_page_scales", "v_pages", "v_page_scales")
    planes = {n: np.asarray(getattr(paged, n))[idx] for n in names}
    tails = {n: np.asarray(getattr(paged, n)) for n in ("tail_k", "tail_v")}
    return planes, tails


def _assert_same_pools(ref, port, pages):
    rp, rt = _pools(ref, pages)
    pp, pt = _pools(port, pages)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(rp[name], pp[name], err_msg=name)
    for name in ("k_page_scales", "v_page_scales"):
        np.testing.assert_allclose(rp[name], pp[name], atol=1e-6, rtol=0, err_msg=name)
    for name in rt:
        np.testing.assert_allclose(rt[name], pt[name], atol=1e-5, rtol=0, err_msg=name)


def _both_pools(n_slots, n_pages, max_pages):
    kvq_r, kvq_p = ref_q.KVQuant(KVQ_BLOCK, KVQ_GROUP), port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)
    ref = ref_packed.PagedKV.init(n_slots, n_pages, max_pages, N_KV, HD, kvq=kvq_r,
                                  dtype=jnp.float32)
    port = port_packed.PagedKV.init(n_slots, n_pages, max_pages, N_KV, HD, kvq=kvq_p,
                                    dtype=torch.float32, device="cpu")
    return ref, port


@pytest.mark.parametrize("real_len", [21, 16, 5])
def test_paged_graft_matches_reference(real_len):
    """A whole-prompt graft into slot 1 through out-of-order pages: the
    pages and scales bit-identical, the tail ring within 1e-5; the gathered
    view and the dense view agree with the reference's over the valid
    extent."""
    blk = KVQ_BLOCK
    lb = -(-real_len // blk) * blk
    k, v = _kv(real_len, lb)
    ref, port = _both_pools(2, 6, 4)
    n_full = real_len // blk
    ids = np.full((lb // blk,), 6, np.int32)
    ids[:n_full] = [3, 0][:n_full]
    ref = ref.graft(jnp.asarray(k), jnp.asarray(v), jnp.int32(1), jnp.asarray(ids),
                    jnp.int32(real_len))
    port.graft(torch.from_numpy(k), torch.from_numpy(v), 1, ids, real_len)
    _assert_same_pools(ref, port, [3, 0])
    pt = np.full((2, 4), 6, np.int32)
    pt[1, :n_full] = ids[:n_full]
    ref = ref.with_tables(jnp.asarray(pt), jnp.full((2,), 6, jnp.int32))
    port.with_tables(torch.from_numpy(pt), np.full((2,), 6, np.int32))
    filled = np.asarray([0, real_len], np.int32)
    kr, vr = ref.dense_kv(jnp.asarray(filled))
    kp, vp = port.dense_kv(torch.from_numpy(filled).to(torch.int64))
    np.testing.assert_allclose(kp[1, :real_len].numpy(), np.asarray(kr)[1, :real_len], atol=1e-5)
    np.testing.assert_allclose(vp[1, :real_len].numpy(), np.asarray(vr)[1, :real_len], atol=1e-5)
    gr, gp = ref.gather(), port.gather()
    pe = n_full * blk
    np.testing.assert_array_equal(gp.k_pulses[1, :pe].numpy(), np.asarray(gr.k_pulses)[1, :pe])
    np.testing.assert_allclose(gp.v_scales[1, :pe].numpy(), np.asarray(gr.v_scales)[1, :pe],
                               atol=1e-6, rtol=0)
    one = port.gather_slot(1)
    assert torch.equal(one.k_pulses[0], gp.k_pulses[1]) and torch.equal(one.tail_v[0], gp.tail_v[1])


def test_paged_chunked_graft_matches_reference_and_whole_graft():
    """One page a chunk into slot 1: the port's pool after every chunk
    equals the reference's, and after the last one equals one whole graft
    (tails included, bit for bit)."""
    blk, real_len = KVQ_BLOCK, 21
    lb = 24
    k, v = _kv(2, lb)
    ids = [3, 0, 6]
    ref, port = _both_pools(2, 6, 4)
    for ci, start in enumerate(range(0, lb, blk)):
        ref = ref.graft_chunk(jnp.asarray(k[:, start:start + blk]), jnp.asarray(v[:, start:start + blk]),
                              jnp.int32(1), jnp.asarray([ids[ci]], jnp.int32), jnp.int32(start),
                              jnp.int32(real_len))
        port.graft_chunk(torch.from_numpy(k[:, start:start + blk]),
                         torch.from_numpy(v[:, start:start + blk]), 1, [ids[ci]], start, real_len)
        _assert_same_pools(ref, port, [3, 0])
    _, whole = _both_pools(2, 6, 4)
    whole.graft(torch.from_numpy(k), torch.from_numpy(v), 1, ids, real_len)
    for name in ("k_pages", "k_page_scales", "v_pages", "v_page_scales", "tail_k", "tail_v"):
        assert torch.equal(getattr(whole, name), getattr(port, name)), name


def test_paged_append_matches_reference():
    """Per-slot appends over two slots at their own positions, crossing
    block boundaries into pre-assigned, out-of-order pages: pages, scales
    and tails as the reference's masked encode leaves them."""
    blk, steps = KVQ_BLOCK, 2 * KVQ_BLOCK + 3
    ref, port = _both_pools(2, 6, 4)
    k, v = _kv(7, 2 * steps)
    k, v = k.reshape(2, steps, N_KV, HD), v.reshape(2, steps, N_KV, HD)
    pages = {0: [2, 4], 1: [0, 5]}
    offset = {0: 0, 1: 3}  # slot 1 starts 3 positions later
    pt = np.full((2, 4), 6, np.int32)
    for t in range(steps + 3):
        pos = np.asarray([t - offset[s] if t >= offset[s] else 0 for s in (0, 1)], np.int32)
        live = [s for s in (0, 1) if offset[s] <= t < offset[s] + steps]
        wp = np.full((2,), 6, np.int32)
        for s in live:
            if (pos[s] + 1) % blk == 0:
                pid = pages[s][pos[s] // blk]
                pt[s, pos[s] // blk] = pid
                wp[s] = pid
        rows = np.stack([k[s, min(pos[s], steps - 1)] for s in (0, 1)])[:, None]
        rows_v = np.stack([v[s, min(pos[s], steps - 1)] for s in (0, 1)])[:, None]
        ref = ref.with_tables(jnp.asarray(pt), jnp.asarray(wp))
        ref = ref.append(jnp.asarray(rows), jnp.asarray(rows_v), jnp.asarray(pos))
        port.with_tables(torch.from_numpy(pt), wp)
        port.append(torch.from_numpy(rows), torch.from_numpy(rows_v), torch.from_numpy(pos))
    _assert_same_pools(ref, port, [2, 4, 0, 5])


# ---------------------------------------------------------------------------
# Chunked-prefill attention against the reference's
# ---------------------------------------------------------------------------


def test_attention_prefill_chunk_matches_reference():
    """A 45-token context in chunks of 16 (2 pages of 8) through both
    packages' ``attention_prefill_chunk``: the first chunk (kv_len 0: the
    packed leg is empty), the middle one and the final one, which reads 32
    packed positions through kernel v4 with 16 x 3 query rows."""
    n_heads, n_kv, hd, d, blk, c, real_len = 6, 2, 32, 48, 8, 16, 45
    rng = np.random.default_rng(11)
    p_np = {name: {"kernel": (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)}
            for name, shape in (("wq", (d, n_heads * hd)), ("wk", (d, n_kv * hd)),
                                ("wv", (d, n_kv * hd)), ("wo", (n_heads * hd, d)))}
    x = rng.standard_normal((1, 48, d)).astype(np.float32)
    p_ref = jax.tree.map(jnp.asarray, p_np)
    p_port = from_reference_params(p_np)
    n_full = real_len // blk
    pt = np.full((1, 6), 8, np.int32)
    pt[0, :n_full] = np.arange(n_full)
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd, rope_theta=10000.0)
    ref = ref_packed.PagedKV.init(1, 8, 6, n_kv, hd, kvq=ref_q.KVQuant(blk, KVQ_GROUP),
                                  dtype=jnp.float32)
    ref = ref.with_tables(jnp.asarray(pt), jnp.full((1,), 8, jnp.int32))
    port = port_packed.PagedKV.init(1, 8, 6, n_kv, hd, kvq=port_q.KVQuant(blk, KVQ_GROUP),
                                    dtype=torch.float32, device="cpu")
    port.with_tables(torch.from_numpy(pt), np.full((1,), 8, np.int32))
    for start in (0, 16, 32):
        ids = np.full((c // blk,), 8, np.int32)
        for j in range(c // blk):
            if start // blk + j < n_full:
                ids[j] = start // blk + j
        xc = x[:, start:start + c]
        y_ref, ref = ref_attn.attention_prefill_chunk(
            p_ref, jnp.asarray(xc), ref, slot=jnp.int32(0), start=jnp.int32(start),
            page_ids=jnp.asarray(ids), real_len=jnp.int32(real_len), **kw)
        y_port, _ = port_attn.attention_prefill_chunk(
            p_port, torch.from_numpy(xc), port, slot=0, start=start, page_ids=ids,
            real_len=real_len, **kw)
        want = np.asarray(y_ref)[:, : real_len - start]
        got = y_port.numpy()[:, : real_len - start]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max(), rtol=0,
                                   err_msg=f"chunk at {start}")


# ---------------------------------------------------------------------------
# Both engines on the same trace
# ---------------------------------------------------------------------------

# (engine arguments, serve flags) of CI's two engine smokes
# (.github/workflows/ci.yml:99-132) and an evicting pool
CONFIGS = {
    "ci_saturate": (dict(n_slots=3), dict(prompt=12, gen=8, shared=0)),
    "ci_chunked": (dict(n_slots=2, prefill_chunk=2, prefill_batch=2),
                   dict(prompt=24, gen=8, shared=64)),
    "evicting": (dict(n_slots=3, n_pages=4), dict(prompt=12, gen=8, shared=0)),
}
SCHEDULE_KEYS = ("requests", "generated_tokens", "prefill_batches", "prefill_rows", "chunks",
                 "prefix_hits", "prefix_misses", "prefix_pages_shared", "evictions",
                 "decode_steps", "slot_utilization")


@pytest.fixture(scope="module")
def reduced():
    """Reduced smollm as CI's serve builds it (seed 0, ``--pvq`` policy),
    packed by the reference and converted for the port."""
    ref_cfg = ref_get_config("smollm-360m").reduced()
    ref_model = RefModel(ref_cfg)
    policy = ref_q.QuantPolicy(
        rules=(("embedding", ref_cfg.pvq.n_over_k_embed, ref_cfg.pvq.group),
               ("kernel|experts", 1.0, ref_cfg.pvq.group)), scale_mode="ls")
    ref_params = ref_packed.quantize_params(ref_model.init(jax.random.PRNGKey(0)), policy)
    port_model = Model(get_config("smollm-360m").reduced())
    port_params = from_reference_params(_numpy_tree(ref_params))
    return ref_cfg, ref_model, ref_params, port_model, port_params


def _serve_trace(mod, vocab, prompt, gen, shared):
    """The trace ``serve --engine`` builds (``--requests 6 --rate 0 --seed 0``)."""
    return mod.poisson_trace(6, rate=0.0, vocab=vocab, prompt_lens=(max(prompt // 2, 1), prompt),
                             max_new=gen, seed=2, shared_prefix=shared)


_RUNS = {}


def _run_both(reduced, name, act_int8):
    """Both engines on ``name``'s trace (once a module: later callers take
    the first run's results)."""
    if (name, act_int8) not in _RUNS:
        _RUNS[name, act_int8] = _run_both_once(reduced, name, act_int8)
    return _RUNS[name, act_int8]


def _run_both_once(reduced, name, act_int8):
    ref_cfg, ref_model, ref_params, port_model, port_params = reduced
    eng_kw, flags = CONFIGS[name]
    max_len = ref_engine.bucket_len(flags["shared"] + flags["prompt"] + flags["gen"], KVQ_BLOCK)
    args = (ref_cfg.vocab_size, flags["prompt"], flags["gen"], flags["shared"])
    with ref_q.act_quant_scope(ref_q.ActQuant() if act_int8 else None), \
            ref_q.kv_quant_scope(ref_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        trace = _serve_trace(ref_engine, *args)
        eng = ref_engine.PVQEngine(ref_model, ref_params, max_len=max_len, **eng_kw)
        eng.warmup([len(r.prompt) for r in trace])
        ref_res = eng.run(trace)
    with port_q.act_quant_scope(port_q.ActQuant() if act_int8 else None), \
            port_q.kv_quant_scope(port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        port_trace = _serve_trace(port_engine, *args)
        eng = port_engine.PVQEngine(port_model, port_params, max_len=max_len, **eng_kw)
        eng.warmup([len(r.prompt) for r in port_trace])
        port_res = eng.run(port_trace)
        assert eng.alloc.used == 0
    # the reference's keys, key for key: on the CPU nothing is captured
    assert set(port_res["trace_counts"]) == set(ref_res["trace_counts"])
    assert set(port_res["trace_counts"].values()) == {0}
    assert set(port_res) == set(ref_res)
    return trace, ref_res, port_res


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engines_agree_on_the_same_trace(reduced, name):
    ref_cfg, ref_model, ref_params, _, _ = reduced
    trace, ref_res, port_res = _run_both(reduced, name, act_int8=True)
    assert {k: port_res[k] for k in SCHEDULE_KEYS} == {k: ref_res[k] for k in SCHEDULE_KEYS}
    if name == "evicting":
        assert port_res["evictions"] > 0
    if name == "ci_chunked":
        assert port_res["chunks"] > 0 and port_res["prefix_hits"] > 0
    with ref_q.act_quant_scope(ref_q.ActQuant()), \
            ref_q.kv_quant_scope(ref_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        port_ag = ref_serve.engine_token_agreement(ref_model, ref_params, trace,
                                                   port_res["outputs"])
        assert port_ag["engine_tokens_compared"] == port_res["generated_tokens"] == 48
        if port_ag["engine_token_agreement"] < 0.99:
            # the gate holds wherever the reference's own tokens pass it
            ref_ag = ref_serve.engine_token_agreement(ref_model, ref_params, trace,
                                                      ref_res["outputs"])
            assert ref_ag["engine_token_agreement"] < 0.99, (port_ag, ref_ag)
            assert port_ag["engine_token_agreement"] >= ref_ag["engine_token_agreement"] - 1 / 48


# CONFIGS' names of CI's two engine smokes -> chip_smoke.py's
CHIP_SMOKE_RUNS = {"ci_saturate": "ci engine saturate", "ci_chunked": "ci engine chunked"}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_trace_counts_are_chip_smokes(reduced, name):
    """The reference engine's ``trace_counts`` after warm-up and run: CI's
    two configurations give ``chip_smoke.REFERENCE_TRACE_COUNTS``, and every
    configuration gives what ``chip_smoke.reference_trace_counts`` derives
    from its trace (it evicts in the third without a new bucket)."""
    smoke = chip_smoke()
    trace, ref_res, _ = _run_both(reduced, name, act_int8=True)
    eng_kw = CONFIGS[name][0]
    if name in CHIP_SMOKE_RUNS:
        assert ref_res["trace_counts"] == smoke.REFERENCE_TRACE_COUNTS[CHIP_SMOKE_RUNS[name]]
    chunk_tokens = eng_kw.get("prefill_chunk", 0) * KVQ_BLOCK
    assert ref_res["trace_counts"] == smoke.reference_trace_counts(
        [len(r.prompt) for r in trace], KVQ_BLOCK, chunk_tokens)


def test_engines_give_identical_tokens_with_f32_activations(reduced):
    """CI's chunked configuration with the KV cache PVQ-coded but the
    activations in f32: chunks, prefix hits, batched admission and decode
    give the reference's tokens exactly."""
    _, ref_res, port_res = _run_both(reduced, "ci_chunked", act_int8=False)
    assert {k: port_res[k] for k in SCHEDULE_KEYS} == {k: ref_res[k] for k in SCHEDULE_KEYS}
    assert port_res["outputs"] == ref_res["outputs"]


# ---------------------------------------------------------------------------
# The port's engine alone (tests/test_engine.py's cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_model():
    model = Model(get_config("smollm-360m").reduced())
    return model, model.init(0, device="cpu")


def _requests(trace, **kw):
    return [port_engine.Request(rid=r.rid, prompt=list(r.prompt), **kw) for r in trace]


def test_engine_no_cross_sequence_leakage(port_model):
    """A request decodes the same tokens alone or packed beside others in
    an oversubscribed pool (pages freed by one sequence and reused by
    another leak nothing)."""
    model, params = port_model
    prompt = [5, 17, 9, 63, 2, 41, 8]
    with port_q.kv_quant_scope(port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        alone = port_engine.PVQEngine(model, params, n_slots=2, max_len=32).run(
            [port_engine.Request(rid=100, prompt=list(prompt), max_new_tokens=6)])
        others = port_engine.poisson_trace(4, rate=0.0, vocab=128, prompt_lens=(4, 12),
                                           max_new=6, seed=11)
        eng = port_engine.PVQEngine(model, params, n_slots=2, max_len=32, n_pages=5)
        packed = eng.run([port_engine.Request(rid=100, prompt=list(prompt), max_new_tokens=6)]
                         + others)
    assert packed["requests"] == 5
    assert alone["outputs"][100] == packed["outputs"][100]


def test_engine_eos_and_max_tokens_stopping(port_model):
    """A slot retires on its own EOS and frees its pages; the other
    sequences' tokens equal the run without EOS."""
    model, params = port_model
    with port_q.kv_quant_scope(port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        trace = port_engine.poisson_trace(4, rate=0.0, vocab=128, prompt_lens=(4, 10),
                                          max_new=8, seed=5)
        free_run = port_engine.PVQEngine(model, params, n_slots=4, max_len=32).run(
            _requests(trace, max_new_tokens=8))
        eos = next(tok for r in trace for tok in free_run["outputs"][r.rid][:-1]
                   if tok != free_run["outputs"][r.rid][-1])
        eng = port_engine.PVQEngine(model, params, n_slots=4, max_len=32)
        stopped = eng.run(_requests(trace, max_new_tokens=8, eos_id=eos))
    truncated = False
    for r in trace:
        full, got = free_run["outputs"][r.rid], stopped["outputs"][r.rid]
        assert got == (full[: full.index(eos) + 1] if eos in full else full)
        truncated |= len(got) < len(full)
    assert truncated and eng.alloc.used == 0


def test_engine_requires_kv_quant_and_capacity(port_model):
    model, params = port_model
    with pytest.raises(ValueError, match="KVQuant"):
        port_engine.PVQEngine(model, params, n_slots=2, max_len=32)
    with port_q.kv_quant_scope(port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        eng = port_engine.PVQEngine(model, params, n_slots=2, max_len=16)
        with pytest.raises(ValueError, match="capacity"):
            eng.validate(port_engine.Request(rid=0, prompt=[1] * 12, max_new_tokens=8))
        with pytest.raises(ValueError, match="one full-length sequence"):
            port_engine.PVQEngine(model, params, n_slots=2, max_len=32, n_pages=2)


def test_per_slot_positions_need_the_paged_cache(port_model):
    """``decode_step`` with a ``(b,)`` position tensor, once the paged
    pool's alone, now runs over every cache (the step a CUDA graph
    captures): over the dense and the ``PackedKV`` cache it gives the
    host-int step's logits, and a ``PackedKV`` append at device positions
    needs the host's block-fill choice."""
    model, params = port_model
    tok = torch.zeros((2, 1), dtype=torch.int64)
    for kvq in (None, port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        with port_q.kv_quant_scope(kvq):
            host = model.init_cache(2, 16, device="cpu")
            dev = model.init_cache(2, 16, device="cpu")
            for pos in range(6, 9):  # position 7 completes block 0
                want, host = model.decode_step(params, host, tok, pos)
                got, dev = model.decode_step(params, dev, tok, torch.full((2,), pos),
                                             fill=(pos + 1) % KVQ_BLOCK == 0)
                assert torch.equal(got, want)
            if kvq is not None:
                with pytest.raises(ValueError, match="fill flag"):
                    model.decode_step(params, dev, tok, torch.full((2,), 9))


def test_engine_trash_scatter_fill_matches_the_host_table_step(reduced):
    """CI's chunked configuration (chunks, prefix hits) through the
    engine's captured step bodies (run eagerly here: device tables, every
    ring encoded on a fill step and the rest scattered to the trash page;
    each chunk at device slot, start and page ids, every block encoded)
    and through the host-index steps (``eager=True``: the completing rings
    and the real blocks alone): identical tokens, and identical bytes in
    every real page and tail ring of every layer."""
    _, _, _, port_model, port_params = reduced
    eng_kw, flags = CONFIGS["ci_chunked"]
    max_len = port_engine.bucket_len(flags["shared"] + flags["prompt"] + flags["gen"], KVQ_BLOCK)
    args = (port_model.cfg.vocab_size, flags["prompt"], flags["gen"], flags["shared"])
    runs = {}
    with port_q.act_quant_scope(port_q.ActQuant()), \
            port_q.kv_quant_scope(port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        for eager in (True, False):
            eng = port_engine.PVQEngine(port_model, port_params, max_len=max_len, eager=eager,
                                        **eng_kw)
            trace = _serve_trace(port_engine, *args)
            eng.warmup([len(r.prompt) for r in trace])
            runs[eager] = (eng.run(trace), eng)
    (host_res, host_eng), (dev_res, dev_eng) = runs[True], runs[False]
    assert dev_res["outputs"] == host_res["outputs"]
    assert dev_res["decode_steps"] == host_res["decode_steps"] > 0
    for a, b in zip(port_engine._paged_leaves(host_eng.cache),
                    port_engine._paged_leaves(dev_eng.cache)):
        real = slice(0, a.trash_page)
        for name in ("k_pages", "k_page_scales", "v_pages", "v_page_scales"):
            assert torch.equal(getattr(a, name)[real], getattr(b, name)[real]), name
        assert torch.equal(a.tail_k, b.tail_k) and torch.equal(a.tail_v, b.tail_v)


def test_paged_cache_rejects_mla():
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    with port_q.kv_quant_scope(port_q.KVQuant(KVQ_BLOCK, KVQ_GROUP)):
        with pytest.raises(NotImplementedError, match="plain attention blocks only"):
            Model(cfg).init_paged_cache(2, 8, 4, device="cpu")


# ---------------------------------------------------------------------------
# serve --engine
# ---------------------------------------------------------------------------

CI_ENGINE_FLAGS = {
    "ci_saturate": [
        "--arch", "smollm-360m", "--reduced", "--prompt-len", "12", "--gen", "8", "--engine",
        "--engine-slots", "3", "--requests", "6", "--rate", "0", "--pvq", "--act-int8",
        "--kv-pvq", "--kv-block", "8", "--kv-group", "16", "--agreement-min", "0.99",
    ],
    "ci_chunked": [
        "--arch", "smollm-360m", "--reduced", "--prompt-len", "24", "--gen", "8", "--engine",
        "--engine-slots", "2", "--requests", "6", "--rate", "0", "--pvq", "--act-int8",
        "--kv-pvq", "--kv-block", "8", "--kv-group", "16", "--prefill-chunk", "2",
        "--prefill-batch", "2", "--shared-prefix", "64", "--agreement-min", "0.99",
        "--min-prefix-hits", "1",
    ],
}


@pytest.mark.parametrize("name", list(CI_ENGINE_FLAGS))
def test_serve_engine_cli_with_cis_flags_on_cpu(name, tmp_path):
    """CI's engine smokes through the port's serve on the CPU (its own
    random weights): exit 0, the engine report under CI's key names, the
    agreement gate, and no kernel launch."""
    argv = ["--device", "cpu", *CI_ENGINE_FLAGS[name]]
    if name == "ci_saturate":
        argv += ["--metrics-out", str(tmp_path / "obs")]
    prev = obs.set_enabled(False)
    obs.registry().clear()
    try:
        report, rc = port_serve.run(argv)
    finally:
        obs.set_enabled(prev)
        obs.registry().clear()
    assert rc == 0, report
    assert report["engine_requests"] == 6 and report["engine_generated_tokens"] == 48
    assert report["engine_token_agreement"] >= 0.99
    assert report["engine_tokens_compared"] == 48
    assert report["engine_speedup_vs_fixed_batch"] > 0 and report["baseline_tokens_per_s"] > 0
    assert set(report["kernel_launches"].values()) == {0}
    assert report["engine_trace_counts"] == {"decode": 0, "prefill": 0, "graft": 0, "chunk": 0}
    assert report["decode_step_captures"] == 0
    if name == "ci_chunked":
        assert report["engine_prefix_hits"] >= 1 and report["engine_chunks"] > 0
    else:
        # the engine's telemetry, read back the way CI's schema gate reads it
        out = str(tmp_path / "obs")
        telemetry.validate_dir(out)
        names = {r["name"] for r in telemetry.validate_metrics_jsonl(out + "/metrics.jsonl")}
        spans = {e["name"] for e in telemetry.validate_chrome_trace(out + "/trace.json")}
        assert {"engine.page_pool_free", "engine.queue_depth", "engine.decode_steps",
                "engine.admissions", "engine.request_latency_s", "quant.kv_snr_db",
                "quant.weight_snr_db"} <= names
        assert {"engine/prefill", "engine/graft", "engine/decode_step"} <= spans
        assert "engine.trace_count" in names
        # CI's --require-engine gate: the dispatch's autotune lookups included
        assert "autotune.lookups" in names
        assert telemetry.validate_dir(out, require_engine=True)["metrics"] > 0


def test_serve_engine_chunk_span_and_gates(tmp_path):
    """The chunk span lands in the trace, and the prefix-hit gate fails a
    run whose prefix cache is off."""
    argv = ["--device", "cpu", *CI_ENGINE_FLAGS["ci_chunked"], "--no-prefix-cache",
            "--requests", "2", "--metrics-out", str(tmp_path / "obs")]
    prev = obs.set_enabled(False)
    obs.registry().clear()
    try:
        report, rc = port_serve.run(argv)
    finally:
        obs.set_enabled(prev)
        obs.registry().clear()
    assert rc == 1 and report["engine_prefix_hits"] == 0 and "prefix_cache_fail" in report
    spans = {e["name"] for e in telemetry.validate_chrome_trace(str(tmp_path / "obs/trace.json"))}
    assert "engine/prefill_chunk" in spans


def test_serve_engine_refuses_without_a_card_or_kv_pvq(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.run(CI_ENGINE_FLAGS["ci_saturate"])
    flags = [f for f in CI_ENGINE_FLAGS["ci_saturate"] if f != "--kv-pvq"]
    with pytest.raises(SystemExit):
        port_serve.run(["--device", "cpu", *flags])
