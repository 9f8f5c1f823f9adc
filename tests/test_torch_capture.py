"""The captured decode step's pieces that run on the CPU (no JAX).

On a card ``serve.generate``, ``serve.teacher_forced_logits`` and the
engine replay a CUDA graph of ``Model.decode_step`` at device positions;
on the CPU they run that same step eagerly.  Here, on reduced smollm-360m
(``--pvq --act-int8 --kv-pvq``, KV block 8, through block fills) and
reduced deepseek-v2-lite-16b (``--pvq --act-int8``), both legs:

* the device-position step gives the host-int step's (``eager=True``)
  tokens and logits bit for bit, and captures nothing on the CPU;
* a graph's key tells the quantized leg from the f32 leg, and one key
  serves every prompt length of a cache-length bucket;
* the telemetry probes, which read values back to the host, bail while a
  graph is being captured (``torch.cuda.is_current_stream_capturing``
  patched to True);
* the launch-count arithmetic a replay relies on, and the harness's
  per-caller counts, which follow replays the same way; ``PagedKV``'s static
  tables (copied into, never replaced);
* the engine's prefill, graft and chunk steps at device indices (the bodies
  the card captures): ``PagedKV.graft_chunk`` with device slot, start, real
  length and page ids writes the host-int form's bytes into every real page
  and ring (the first, a middle, a final partial and an all-trash chunk,
  and a real length on a page boundary); ``Model.prefill_chunk`` at device
  indices gives the host-int form's logits bit for bit; the non-eager
  engine (its static-shape, device-index bodies run eagerly here) gives the
  ``eager=True`` engine's tokens and real pages where it evicts and where
  an admission batch holds fewer rows than ``prefill_batch`` (CI's chunked
  configuration is in ``tests/test_torch_engine.py``), capturing nothing.

The card's side (capture, replay, bit-identity with the eager step) is in
``tests/test_torch_cuda.py``.
"""

import types

import numpy as np
import pytest
import torch
from _chip_smoke_module import chip_smoke

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.core.packed import quantize_params
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve
from repro_torch.nn.models import Model
from repro_torch.runtime import obs


@pytest.fixture(scope="module")
def reduced():
    """Both reduced models, packed by the ``serve --pvq`` policy (seed 0)."""
    out = {}
    for arch in ("smollm-360m", "deepseek-v2-lite-16b"):
        cfg = get_config(arch).reduced()
        model = Model(cfg)
        out[arch] = (model, quantize_params(model.init(0, device="cpu"), serve.serving_policy(cfg)))
    return out


# (arch, ActQuant, KVQuant): each model's served leg and its f32 leg
LEGS = {
    "smollm_served": ("smollm-360m", port_q.ActQuant(), port_q.KVQuant(8, 16)),
    "smollm_f32": ("smollm-360m", None, None),
    "deepseek_served": ("deepseek-v2-lite-16b", port_q.ActQuant(), None),
    "deepseek_f32": ("deepseek-v2-lite-16b", None, None),
}


@pytest.mark.parametrize("leg", list(LEGS))
def test_device_position_serve_equals_host_int_serve(reduced, leg):
    """``generate`` and ``teacher_forced_logits`` through the device-position
    step against the host-int step: the same tokens, the same logits bit
    for bit, over prompt 13 and 13 steps (the smollm leg's KV blocks fill at
    positions 15 and 23); nothing is captured on the CPU."""
    arch, aq, kvq = LEGS[leg]
    model, params = reduced[arch]
    seq = torch.from_numpy(np.random.default_rng(7).integers(0, model.cfg.vocab_size, (2, 27)))
    captures = serve.TRACE_COUNTS["decode_step"]
    with port_q.act_quant_scope(aq), port_q.kv_quant_scope(kvq):
        host = serve.teacher_forced_logits(model, params, seq, prompt_len=13, eager=True)
        got = serve.teacher_forced_logits(model, params, seq, prompt_len=13)
        host_tokens = serve.generate(model, params, seq[:, :13], gen=13, cache_len=26, eager=True)
        tokens = serve.generate(model, params, seq[:, :13], gen=13, cache_len=26)
    assert got.shape == (2, 14, model.cfg.vocab_size) and torch.isfinite(got).all()
    assert torch.equal(got, host)
    assert torch.equal(tokens, host_tokens)
    assert serve.TRACE_COUNTS["decode_step"] == captures


def test_step_key_separates_the_legs_and_shares_a_bucket(reduced):
    """The key a capture is filed under: the f32 leg's differs from the
    quantized leg's (the reference's reuse of its int8 trace for the f32
    leg is not copied), and two prompt lengths of one cache-length bucket
    give the same cache shapes, so one key."""
    model, params = reduced["smollm-360m"]
    tokens = torch.zeros((2, 20), dtype=torch.int64)
    keys = {}
    for name, aq, kvq, prompt in (("served", port_q.ActQuant(), port_q.KVQuant(8, 16), 20),
                                  ("served_short", port_q.ActQuant(), port_q.KVQuant(8, 16), 17),
                                  ("f32", None, None, 20)):
        with port_q.act_quant_scope(aq), port_q.kv_quant_scope(kvq):
            _, cache = model.prefill(params, {"tokens": tokens[:, :prompt]}, cache_len=32)
            keys[name] = serve._step_key(params, cache)
            if kvq is not None:
                assert serve._fill_block(cache) == 8
                kv = cache["seg0"][0]["b0"]["kv"]
                assert kv.max_len == 32  # planes padded to cache_len, not past it
            else:
                assert serve._fill_block(cache) is None
    assert keys["served"] == keys["served_short"]
    assert keys["served"] != keys["f32"]
    assert keys["served"][:3] != keys["f32"][:3]  # the scopes alone tell them apart


def _probe_records(names):
    return [r for r in obs.registry().snapshot() if r["name"] in names]


@pytest.mark.parametrize("capturing", [False, True])
def test_probes_bail_while_a_graph_is_captured(monkeypatch, capturing):
    """With telemetry on, the activation and KV-encode probes record on an
    eager call and record nothing while a CUDA graph is being captured
    (their ``.cpu()`` and ``float()`` would sync inside the capture)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    prev = obs.set_enabled(True)
    obs.registry().clear()
    try:
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8, 2, 16)))
        port_q.quantize_activations(x.float())
        port_packed._kv_encode_planes(x.float(), 16, 127)
        names = {"quant.act_quant_calls", "quant.act_clamp_frac", "quant.kv_blocks_probed",
                 "quant.kv_snr_db", "quant.kv_clamp_frac"}
        recorded = {r["name"] for r in _probe_records(names)}
    finally:
        obs.set_enabled(prev)
        obs.registry().clear()
    assert recorded == (set() if capturing else names)


def test_replay_launch_accounting():
    """What a capture counted is taken back and added once per replay."""
    kernels.reset_launches()
    before = kernels.snapshot()
    kernels.LAUNCHES["pvq_matmul_q"] += 3
    kernels.V3_BODY_LAUNCHES["splitk"] += 3
    kernels.LAUNCHES["pvq_attn_q"] += 1
    delta = kernels.since(before)
    kernels.add(delta, -1)  # the capture launched nothing
    assert set(kernels.launches().values()) == {0}
    for _ in range(4):  # four replays
        kernels.add(delta)
    assert kernels.launches()["pvq_matmul_q"] == 12 and kernels.launches()["pvq_attn_q"] == 4
    assert kernels.v3_body_launches() == {"splitk": 12, "direct": 0, "mma": 0}
    kernels.reset_launches()



def test_per_caller_counts_follow_replays(monkeypatch):
    """``chip_smoke.launches_by_caller`` counts a caller's launches as the
    global counts do: a graph's eager first run once, its capture (which
    launches nothing) not at all, every replay as its capture counted; the
    warm-up's counts are kept apart (stand-in classes, capture flagged by
    patching ``torch.cuda.is_current_stream_capturing``)."""
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    kern = types.SimpleNamespace(LAUNCHES={"pvq_attn_q": 0, "pvq_encode_batch": 0})

    def attention_prefill_chunk():
        kern.LAUNCHES["pvq_attn_q"] += 3

    attention = types.SimpleNamespace(attention_prefill_chunk=attention_prefill_chunk)

    class Paged:
        def graft_chunk(self):
            kern.LAUNCHES["pvq_encode_batch"] += 2

        def append(self):
            kern.LAUNCHES["pvq_encode_batch"] += 1

    class Net:
        def prefill_chunk(self):
            attention.attention_prefill_chunk()
            Paged().graft_chunk()

    class Step:
        def __init__(self, fn, device):
            fn()
            capturing[0] = True
            try:
                fn()
            finally:
                capturing[0] = False

        def replay(self):
            return "out"

    class Engine:
        def warmup(self):
            self.chunk = Step(lambda: Net().prefill_chunk(), None)
            self.fill = Step(lambda: Paged().append(), None)

    with chip_smoke().launches_by_caller(torch, kern, attention, Paged, Net, Step,
                                         Engine) as (counts, warm):
        eng = Engine()
        eng.warmup()
        assert [eng.chunk.replay() for _ in range(5)] == ["out"] * 5
        eng.fill.replay()
        eng.fill.replay()
    assert warm == {"v4_from_chunk": 3, "encoder_from_graft": 2, "encoder_from_append": 1,
                    "chunks_run": 1}
    assert counts == {"v4_from_chunk": 18, "encoder_from_graft": 12, "encoder_from_append": 3,
                      "chunks_run": 6}
    assert Step.replay.__name__ == "replay" and Engine.warmup.__name__ == "warmup"
    assert Net.prefill_chunk.__name__ == "prefill_chunk"

def test_paged_tables_are_static_buffers():
    """``with_tables`` copies into the pool's device tables (a captured step
    reads them by address) and keeps a host ``write_page`` on the host;
    ``bind_tables`` shares one pair between layers."""
    kvq = port_q.KVQuant(8, 16)
    a = port_packed.PagedKV.init(2, 6, 4, 2, 16, kvq=kvq, dtype=torch.float32, device="cpu")
    b = port_packed.PagedKV.init(2, 6, 4, 2, 16, kvq=kvq, dtype=torch.float32, device="cpu")
    table, write = a.page_table, a.write_page_dev
    pt = np.arange(8, dtype=np.int32).reshape(2, 4)
    a.with_tables(pt, np.asarray([3, 6], np.int32))
    assert a.page_table is table and a.page_table.tolist() == pt.tolist()
    assert a.write_page.tolist() == [3, 6] and a.write_page_dev.tolist() == [6, 6]
    a.with_tables(table, torch.tensor([1, 6]))
    assert a.write_page_dev is write and a.write_page_dev.tolist() == [1, 6]
    b.bind_tables(a.page_table, a.write_page_dev)
    a.with_tables(pt[::-1].copy(), torch.tensor([6, 2]))
    assert b.page_table.tolist() == pt[::-1].tolist() and b.write_page_dev.tolist() == [6, 2]


# ---------------------------------------------------------------------------
# the engine's prefill, graft and chunk steps at device indices
# ---------------------------------------------------------------------------

PAGE, TRASH = 8, 6

# (slot, start, real_len, page ids of the chunk's two blocks): chunks of 16
# tokens of a context, as the chunk scheduler cuts them
GRAFT_CASES = {
    "first": (1, 0, 21, [3, 0]),
    "middle": (1, 16, 45, [4, 1]),
    "final_partial": (0, 32, 45, [2, TRASH]),
    "real_len_on_a_page_boundary": (1, 16, 32, [5, 1]),
    "all_trash": (0, 32, 37, [TRASH, TRASH]),
}


def _pool():
    kvq = port_q.KVQuant(PAGE, 16)
    pool = port_packed.PagedKV.init(2, TRASH, 6, 2, 16, kvq=kvq, dtype=torch.bfloat16,
                                    device="cpu")
    gen = torch.Generator().manual_seed(5)
    for name in ("tail_k", "tail_v"):  # rings another graft left behind
        getattr(pool, name).copy_(torch.randn(getattr(pool, name).shape, generator=gen))
    return pool


@pytest.mark.parametrize("case", list(GRAFT_CASES))
def test_device_index_graft_chunk_writes_the_host_int_bytes(case):
    """One chunk grafted at host ints and at device indices into two equal
    pools: identical bytes in every real page and scale and in both rings
    (the device form also writes the trash page, which nothing reads); the
    slot's gathered view the same through a host or a device slot."""
    slot, start, real_len, ids = GRAFT_CASES[case]
    rng = np.random.default_rng(start + real_len)
    k, v = (torch.from_numpy(rng.standard_normal((1, 2 * PAGE, 2, 16)).astype(np.float32))
            for _ in range(2))
    host, dev = _pool(), _pool()
    host.graft_chunk(k, v, slot, np.asarray(ids, np.int32), start, real_len)
    dev.graft_chunk(k, v, torch.tensor([slot]), torch.tensor(ids), torch.tensor([start]),
                    torch.tensor([real_len]))
    real = slice(0, TRASH)
    for name in ("k_pages", "k_page_scales", "v_pages", "v_page_scales"):
        assert torch.equal(getattr(host, name)[real], getattr(dev, name)[real]), name
    assert torch.equal(host.tail_k, dev.tail_k) and torch.equal(host.tail_v, dev.tail_v)
    live = [pid for pid in ids if pid != TRASH]
    assert all(host.k_pages[pid].abs().sum() > 0 for pid in live)
    pt = torch.tensor([[3, 0, 4, 1, 2, 5], [5, 2, 1, 4, 0, 3]], dtype=torch.int32)
    host.with_tables(pt, np.full((2,), TRASH, np.int32))
    dev.with_tables(pt, np.full((2,), TRASH, np.int32))
    one_host, one_dev = host.gather_slot(slot), dev.gather_slot(torch.tensor([slot]))
    for name in ("k_pulses", "v_scales", "tail_k", "tail_v"):
        assert torch.equal(getattr(one_host, name), getattr(one_dev, name)), name


def _chunked_context(model, params, device_index: bool):
    """A 37-token context of slot 1 in chunks of 16 through
    ``Model.prefill_chunk`` at host ints or device indices: the logits of
    each chunk and the paged cache."""
    cache = model.init_paged_cache(2, 10, 6, device="cpu")
    pt = np.full((2, 6), 10, np.int32)
    pt[1, :4] = [7, 2, 5, 0]
    for leaf in port_engine._paged_leaves(cache):
        leaf.with_tables(torch.from_numpy(pt), np.full((2,), 10, np.int32))
    ctx = np.random.default_rng(9).integers(0, model.cfg.vocab_size, 37)
    out = []
    for start in (0, 16, 32):
        toks = np.zeros((1, 16), np.int64)
        toks[0, : min(16, 37 - start)] = ctx[start : start + 16]
        ids = np.asarray([pt[1, b] if b < 4 else 10 for b in (start // 8, start // 8 + 1)])
        args = (1, start, ids, 37)
        if device_index:
            args = (torch.tensor([1]), torch.tensor([start]), torch.from_numpy(ids),
                    torch.tensor([37]))
        logits, cache = model.prefill_chunk(params, cache, torch.from_numpy(toks), *args)
        out.append(logits)
    return out, cache


def test_prefill_chunk_at_device_indices_equals_host_ints(reduced):
    """Reduced smollm, served leg: the three chunks' logits (the last one
    read at the context's last token) and every real page identical."""
    model, params = reduced["smollm-360m"]
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(port_q.KVQuant(8, 16)):
        want, host = _chunked_context(model, params, device_index=False)
        got, dev = _chunked_context(model, params, device_index=True)
    for a, b in zip(want, got):
        assert a.shape == (1, 1, model.cfg.vocab_size) and torch.equal(a, b)
    for a, b in zip(port_engine._paged_leaves(host), port_engine._paged_leaves(dev)):
        for name in ("k_pages", "k_page_scales", "v_pages", "v_page_scales"):
            assert torch.equal(getattr(a, name)[:10], getattr(b, name)[:10]), name
        assert torch.equal(a.tail_k, b.tail_k) and torch.equal(a.tail_v, b.tail_v)


# (engine arguments, prompt lengths): an evicting pool, and batched
# admissions of fewer rows than prefill_batch
ENGINE_CASES = {
    "evicting": (dict(n_slots=3, n_pages=4, max_len=32), (6, 12)),
    "short_batches": (dict(n_slots=3, prefill_batch=2, max_len=24), (6, 12)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_device_index_steps_equal_the_host_index_steps(reduced, case):
    model, params = reduced["smollm-360m"]
    eng_kw, lens = ENGINE_CASES[case]
    runs = {}
    with port_q.act_quant_scope(port_q.ActQuant()), port_q.kv_quant_scope(port_q.KVQuant(8, 16)):
        for eager in (True, False):
            trace = port_engine.poisson_trace(6, rate=0.0, vocab=model.cfg.vocab_size,
                                              prompt_lens=lens, max_new=8, seed=2)
            eng = port_engine.PVQEngine(model, params, eager=eager, **eng_kw)
            eng.warmup([len(r.prompt) for r in trace])
            runs[eager] = (eng.run(trace), eng)
    (want, host), (got, dev) = runs[True], runs[False]
    assert got["outputs"] == want["outputs"] and got["generated_tokens"] == 48
    assert got["trace_counts"] == {"decode": 0, "prefill": 0, "graft": 0, "chunk": 0}
    if case == "evicting":
        assert got["evictions"] == want["evictions"] > 0
    else:
        assert got["prefill_rows"] < 2 * got["prefill_batches"]
    for a, b in zip(port_engine._paged_leaves(host.cache), port_engine._paged_leaves(dev.cache)):
        real = slice(0, a.trash_page)
        for name in ("k_pages", "k_page_scales", "v_pages", "v_page_scales"):
            assert torch.equal(getattr(a, name)[real], getattr(b, name)[real]), name
        assert torch.equal(a.tail_k, b.tail_k) and torch.equal(a.tail_v, b.tail_v)
