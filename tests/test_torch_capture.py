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
* the launch-count arithmetic a replay relies on, and ``PagedKV``'s static
  tables (copied into, never replaced).

The card's side (capture, replay, bit-identity with the eager step) is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import packed as port_packed
from repro_torch.core import quantize as port_q
from repro_torch.core.packed import quantize_params
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
