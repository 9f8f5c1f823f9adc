"""The metric arithmetic: a tail over every request, latencies from the due
time, a stall that moves both tails, a rate over all work and all time."""

import math
from types import SimpleNamespace

import pytest

from bench.core import stats
from bench.drivers import batch, engine


def test_percentile_interpolates_over_every_value():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile(xs[::-1], 50) == pytest.approx(50.5)


def test_an_unserved_request_counts_as_infinitely_late():
    xs = [0.1] * 9 + [math.inf]
    assert stats.percentile(xs, 50) == 0.1
    assert stats.percentile(xs, 95) == math.inf
    assert stats.percentile([0.1] * 8 + [math.inf] * 2, 90) == math.inf


def _req(rid, arrival, first, finish, n, admit=None, prompt=(1, 2, 3)):
    return SimpleNamespace(rid=rid, arrival=arrival, prompt=list(prompt), generated=[0] * n,
                           max_new_tokens=n, first_token_t=first, finish_t=finish,
                           admit_t=admit if admit is not None else first, prefix_hit_pages=0)


def _records(reqs, t0=100.0):
    r = SimpleNamespace(cfg={"vocab_size": 10})
    eng = SimpleNamespace(finished=[q for q in reqs if q.finish_t is not None])
    return engine._records(r, eng, reqs, t0)


def test_latency_runs_from_the_due_time():
    # due at t0 + 1.0 = 101.0; released late, first token at 101.5
    (rec,) = _records([_req(0, 1.0, 101.5, 102.5, 11, admit=101.3)])
    assert rec["ttft_s"] == pytest.approx(0.5)
    assert rec["queue_s"] == pytest.approx(0.3)
    assert rec["tpot_s"] == pytest.approx(0.1)


def test_a_request_that_never_finished_is_infinitely_late():
    recs = _records([_req(0, 0.0, 100.1, 100.5, 5), _req(1, 0.0, None, None, 5)])
    assert [x["ok"] for x in recs] == [True, False]
    assert math.isinf(recs[1]["ttft_s"]) and math.isinf(recs[1]["tpot_s"])


def _load(stall_s):
    """40 requests, one every 0.25 s, each 0.2 s to its first token and 10
    tokens at 20 ms; a stall from t = 5 s holds every request due in it."""
    reqs = []
    for i in range(40):
        a = 0.25 * i
        first = 100.0 + a + 0.2
        if 5.0 <= a < 5.0 + stall_s:
            first = 100.0 + 5.0 + stall_s + 0.2
        reqs.append(_req(i, a, first, first + 9 * (0.02 + (stall_s / 9 if 5.0 <= a < 6.0 else 0)),
                         10))
    recs = _records(reqs)
    return (1e3 * stats.percentile([x["ttft_s"] for x in recs], 90),
            1e3 * stats.percentile([x["tpot_s"] for x in recs], 90))


def test_a_stall_moves_both_tails():
    calm_ttft, calm_tpot = _load(0.0)
    ttft, tpot = _load(2.0)
    assert calm_ttft == pytest.approx(200.0)
    assert calm_tpot == pytest.approx(20.0)
    assert ttft > 1.5 * calm_ttft
    assert tpot > 1.5 * calm_tpot


def test_a_rate_is_all_work_over_all_time():
    calls = [{"start": 10.0, "end": 12.0}, {"start": 12.0, "end": 14.5}]
    # 2 calls x 4 sequences x 5 tokens over 10.0 .. 14.5
    assert batch.output_rate(calls, 10.0, 4, 5) == pytest.approx(40 / 4.5)


def test_the_reference_reads_pages_where_the_engine_schedule_paged():
    cell = {"engine": {"prefill_chunk": 2}}  # chunks of 2 pages of 4
    whole = {"prompt": [0] * 6, "generated": [0] * 4, "hit_pages": 0}
    assert engine.cuts_of(whole, cell, 4) == [0] * 6 + [4, 8, 8]
    chunked = {"prompt": [0] * 12, "generated": [0] * 2, "hit_pages": 0}
    assert engine.cuts_of(chunked, cell, 4) == [0] * 8 + [8] * 4 + [12]
    resumed = {"prompt": [0] * 14, "generated": [0] * 2, "hit_pages": 1}
    assert engine.cuts_of(resumed, cell, 4) == [0] * 4 + [4] * 8 + [12] * 2 + [12]
