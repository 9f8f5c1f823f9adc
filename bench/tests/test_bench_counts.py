"""The roofline count functions against hand counts at small shapes, and
the trace's reduction on a made-up timeline."""

from types import SimpleNamespace

import pytest
import torch

from bench.core import counts, peaks, registry, trace


def test_k_pad_follows_the_packed_layout():
    assert counts.k_pad(960, 256) == (1024, 256)
    assert counts.k_pad(2560, 256) == (2560, 256)
    assert counts.k_pad(64, 256) == (64, 64)
    assert counts.k_pad(96, 256) == (96, 32)


def test_v3_counts_by_hand():
    # m 2, k 300 (padded to 512 at group 256), n 3
    ops, nb = counts.v3(2, 300, 3, 256)
    assert ops == 2 * 2 * 300 * 3
    assert nb == 512 * 3 + 4 * 2 * 3 + 2 * 512 + 4 * 2 + 4 * 2 * 3


def test_batched_v3_counts_every_expert_and_the_routed_pairs():
    ops, nb = counts.v3_batched(4, 6, 256, 8, 256)
    assert ops == 2 * 6 * 256 * 8
    assert nb == 4 * (256 * 8 + 4 * 8) + 6 * 256 + 4 * 6 + 4 * 6 * 8


def test_v4_counts_by_hand():
    ops, nb = counts.v4(rows=3, kv_len=64, head_dim=64, group=32)
    assert ops == 4 * 3 * 64 * 64
    assert nb == 64 * (2 * 64 + 2 * 4 * 2) + 3 * 64 + 4 * 3 + 4 * 3 * 64 + 8 * 3


def test_a_smollm_decode_step_meets_seven_matrices_a_layer():
    s = counts.Shapes.of(registry.config("smollm-360m"))
    calls = counts.step_calls(s, rows=4, head_rows=4)
    assert len(calls) == 32 * 7  # the tied head is not a packed matmul
    tot = counts.total(calls, "v3")
    per_layer_pulses = 1024 * (960 + 320 + 320) + 960 * 960 + 1024 * 2560 * 2 + 2560 * 960
    assert tot["bytes"] > 32 * per_layer_pulses
    assert tot["bound_s"] == pytest.approx(sum(peaks.bound_s(o, b) for _, o, b in calls))


def test_a_deepseek_step_meets_six_matrices_a_layer_the_banks_and_the_head():
    s = counts.Shapes.of(registry.config("deepseek-v2-lite-16b"))
    calls = counts.step_calls(s, rows=64, head_rows=64)
    assert sum(1 for c in calls if c[0] == "v3") == 27 * 6 + 1
    assert sum(1 for c in calls if c[0] == "v3_batched") == 26 * 3
    banks = counts.total(calls, "v3_batched")
    # every expert's pulses, about 15 GB a step
    assert 14e9 < banks["bytes"] < 16.5e9


def test_model_ops_by_hand_for_a_dense_model():
    s = counts.Shapes(layers=1, d=4, heads=2, kv_heads=1, head_dim=2, ff=8, vocab=10, group=4,
                      kv_group=2)
    a, b = counts.model_ops(s, head=True)
    mats = 4 * 4 + 4 * 2 + 4 * 2 + 4 * 4 + 3 * 4 * 8
    assert a == 2 * mats + 2 * 4 * 10
    assert b == 4 * 2 * 2
    assert counts.model_ops_per_token(s, 5, False) == 2 * mats + 5 * b


def test_a_training_step_counts_three_passes_at_every_position_until_the_profiler():
    from bench.core import model_step, peaks

    s = counts.Shapes(layers=1, d=4, heads=2, kv_heads=1, head_dim=2, ff=8, vocab=10, group=4,
                      kv_group=2)
    a, b = counts.model_ops(s, head=True)
    steps = [{"start": 1.0}, {"start": 2.0}, {"start": 5.0}]
    run = SimpleNamespace(obs={"shapes": s, "steps": steps, "t_first": 1.0, "t_end": 7.0,
                               "t_trace": 4.0, "batch": 2, "seq": 3})
    per_row = 3 * a + b * (1 + 2 + 3)
    want = 100.0 * 3 * per_row * 2 * 2 / (4.0 - 1.0) / peaks.BF16_FLOPS_PER_S
    assert model_step.train_mfu(run) == pytest.approx(want)


def _prof(events):
    dev = torch.autograd.DeviceType.CUDA
    return SimpleNamespace(events=lambda: [
        SimpleNamespace(name=n, device_type=dev, time_range=SimpleNamespace(start=a, end=b))
        for n, a, b in events])


def test_the_reduction_splits_steps_by_markers_and_finds_idle_gaps():
    m = trace.MARKER
    evs = [("k_pre", 0, 10), (m, 10, 11), ("k1", 12, 20), ("k2", 20, 30), ("Memcpy HtoD", 30, 31),
           (m, 31, 32), ("eager", 50, 60), (m, 60, 61), ("k3", 61, 70), (m, 100, 101)]
    s = trace.reduce(_prof(evs), ["decode", "decode", "chunk", "chunk"], window_s=200e-6)
    assert s.markers_ok
    assert [(k, [e.name for e in evs_]) for k, evs_ in s.steps] == \
        [("decode", ["k1", "k2"]), ("chunk", ["k3"])]
    assert s.busy_s == pytest.approx((10 + 8 + 10 + 1 + 10 + 9) * 1e-6)
    assert s.kernels("k")[1] == 3 + 1  # k_pre, k1, k2, k3
    assert s.kernels("k", kind="decode") == (pytest.approx(18e-6), 2)
    gaps = dict(trace.idle_gaps(s))
    # 31 .. 50 and the chunk's leading marker 60 .. 61 follow the decode step
    assert gaps == {"after decode": pytest.approx(20e-6),
                    "before the first step": pytest.approx(2e-6)}


def test_a_lost_marker_is_noticed():
    m = trace.MARKER
    s = trace.reduce(_prof([(m, 0, 1), ("k", 1, 2)]), ["decode", "decode"], window_s=1e-6)
    assert not s.markers_ok and s.steps == []
