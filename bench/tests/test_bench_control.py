"""The control at a size a test run holds, on three seeds: the reference
computed with int4 activations where the configuration states int8 (or,
for training, with float8 products where it states bfloat16), in the
program's place, comes out as not correct, while the program passes."""

import time

import pytest

from bench import control
from bench.tests import _tiny

CASES = {
    "engine": (_tiny.engine_cell, _tiny.smollm_cfg, _tiny.chat_mix, 2.0),
    "batch": (_tiny.batch_cell, _tiny.deepseek_cfg, _tiny.batch_mix, 0.5),
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("which", sorted(CASES))
def test_the_control_fails_the_comparison_the_program_passes(which, seed):
    cell_fn, cfg_fn, mix_fn, seconds = CASES[which]
    cell = cell_fn()
    out = control.readings("tiny", cell, cfg_fn(), mix_fn(), seed=seed, seconds=seconds,
                           device="cpu", t_process=time.perf_counter())
    limit = cell["check"]["max_logit_gap"]
    assert out["program"]["max_logit_gap"] <= limit < out["control"]["max_logit_gap"], out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_training_control_fails_a_number_the_program_passes(seed):
    cell = _tiny.train_cell()
    out = control.readings("tiny", cell, _tiny.smollm_cfg(), _tiny.train_mix(), seed=seed,
                           seconds=0.5, device="cpu", t_process=time.perf_counter())
    limits = cell["check"]
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out
    assert any(out["half_batch"][k] > v for k, v in limits.items()), out
