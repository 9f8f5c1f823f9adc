"""The traffic generator: determinism by seed, lengths inside their clips,
arrivals at the rate, and the same work for every seed."""

import numpy as np
import pytest

from bench.core import registry, traffic
from bench.tests import _tiny


@pytest.mark.parametrize("mix_name", ["chat", "agent"])
def test_poisson_is_a_function_of_the_seed(mix_name):
    mix = registry.traffic(mix_name)
    a = traffic.poisson(mix, 2**33 + 5, 20.0, 49152)
    b = traffic.poisson(mix, 2**33 + 5, 20.0, 49152)
    c = traffic.poisson(mix, 2**33 + 6, 20.0, 49152)
    assert a == b
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("mix_name", ["chat", "agent"])
def test_lengths_stay_inside_their_clips(mix_name):
    mix = registry.traffic(mix_name)
    extra = mix["prefixes"]["len"] if "prefixes" in mix else 0
    for r in traffic.poisson(mix, 7, 30.0, 1000):
        body = len(r.prompt) - extra
        assert mix["prompt"]["min"] <= body <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
        assert all(0 <= t < 1000 for t in r.prompt)


@pytest.mark.parametrize("mix_name", ["chat", "agent"])
def test_arrivals_come_at_the_rate_and_every_seed_replays_one_schedule(mix_name):
    mix = registry.traffic(mix_name)
    seconds = 40.0
    runs = [traffic.poisson(mix, s, seconds, 1000) for s in (1, 2, 3)]
    n = round(mix["rate_per_s"] * seconds)
    for reqs in runs:
        assert len(reqs) == n
        arrivals = [r.arrival for r in reqs]
        assert arrivals == sorted(arrivals)
        # the stratified gaps sum to just under the window
        assert 0.9 * seconds < arrivals[-1] <= seconds
    for reqs in runs[1:]:
        assert [(len(r.prompt), r.max_new, r.arrival, r.prefix) for r in reqs] == \
            [(len(r.prompt), r.max_new, r.arrival, r.prefix) for r in runs[0]]
    # the schedule is the mix's: another pattern seed orders the same sizes otherwise
    other = traffic.poisson(dict(mix, pattern_seed=mix["pattern_seed"] + 1), 1, seconds, 1000)
    assert sorted(len(r.prompt) for r in other) == sorted(len(r.prompt) for r in runs[0])
    assert [len(r.prompt) for r in other] != [len(r.prompt) for r in runs[0]]


def test_shared_prefixes_follow_their_zipf_counts():
    mix = registry.traffic("agent")
    reqs = traffic.poisson(mix, 11, 50.0, 1000)
    counts = np.bincount([r.prefix for r in reqs], minlength=4)
    w = np.arange(1, 5) ** -mix["prefixes"]["zipf_s"]
    assert np.all(np.abs(counts - w / w.sum() * len(reqs)) < 1.0)
    heads = {}
    for r in reqs:
        heads.setdefault(r.prefix, r.prompt[: mix["prefixes"]["len"]])
        assert r.prompt[: mix["prefixes"]["len"]] == heads[r.prefix]


def test_prompt_lengths_are_those_the_window_sends():
    mix = _tiny.chat_mix()
    sent = {len(r.prompt) for r in traffic.poisson(mix, 3, 5.0, 128)}
    assert sent == set(traffic.prompt_lengths(mix, 5.0))


def test_batch_tokens_by_seed_and_call():
    mix = registry.traffic("batch64")
    a = traffic.batch_tokens(mix, 2**34, 0, 102400)
    assert a.shape == (64, 512) and a.min() >= 0 and a.max() < 102400
    assert (a == traffic.batch_tokens(mix, 2**34, 0, 102400)).all()
    assert not (a == traffic.batch_tokens(mix, 2**34, 1, 102400)).all()
    assert not (a == traffic.batch_tokens(mix, 2**34 + 1, 0, 102400)).all()
