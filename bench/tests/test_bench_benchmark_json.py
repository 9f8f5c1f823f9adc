"""``BENCHMARK.json`` against its contract and against the files the
harness finds by name."""

import json
import re

import pytest

from bench.core import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|head|latent|state|proj|expansion|"
                   r"experts_per_tok")

BENCH = registry.benchmark()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _reports(workload, metric):
    m = E2E[metric]
    return "workloads" not in m or workload in m["workloads"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= len(BENCH["paths"]) <= 16
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check with 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_unit_and_layer_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS) + list(E2E) + \
        [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"] and "\t" not in m["layer"]
    for x in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_every_per_layer_metric_moves_a_metric_each_of_its_cells_reports():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E, m
        for w in m.get("workloads", CELLS):
            assert w in CELLS and _reports(w, m["moves"]), (m["name"], w)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for w in CELLS:
        listed = registry.metrics_of(w, BENCH)
        assert len(listed["end_to_end"]) >= 2 and listed["per_layer"], w


def test_bounds_are_within_their_range():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_configuration_keeps_a_cell_and_no_cell_asks_for_four_chips():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_a_configuration_file_says_what_runs_and_what_was_changed(cfg):
    assert cfg["file"] == f"bench/configs/{cfg['name']}.json"
    with open(registry.BENCH / "configs" / f"{cfg['name']}.json") as f:
        body = json.load(f)
    assert body["source"] == cfg["source"]
    # ``reduced`` names cuts of scale only, each with its reason in the file;
    # where the program computes something else than the source states, the
    # file keeps the source's value and names the program's beside it
    assert sorted(body["reduced"]) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert not WIDTH.search(key), key
    assert sorted(body.get("port_departures", {})) == sorted(body.get("port_departures_why", {}))
    assert not set(body.get("port_departures", {})) & set(cfg["reduced"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(w):
    cell = registry.cell(w["name"])
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    assert callable(registry.driver(cell["driver"]).run)
    assert callable(registry.reference(registry.config(w["config"])["reference"]).forward)
    registry.traffic(w["traffic"])
    assert cell["check"] and all(v > 0 for v in cell["check"].values())


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(m):
    mod = registry.metric_module(m["name"])
    assert (mod.LAYER, mod.MOVES, mod.UNIT) == (m["layer"], m["moves"], m["unit"])
    assert callable(mod.read)
