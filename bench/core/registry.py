"""Find a cell, a configuration, a traffic mix, a per-layer metric, a
driver and a reference model by name: each is a file of its own under
``bench/``, and ``BENCHMARK.json`` at the root of the checkout says which
metrics a cell reports."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return _json(BENCH / "cells" / f"{name}.json")


def config(name: str) -> dict:
    """The configuration as it runs: the file's keys, which are the
    source's, with the program's departures from the source
    (``port_departures``) put in their place."""
    cfg = _json(BENCH / "configs" / f"{name}.json")
    cfg.update(cfg.get("port_departures", {}))
    return cfg


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def metric_module(name: str) -> ModuleType:
    """``bench/metrics/<name>.py``, loaded by its path (a metric's name has
    dots, which no import statement takes)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    """``bench/drivers/<name>.py``: what drives a cell's window (its
    ``run(Run)``) and works out its reference logits."""
    return importlib.import_module(f"bench.drivers.{name}")


def reference(name: str) -> ModuleType:
    """``bench/reference/<name>.py``, the plain model a configuration file
    names under ``reference``."""
    return importlib.import_module(f"bench.reference.{name}")


def _listed(entry: dict, workload: str, reported: List[str]) -> bool:
    if "workloads" in entry:
        return workload in entry["workloads"]
    return entry.get("moves") in reported if "moves" in entry else True


def metrics_of(workload: str, bench: dict) -> Dict[str, List[dict]]:
    """The cell's end-to-end metrics and per-layer metrics, as listed."""
    e2e = [m for m in bench["end_to_end"] if _listed(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _listed(m, workload, names)]
    return {"end_to_end": e2e, "per_layer": per_layer}
