"""Process-wide observability: metrics registry + span tracing.

One registry serves the whole serve stack — the continuous-batching
engine, the fixed-batch ``serve.py`` legs, the kernel autotuner, the
``.pvqz`` artifact codecs, and the quantization-quality probes — so a
regression in speed *or* numerics shows up as data in one place instead
of ad-hoc ``perf_counter`` prints scattered per layer.

Instruments
-----------
* :class:`Counter` — monotonically increasing value (``inc``/``add``).
* :class:`Gauge` — last-value instrument with min/max/n tracking.
* :class:`Histogram` — value distribution with **exact** percentiles:
  every recorded value is kept verbatim up to ``max_samples`` and
  ``percentile(q)`` is ``np.percentile`` over the stored values; beyond
  the cap a deterministic reservoir keeps a uniform sample and the
  snapshot flags ``exact: false``.  This is THE percentile type — the
  engine report and the benchmark latency helpers all route through it
  (no more inline ``pct`` copies).

All three are keyed by ``(name, labels)`` in the registry; labels are an
optional flat ``{str: str}`` dict (e.g. ``{"codec": "golomb"}``).

Tracing
-------
``registry.span(name, args=...)`` is a context manager recording a
Chrome trace-event *complete* event (``ph: "X"``) with microsecond
timestamps while the registry is enabled, and an event of the same name
in ``torch.profiler``'s trace while a profiler runs, whatever the
registry: there it shares the profiler's clock with the kernels, so a
reader of the trace sees what the host was doing in every gap of the
device.  The profiler's event is a function-scope ``RecordFunction``
(``torch._C._profiler._RecordFunctionFast``), not a user annotation, so
Kineto adds no device-side copy of it and the trace's device events are
those of a run without spans.  A span whose name ends in ``_wait`` is one
in which the host waits for the device (a read of the step's tokens, a
synchronisation).  ``trace_counter(name, value)`` records a counter-track event
(``ph: "C"``) that perfetto renders as a time series (the engine emits
queue-depth and page-pool-free this way every decode step).
``export_chrome_trace`` writes a ``trace.json`` loadable in
https://ui.perfetto.dev (open the file directly) or ``chrome://tracing``.

Hot-path contract
-----------------
A **disabled** registry is a true no-op: ``counter()``/``gauge()``/
``histogram()`` return the shared :data:`NOOP` singleton and allocate
nothing, and so does ``span()`` unless a profiler runs.  Call sites on hot
loops additionally guard with ``obs.enabled()`` (instruments) or
``obs.tracing()`` (a span's arguments) so not even argument tuples are
built.  A running profiler enables spans only: instruments and the
quantization probes, which read tensors back to the host, follow
``enabled`` alone.  Nothing in
this module is ever traced into a jit body — instrumentation lives in
host-side serving loops, and the eager-only quantization probes bail out
when handed a tracer.

Export
------
* ``export_metrics_jsonl(path)`` — one JSON object per line, schema
  ``repro-metrics-v1`` (see :data:`METRICS_SCHEMA`); round-trips through
  :func:`read_metrics_jsonl` / :func:`validate_metrics_jsonl`.
* ``export_chrome_trace(path)`` — ``{"traceEvents": [...]}`` JSON;
  validated by :func:`validate_chrome_trace`.
* ``write(outdir)`` — both files into a directory (the
  ``serve --metrics-out DIR`` exit hook).

``python -m repro_torch.runtime.telemetry --validate DIR`` runs both
validators (the CI schema gate); ``--require-engine`` additionally
asserts the engine spans/gauges/autotune counters/quant probes the
serve smoke must emit.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from torch._C._autograd import _profiler_enabled as profiling
from torch._C._profiler import _RecordFunctionFast

METRICS_SCHEMA = "repro-metrics-v1"

#: snapshot keys every histogram line carries (the JSONL schema contract)
HISTOGRAM_FIELDS = ("count", "sum", "min", "max", "p50", "p90", "p99", "exact")


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, n: float = 1) -> None:
        self.value += n

    add = inc

    def snapshot(self) -> Dict[str, Any]:
        v = self.value
        return {
            "kind": "counter", "name": self.name, "labels": self.labels,
            "value": int(v) if float(v).is_integer() else v,
        }


class Gauge:
    """Last-value instrument (plus min/max/n over the run)."""

    __slots__ = ("name", "labels", "value", "min", "max", "n")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.n = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.n += 1

    def snapshot(self) -> Dict[str, Any]:
        return {
            "kind": "gauge", "name": self.name, "labels": self.labels,
            "value": self.value, "min": self.min, "max": self.max, "n": self.n,
        }


class Histogram:
    """Distribution with exact reservoir percentiles.

    Values are stored verbatim up to ``max_samples``; past the cap a
    deterministic reservoir (seeded RNG, so runs reproduce) keeps a
    uniform sample and ``exact`` flips to False.  ``count``/``sum``/
    ``min``/``max`` stay exact regardless.
    """

    __slots__ = ("name", "labels", "max_samples", "count", "total",
                 "min", "max", "_values", "_rng")

    def __init__(
        self, name: str = "", labels: Optional[Dict[str, str]] = None,
        *, max_samples: int = 65536,
    ):
        self.name = name
        self.labels = dict(labels or {})
        self.max_samples = int(max_samples)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._values: List[float] = []
        self._rng = random.Random(0)

    @classmethod
    def from_values(cls, values, name: str = "") -> "Histogram":
        h = cls(name)
        for v in values:
            h.record(v)
        return h

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._values) < self.max_samples:
            self._values.append(v)
        else:  # reservoir sampling: uniform over everything seen so far
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self._values[j] = v

    def record_many(self, values) -> None:
        for v in values:
            self.record(v)

    @property
    def exact(self) -> bool:
        return self.count == len(self._values)

    def percentile(self, q: float) -> float:
        """Exact percentile over the stored values (0.0 when empty)."""
        if not self._values:
            return 0.0
        return float(np.percentile(np.asarray(self._values), q))

    def snapshot(self) -> Dict[str, Any]:
        return {
            "kind": "histogram", "name": self.name, "labels": self.labels,
            "count": self.count, "sum": self.total,
            "min": self.min, "max": self.max,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99), "exact": self.exact,
        }


class _Noop:
    """Shared do-nothing instrument AND context manager returned by a
    disabled registry — one singleton, so the disabled path never
    allocates."""

    __slots__ = ()

    def inc(self, n: float = 1) -> None:
        pass

    add = inc

    def set(self, v: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def record_many(self, values) -> None:
        pass

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Noop()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _Span:
    """Context manager recording one Chrome complete event (``ph: X``) into
    ``reg`` (None: the registry is off) and, with ``profiled``, one event
    in the running profiler's trace."""

    __slots__ = ("_reg", "name", "args", "_t0", "_rf")

    def __init__(self, reg: Optional["MetricsRegistry"], name: str, args: Optional[dict],
                 profiled: bool):
        self._reg = reg
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._rf = _RecordFunctionFast(name) if profiled else None

    def __enter__(self) -> "_Span":
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._reg is not None:
            self._reg._record_span(self.name, self._t0, t1, self.args)
        return False


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple:
    if not labels:
        return (name,)
    return (name,) + tuple(sorted(labels.items()))


class MetricsRegistry:
    """Process-wide metric + trace store.

    ``enabled=False`` (the default for the module registry) turns every
    accessor into a :data:`NOOP` return — zero instrument allocation,
    zero recording, nothing on the decode hot path.
    """

    def __init__(self, *, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._histograms: Dict[Tuple, Histogram] = {}
        self._events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    # ------------------------------------------------------------ lifecycle

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._events.clear()
            self._t0 = time.perf_counter()

    # ----------------------------------------------------------- instruments

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None):
        if not self.enabled:
            return NOOP
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(k, Counter(name, labels))
        return c

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None):
        if not self.enabled:
            return NOOP
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(k, Gauge(name, labels))
        return g

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None):
        if not self.enabled:
            return NOOP
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(k, Histogram(name, labels))
        return h

    # --------------------------------------------------------------- tracing

    def span(self, name: str, args: Optional[dict] = None):
        profiled = profiling()
        if not self.enabled and not profiled:
            return NOOP
        return _Span(self if self.enabled else None, name, args, profiled)

    def _record_span(self, name: str, t0: float, t1: float, args) -> None:
        ev = {
            "name": name, "ph": "X", "pid": self._pid,
            "tid": threading.get_ident() & 0xFFFF,
            "ts": round(1e6 * (t0 - self._t0), 1),
            "dur": round(1e6 * (t1 - t0), 1),
        }
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def trace_counter(self, name: str, value: float) -> None:
        """Counter-track event (``ph: C``): a per-step time series that
        perfetto renders as its own track (queue depth, free pages, ...)."""
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": "C", "pid": self._pid,
            "ts": round(1e6 * (time.perf_counter() - self._t0), 1),
            "args": {"value": float(value)},
        }
        with self._lock:
            self._events.append(ev)

    def event(self, name: str, args: Optional[dict] = None) -> None:
        """Instant event (``ph: i``) — admissions, evictions, retires."""
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": "i", "s": "p", "pid": self._pid,
            "tid": threading.get_ident() & 0xFFFF,
            "ts": round(1e6 * (time.perf_counter() - self._t0), 1),
        }
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    # ---------------------------------------------------------------- export

    def snapshot(self) -> List[Dict[str, Any]]:
        """All instruments as schema-stamped dicts (one JSONL line each)."""
        with self._lock:
            instruments = (
                list(self._counters.values())
                + list(self._gauges.values())
                + list(self._histograms.values())
            )
        out = []
        for inst in instruments:
            rec = {"schema": METRICS_SCHEMA}
            rec.update(inst.snapshot())
            out.append(rec)
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self._events)
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def export_metrics_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for rec in self.snapshot():
                f.write(json.dumps(rec) + "\n")
        return str(path)

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return str(path)

    def write(self, outdir: str) -> Dict[str, str]:
        """Write ``metrics.jsonl`` + ``trace.json`` into ``outdir``."""
        os.makedirs(outdir, exist_ok=True)
        return {
            "metrics": self.export_metrics_jsonl(
                os.path.join(outdir, "metrics.jsonl")
            ),
            "trace": self.export_chrome_trace(
                os.path.join(outdir, "trace.json")
            ),
        }


# ---------------------------------------------------------------------------
# module registry (the `obs` facade delegates here)
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_enabled(on: bool) -> bool:
    """Flip the module registry; returns the previous state."""
    prev = _REGISTRY.enabled
    _REGISTRY.enabled = bool(on)
    return prev


def tracing() -> bool:
    """Whether a span would record: the module registry is enabled or a
    ``torch.profiler`` runs."""
    return _REGISTRY.enabled or profiling()


# ---------------------------------------------------------------------------
# shared helpers (probes)
# ---------------------------------------------------------------------------


def snr_db(ref: np.ndarray, approx: np.ndarray, cap: float = 99.0) -> float:
    """Reconstruction signal-to-noise ratio in dB (capped for exact hits)."""
    ref = np.asarray(ref, np.float64).ravel()
    err = np.asarray(approx, np.float64).ravel() - ref
    sig = float(np.sum(ref * ref))
    noise = float(np.sum(err * err))
    if noise <= 0.0:
        return cap
    if sig <= 0.0:
        return 0.0
    return min(10.0 * np.log10(sig / noise), cap)


# ---------------------------------------------------------------------------
# validation (tests + the CI schema gate)
# ---------------------------------------------------------------------------


def read_metrics_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def validate_metrics_jsonl(path: str) -> List[Dict[str, Any]]:
    """Schema-check a metrics JSONL file; returns the records or raises."""
    recs = read_metrics_jsonl(path)
    for i, rec in enumerate(recs):
        where = f"{path}:{i + 1}"
        if rec.get("schema") != METRICS_SCHEMA:
            raise ValueError(f"{where}: bad schema {rec.get('schema')!r}")
        kind = rec.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"{where}: bad kind {kind!r}")
        if not isinstance(rec.get("name"), str) or not rec["name"]:
            raise ValueError(f"{where}: missing metric name")
        if not isinstance(rec.get("labels"), dict):
            raise ValueError(f"{where}: labels must be a dict")
        if kind == "counter" and not isinstance(rec.get("value"), (int, float)):
            raise ValueError(f"{where}: counter needs a numeric value")
        if kind == "histogram":
            for field in HISTOGRAM_FIELDS:
                if field not in rec:
                    raise ValueError(f"{where}: histogram missing {field!r}")
    return recs


def validate_chrome_trace(path: str) -> List[Dict[str, Any]]:
    """Check a trace file is perfetto-loadable trace-event JSON."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents must be a list")
    for i, ev in enumerate(events):
        where = f"{path}: traceEvents[{i}]"
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"{where}: missing event name")
        if ev.get("ph") not in ("X", "C", "i", "B", "E", "M"):
            raise ValueError(f"{where}: bad phase {ev.get('ph')!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"{where}: missing ts")
        if ev["ph"] == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"{where}: complete event missing dur")
    return events


#: names the engine serve smoke must cover (engine spans, page-pool/queue
#: gauges, autotune counters, quant-quality probes)
ENGINE_REQUIRED_SPANS = ("engine/prefill", "engine/graft", "engine/decode_step")
ENGINE_REQUIRED_METRICS = (
    "engine.page_pool_free", "engine.queue_depth",
    "autotune.lookups", "quant.weight_snr_db", "quant.kv_snr_db",
)


def validate_dir(outdir: str, *, require_engine: bool = False) -> Dict[str, int]:
    """Validate ``metrics.jsonl`` + ``trace.json`` in ``outdir``."""
    recs = validate_metrics_jsonl(os.path.join(outdir, "metrics.jsonl"))
    events = validate_chrome_trace(os.path.join(outdir, "trace.json"))
    if require_engine:
        names = {r["name"] for r in recs}
        missing = [m for m in ENGINE_REQUIRED_METRICS if m not in names]
        span_names = {e["name"] for e in events}
        missing += [s for s in ENGINE_REQUIRED_SPANS if s not in span_names]
        if missing:
            raise ValueError(
                f"{outdir}: engine telemetry incomplete, missing {missing}"
            )
    return {"metrics": len(recs), "trace_events": len(events)}


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="validate telemetry exports")
    ap.add_argument("--validate", metavar="DIR", required=True,
                    help="directory holding metrics.jsonl + trace.json")
    ap.add_argument("--require-engine", action="store_true",
                    help="additionally require the engine serve-smoke "
                    "span/metric coverage")
    args = ap.parse_args()
    counts = validate_dir(args.validate, require_engine=args.require_engine)
    print(json.dumps({"ok": True, "dir": args.validate, **counts}))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
