"""Thin facade over :mod:`repro_torch.runtime.telemetry`.

Call sites import this module and stay one attribute away from the
process registry::

    from repro_torch.runtime import obs

    if obs.enabled():                      # hot paths guard first
        obs.counter("engine.decode_steps").inc()
    with obs.span("engine/prefill", args={"rows": n} if obs.tracing() else None):
        ...

Every accessor delegates to the module registry; when it is disabled
(the default) ``counter``/``gauge``/``histogram`` return the shared
:data:`~repro_torch.runtime.telemetry.NOOP` singleton, and so does
``span`` unless a ``torch.profiler`` runs, when it records into the
profiler's trace (:func:`tracing`).
"""

from __future__ import annotations

from typing import Dict, Optional

from . import telemetry

NOOP = telemetry.NOOP


def registry() -> telemetry.MetricsRegistry:
    return telemetry.get_registry()


def enabled() -> bool:
    return telemetry.get_registry().enabled


def tracing() -> bool:
    """Whether a span would record (the registry is enabled or a profiler
    runs): the guard of a span's arguments.  Instruments and probes follow
    :func:`enabled` alone."""
    return telemetry.tracing()


def set_enabled(on: bool) -> bool:
    """Enable/disable the process registry; returns the previous state."""
    return telemetry.set_enabled(on)


def counter(name: str, labels: Optional[Dict[str, str]] = None):
    return telemetry.get_registry().counter(name, labels)


def gauge(name: str, labels: Optional[Dict[str, str]] = None):
    return telemetry.get_registry().gauge(name, labels)


def histogram(name: str, labels: Optional[Dict[str, str]] = None):
    return telemetry.get_registry().histogram(name, labels)


def span(name: str, args: Optional[dict] = None):
    return telemetry.get_registry().span(name, args)


def trace_counter(name: str, value: float) -> None:
    telemetry.get_registry().trace_counter(name, value)


def event(name: str, args: Optional[dict] = None) -> None:
    telemetry.get_registry().event(name, args)


def write(outdir: str) -> Dict[str, str]:
    """Export ``metrics.jsonl`` + ``trace.json`` into ``outdir``."""
    return telemetry.get_registry().write(outdir)
