"""Observability layer for the serving stack.

Stdlib-only apart from the tracer's optional ``torch.profiler`` bridge
(off unless ``Tracer.enable(profiler_annotations=True)`` asks for it):

  * :mod:`repro_torch.obs.trace` — a nestable span tracer with a no-op fast
    path when disabled, exporting Chrome trace-event JSON loadable in
    Perfetto (``chrome://tracing`` / https://ui.perfetto.dev).  The
    serving stack is instrumented end to end: scheduler ticks,
    admission, retirement, preemption, both engines' supersteps, kernel
    dispatch (including the sharded all-gather step), planner
    decisions, cache probes, and live-update application.
  * :mod:`repro_torch.obs.metrics` — counters, gauges, and log-bucketed
    latency histograms (p50/p99 without retaining samples), with a
    diffable ``snapshot()`` API, JSON-friendly export for benchmark
    rows, and Prometheus text exposition (served by
    :class:`repro_torch.core.scheduler.AsyncServer` when ``metrics_port`` is
    set).
  * :mod:`repro_torch.obs.explain` — per-query EXPLAIN/ANALYZE reports
    (planner decision, selectivity inputs, predicted collective bytes,
    and — when analyzing — the per-superstep frontier timeline with
    est-vs-actual frontier error), served over ``/explain``.
  * :mod:`repro_torch.obs.recorder` — the always-on flight recorder: a
    bounded ring buffer of settled-query records in the slot scheduler,
    dumped as a versioned JSONL workload that ``benchmarks/replay.py``
    re-executes with result-count parity (served over ``/flight``).

The module-level tracer is OFF by default; every instrumented call site
then costs one attribute read + one branch and allocates nothing
(``benchmarks/serving.py`` gates this with the ``tracer_off_overhead``
row).  Enable it around a region of interest::

    from repro_torch import obs
    obs.trace.TRACER.enable()
    ... serve ...
    obs.trace.TRACER.export("trace.json")   # open in Perfetto
"""
from . import explain, metrics, recorder, trace
from .explain import ExplainSink, analyze_query, explain_query, validate_report
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      diff_snapshots)
from .recorder import FlightRecorder
from .trace import NULL_SPAN, Tracer, bypass, instant, span, use

__all__ = [
    "explain", "metrics", "recorder", "trace",
    "ExplainSink", "analyze_query", "explain_query", "validate_report",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "diff_snapshots",
    "FlightRecorder",
    "NULL_SPAN", "Tracer", "bypass", "instant", "span", "use",
]
