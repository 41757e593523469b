"""Span tracer: nestable wall-clock spans over the serving stack, with
a no-op fast path when disabled and Chrome trace-event JSON export.

Design constraints, in order:

1. **Disabled means free.**  The serving hot path calls
   :func:`span` on every scheduler tick and engine superstep; with the
   tracer off each call is one module-global read, one branch, and the
   return of a shared singleton (:data:`NULL_SPAN`) — no allocation, no
   clock read.  ``benchmarks/serving.py`` measures this as the
   ``tracer_off_overhead`` row and CI gates it below 2%.
2. **Perfetto-loadable output.**  Finished spans are Chrome trace-event
   "complete" events (``ph: "X"`` with microsecond ``ts``/``dur``);
   :meth:`Tracer.chrome_trace` wraps them in the standard
   ``{"traceEvents": [...]}`` document.  Nesting needs no explicit
   parent ids — viewers nest by time containment per ``tid``.
3. **Optional profiler bridge.**  When ``profiler_annotations`` is
   enabled, every span also enters a ``torch.profiler.record_function``
   range, so host spans line up with device activity in a
   ``torch.profiler`` capture; with the switch off the tracer never
   touches the profiler.

The module-level :data:`TRACER` is what the instrumented call sites in
``repro_torch.core`` use (via :func:`span` / :func:`instant`, which read the
global at call time so :func:`use` / :func:`bypass` can swap it).
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

__all__ = ["NULL_SPAN", "Span", "Tracer", "TRACER", "span", "instant",
           "use", "bypass"]


class _NullSpan:
    """The shared do-nothing span the disabled tracer hands out.  A
    single module-level instance, so the disabled path allocates
    nothing; ``set()`` accepts and drops attributes so call sites need
    no enabled-checks of their own."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span: a context manager that records a Chrome complete
    event on exit.  ``set(**args)`` attaches arguments any time before
    exit (shown in the Perfetto args panel)."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._range = None

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._t0 = self._tracer._clock()
        if self._tracer.profiler_annotations:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._tracer._record(self.name, self.cat, self._t0,
                             self._tracer._clock(), self.args)
        return False


class Tracer:
    """Collects spans as Chrome trace events.  Off by default —
    :meth:`span` then returns :data:`NULL_SPAN` without allocating.

    ``clock`` is injectable (the repo's deterministic-test pattern, as
    in :class:`repro_torch.core.scheduler.SlotScheduler`); ``max_events``
    bounds memory on long serving runs (overflow is counted, newest
    events dropped, never an error)."""

    def __init__(self, clock=time.perf_counter, max_events: int = 1_000_000):
        self.enabled = False
        self.profiler_annotations = False
        self.max_events = int(max_events)
        self.dropped = 0
        self._clock = clock
        self._events: List[Dict[str, Any]] = []
        self._origin: Optional[float] = None

    # -- control -------------------------------------------------------------
    def enable(self, profiler_annotations: bool = False) -> "Tracer":
        self.enabled = True
        self.profiler_annotations = bool(profiler_annotations)
        if self._origin is None:
            self._origin = self._clock()
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        self._events = []
        self.dropped = 0
        self._origin = None

    # -- recording -----------------------------------------------------------
    def span(self, name: str, cat: str = "serving", **args) -> Any:
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "serving", **args) -> None:
        """A zero-duration marker event (``ph: "i"``)."""
        if not self.enabled:
            return
        now = self._clock()
        self._append({"name": name, "cat": cat, "ph": "i", "s": "t",
                      "ts": self._us(now), "pid": 1,
                      "tid": threading.get_ident() % 0x7FFFFFFF,
                      "args": dict(args)})

    def _record(self, name: str, cat: str, t0: float, t1: float,
                args: Dict[str, Any]) -> None:
        self._append({"name": name, "cat": cat, "ph": "X",
                      "ts": self._us(t0),
                      "dur": max(0.0, (t1 - t0) * 1e6), "pid": 1,
                      "tid": threading.get_ident() % 0x7FFFFFFF,
                      "args": args})

    def _append(self, event: Dict[str, Any]) -> None:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(event)

    def _us(self, t: float) -> float:
        origin = self._origin if self._origin is not None else t
        return (t - origin) * 1e6

    # -- export --------------------------------------------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """The standard Chrome trace-event JSON document — load it in
        Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


class _BypassTracer(Tracer):
    """Hard-null tracer: span()/instant() short-circuit before even the
    ``enabled`` check — the closest runtime stand-in for removing the
    instrumentation, used by ``benchmarks/serving.py`` to price the
    disabled call sites (the ``tracer_off_overhead`` row)."""

    def span(self, name: str, cat: str = "serving", **args) -> Any:
        return NULL_SPAN

    def instant(self, name: str, cat: str = "serving", **args) -> None:
        return None


TRACER = Tracer()


def span(name: str, cat: str = "serving", **args) -> Any:
    """Open a span on the current module-level tracer.  The global is
    read at call time so :func:`use`/:func:`bypass` swaps take effect
    everywhere at once; the disabled check stays inline (the hot path),
    the enabled path defers to the tracer (so subclasses like
    :class:`_BypassTracer` keep their say)."""
    t = TRACER
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "serving", **args) -> None:
    TRACER.instant(name, cat, **args)


@contextmanager
def use(tracer: Tracer):
    """Temporarily install ``tracer`` as the module-level tracer —
    test/benchmark isolation without touching global state for good."""
    global TRACER
    prev, TRACER = TRACER, tracer
    try:
        yield tracer
    finally:
        TRACER = prev


@contextmanager
def bypass():
    """Temporarily hard-null the tracer (see :class:`_BypassTracer`)."""
    with use(_BypassTracer()) as t:
        yield t
