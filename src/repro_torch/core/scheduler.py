"""Continuous-batching slot scheduler: the serving tier over both engines.

The paper's evaluation "simultaneously processes several automaton
states as well as several graph nodes" — :class:`SlotScheduler` turns
that bit-parallel batch into a *continuously* batched one, in the style
of JetStream/MaxText prefill-insert serving: the in-flight wavefront is
a pool of at most ``max_slots`` slots, new queries join **between
supersteps** (no waiting for the batch to drain), finished queries free
their slot immediately, and each slot streams newly-discovered result
pairs back incrementally — sound because the backward wavefront
discovers endpoint pairs monotonically (``reported``/``visited`` only
ever grow).  Bucket flushing (collect ``max_batch`` queries, run
``eval_many``, repeat) makes every fast query wait for the slowest one
admitted ahead of it; slots retire each query the superstep it
converges, which is what moves tail latency (see
``benchmarks/serving.py``).

Engine contract: both engines expose ``make_stepper()`` returning an
object with ``step()`` / ``finished(handle)`` / ``remove_job(handle)``
whose per-superstep execution is the SAME code their one-shot
``eval_many`` path runs (:class:`repro_torch.core.rpq.RingStepper` over
the merged task list, :class:`repro_torch.core.dense.DenseStepper` over
the hetero-bucket BFS) — so slot answers equal ``eval_many`` answers by
construction, and pow2 slot-bucket padding (dynamic
:class:`~repro_torch.core.engines.PlanBundle` slots, dense width buckets)
keeps the kernels' launch shapes bounded under churn.

Admission control: ``submit`` raises :class:`Backpressure` once
``max_queue`` queries are waiting (shed load at the door, don't grow an
unbounded latency queue), and a per-query ``deadline_s`` preempts the
query wherever it is — still queued, or mid-flight holding a slot (the
slot is freed the same tick).  A ring slot's deadline also reaches
inside the superstep: the stepper stops the job there and pauses the
superstep, the tick fails the ticket, and the next tick resumes the
superstep for the other slots (``preempted_in_superstep``).  A dense
slot overruns by at most one tick (``rpq_tick_seconds``).

Multi-version epoch serving: ``submit_update`` swaps the engine's
overlay for a :meth:`~repro_torch.core.delta.DeltaOverlay.clone` before
applying the mutation, so epoch ``e+1`` is built off to the side while
in-flight slots keep reading the ring/edge-array/overlay snapshot
pinned at their admission — writes never stall reads, and every answer
is exact at its admission epoch (snapshot isolation).  Mutating the
engine directly (``engine.add_edges``) while slots are in flight is NOT
supported — route writes through ``submit_update``.

Queries whose plan needs a second stage (unanchored ``(x, E, y)``, or
a planner ``split``) cannot ride a single-BFS slot; they are evaluated
synchronously at admission, against the then-current epoch, exactly as
``eval_many`` delegates them.

``limit`` queries do not stream partial pairs: a limited answer is the
*sorted prefix* of the full set (:func:`truncate_result`), and the
first k discovered pairs are not the k smallest — the final result
arrives all at once.

:class:`AsyncServer` wraps the synchronous core for asyncio serving:
``await server.submit(q)`` returns an async ticket that is an async
iterator of result pairs (and awaitable for the final set).
"""
from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from dataclasses import dataclass, field
from itertools import repeat
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from . import delta as dl
from . import regex as rx
from .engines import (Query, QueryLike, QueryStats, as_query, normalized_key,
                      result_key, truncate_result)
from ..obs import trace as otrace
from ..obs.metrics import MetricsRegistry
from ..obs.recorder import FlightRecorder

__all__ = ["Backpressure", "QueryTicket", "SlotScheduler", "AsyncServer"]


class Backpressure(RuntimeError):
    """Raised by :meth:`SlotScheduler.submit` when the admission queue
    is full — the caller should retry later or shed the request."""


class QueryTicket:
    """Handle for one submitted query.

    ``new_pairs()`` drains the incrementally-streamed result pairs
    discovered since the last call (sorted within each drain; empty for
    ``limit`` queries until completion).  ``result()`` returns the final
    answer set once ``done`` — or raises the query's failure
    (``TimeoutError`` on deadline preemption).  ``epoch`` is the graph
    epoch the answer is exact at, pinned at slot admission.

    Latency attribution (scheduler-clock seconds, recorded in
    ``stats``): ``queue_wait_s`` (submit -> admission),
    ``service_s`` (admission -> settle), ``supersteps_s`` (wall time
    the ticket's slot spent inside superstep dispatch).  For a settled
    ticket ``queue_wait_s + service_s == finished_at - submitted_at``.
    """

    __slots__ = ("query", "submitted_at", "admitted_at", "deadline",
                 "epoch", "state", "finished_at", "stats", "settled",
                 "_result", "_error", "_stream", "_emitted")

    def __init__(self, query: Query, submitted_at: float,
                 deadline: Optional[float]):
        self.query = query
        self.submitted_at = submitted_at
        self.admitted_at: Optional[float] = None
        self.deadline = deadline
        self.epoch: Optional[int] = None
        self.state = "queued"            # queued | running | done | failed
        self.finished_at: Optional[float] = None
        self.stats = QueryStats()
        # where the ticket settled ("queued", "running", "superstep",
        # "admit" or "harvest") and the record of the tick that settled
        # it (``SlotScheduler.step``)
        self.settled: Optional[Tuple[str, Dict[str, Any]]] = None
        self._result: Optional[Set[Tuple[int, int]]] = None
        self._error: Optional[BaseException] = None
        self._stream: List[Tuple[int, int]] = []
        self._emitted: Set[Tuple[int, int]] = set()

    @property
    def done(self) -> bool:
        return self.state in ("done", "failed")

    def result(self) -> Set[Tuple[int, int]]:
        if self.state == "failed":
            raise self._error
        if self.state != "done":
            raise RuntimeError("query still pending — drive the scheduler "
                               "(step()/drain()) or await the async ticket")
        return set(self._result)

    def new_pairs(self) -> List[Tuple[int, int]]:
        out, self._stream = self._stream, []
        return out

    # -- scheduler side ------------------------------------------------------
    def _emit(self, pairs) -> int:
        # sort only what is new: a final answer is mostly streamed already
        # (sorting a hub's 10^5 pairs again costs more than the rest)
        fresh = sorted(p for p in pairs if p not in self._emitted)
        self._emitted.update(fresh)
        self._stream.extend(fresh)
        return len(fresh)


@dataclass
class _Active:
    """One occupied slot: the ticket plus how reported nodes map back to
    answer pairs.  ``kind``: "obj" ((x,E,o) — reported node n is the
    subject of (n, obj)), "subj" ((s,E,y) — n is the object of
    (subject, n)), "both" ((s,E,o) — the answer exists iff ``target``
    reports)."""

    ticket: QueryTicket
    handle: Any
    kind: str
    target: Optional[int]
    key: Tuple
    footprint: frozenset
    seen: Set[int] = field(default_factory=set)


class _RingSlots:
    """Ring-engine adapter: slots are :class:`~repro_torch.core.rpq._Job`\\ s
    in a shared :class:`~repro_torch.core.rpq.RingStepper` wavefront.
    Each job carries its ticket's deadline into the superstep, which
    stops the job there and pauses (see the stepper)."""

    def __init__(self, eng, clock):
        self.eng = eng
        self.stepper = eng.make_stepper(clock=clock)

    def snapshot(self):
        return (self.eng.ring, self.eng.delta)

    def plan(self, ast):
        return self.eng._plan(ast)

    def start_cost(self, plan) -> Optional[int]:
        return self.eng._start_cost(plan.g)

    def admit(self, plan, start: int, target: Optional[int], snapshot,
              stats: QueryStats, deadline: Optional[float] = None):
        from .rpq import _Job
        job = _Job(plan=plan, start_obj=int(start), stats=stats,
                   target=target, deadline=deadline)
        self.stepper.add_job(job, ring=snapshot[0], overlay=snapshot[1])
        return job

    def step(self) -> List[Any]:
        """One superstep, or a paused one resumed; returns the jobs that
        expired inside it."""
        self.stepper.step()
        return self.stepper.take_expired()

    def finished(self, job) -> bool:
        return self.stepper.finished(job)

    def reported(self, job) -> Set[int]:
        return job.reported

    def release(self, job) -> None:
        self.stepper.remove_job(job)


class _DenseSlots:
    """Dense-engine adapter: slots are independent hetero-bucket BFS
    rows in a :class:`~repro_torch.core.dense.DenseStepper`."""

    def __init__(self, eng, steps_per_tick: int = 1):
        self.eng = eng
        self.stepper = eng.make_stepper(steps_per_tick=steps_per_tick)

    def snapshot(self):
        return self.eng._edges()

    def plan(self, ast):
        return self.eng._plan(ast)

    def start_cost(self, plan) -> Optional[int]:
        return None   # dense eval_many always runs single-BFS rows forward

    def admit(self, plan, start: int, target: Optional[int], snapshot,
              stats: QueryStats, deadline: Optional[float] = None):
        return self.stepper.add_job(plan, int(start), edges=snapshot)

    def step(self) -> List[Any]:
        """``steps_per_tick`` supersteps of every slot; deadlines are
        checked between ticks (``SlotScheduler._expire``), so a slot
        overruns its deadline by at most one tick."""
        self.stepper.step()
        return []

    def finished(self, slot) -> bool:
        return self.stepper.finished(slot)

    def reported(self, slot) -> Set[int]:
        return self.stepper.reported(slot)

    def release(self, slot) -> None:
        self.stepper.remove_job(slot)


class SlotScheduler:
    """Slot-based continuous-batching executor over one engine.

    Synchronous, externally-driven core (``submit`` then ``step()`` /
    ``drain()``), which is what makes scheduler-vs-``eval_many`` parity
    property-testable; :class:`AsyncServer` adds the asyncio pump.

    Knobs: ``max_slots`` (in-flight pool size), ``max_queue``
    (admission backpressure depth), ``steps_per_tick`` (dense: supersteps
    per tick — streaming granularity vs dispatch overhead),
    ``clock`` (injectable for deadline tests; it also reads ring
    slots' deadlines inside a superstep), ``admission_policy``
    ("fifo", or "edf" = earliest deadline first with FIFO tie-break for
    deadline-less tickets), ``recorder_capacity`` (the always-on flight
    recorder's ring size; every settled ticket appends one compact
    record, ``recorder.dump()`` writes a replayable JSONL workload —
    see :mod:`repro_torch.obs.recorder`; capacity 0 disables retention).
    """

    def __init__(self, engine, max_slots: int = 8, max_queue: int = 256,
                 steps_per_tick: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[MetricsRegistry] = None,
                 admission_policy: str = "fifo",
                 recorder: Optional[FlightRecorder] = None,
                 recorder_capacity: int = 4096):
        self.engine = engine
        self.max_slots = int(max_slots)
        self.max_queue = int(max_queue)
        self.clock = clock
        if admission_policy not in ("fifo", "edf"):
            raise ValueError(f"unknown admission_policy {admission_policy!r}")
        self.admission_policy = admission_policy
        self.recorder = recorder if recorder is not None \
            else FlightRecorder(recorder_capacity)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._hist_queue_wait = self.metrics.histogram(
            "rpq_queue_wait_seconds", "submit -> slot admission")
        self._hist_service = self.metrics.histogram(
            "rpq_service_seconds", "admission -> settle")
        self._hist_e2e = self.metrics.histogram(
            "rpq_e2e_seconds", "submit -> settle")
        self._hist_preempt_wait = self.metrics.histogram(
            "rpq_preempted_queue_wait_seconds",
            "queue wait paid by deadline-preempted queries")
        self._hist_tick = self.metrics.histogram(
            "rpq_tick_seconds", "one scheduler tick: what an expired "
            "ticket may wait for beyond its deadline's check")
        if hasattr(engine, "ring"):
            self.slots: Any = _RingSlots(engine, clock)
        elif hasattr(engine, "dg"):
            self.slots = _DenseSlots(engine, steps_per_tick=steps_per_tick)
        else:
            raise TypeError(f"unsupported engine {type(engine).__name__}")
        self.waiting: deque = deque()      # QueryTickets not yet admitted
        self.active: List[_Active] = []
        # observability counters
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.preempted = 0
        self.preempted_in_superstep = 0   # of those, stopped mid-superstep
        self.rejected = 0
        self.cache_hits = 0
        self.delegated = 0
        self.updates = 0
        self.streamed_pairs = 0
        self.peak_in_flight = 0
        self.last_tick: Optional[Dict[str, Any]] = None
        self.longest_tick: Optional[Dict[str, Any]] = None

    # -- submission ----------------------------------------------------------
    def submit(self, query: QueryLike,
               deadline_s: Optional[float] = None) -> QueryTicket:
        """Enqueue a query; raises :class:`Backpressure` when
        ``max_queue`` queries are already waiting."""
        if len(self.waiting) >= self.max_queue:
            self.rejected += 1
            q = as_query(query)
            self.recorder.append({
                "ts": self.clock(), "key": None, "expr": q.expr,
                "subject": q.subject, "obj": q.obj, "limit": q.limit,
                "plan": "", "epoch": None, "status": "shed",
                "results": None, "supersteps": None,
                "queue_wait_s": 0.0, "service_s": 0.0, "supersteps_s": 0.0,
                "preempted": False, "backpressure": True, "cache_hit": False,
            })
            raise Backpressure(
                f"admission queue full ({self.max_queue} waiting)")
        now = self.clock()
        ticket = QueryTicket(as_query(query), now,
                             now + deadline_s if deadline_s else None)
        self.waiting.append(ticket)
        self.submitted += 1
        return ticket

    def submit_update(self, add=None, remove=None) -> int:
        """Apply a mutation batch as the next epoch WITHOUT stalling
        in-flight reads: the live overlay is swapped for a clone first
        (copy-on-write), so slots pinned to the old overlay/ring/edge
        snapshot keep answering at their admission epoch while new
        admissions see the new one.  Returns the new epoch."""
        eng = self.engine
        if eng.delta is not None:
            eng.delta = eng.delta.clone()
            # the stale checker must follow the live object: cached
            # results are judged against the NEWEST epoch history
            eng.results.stale_checker = eng.delta.entry_is_stale
        self.updates += 1
        return dl.apply_engine_updates(eng, add, remove)

    # -- the tick ------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler tick: preempt expired deadlines, admit from the
        waiting queue into free slots, advance the wavefront by one
        superstep, harvest newly-converged slots.  A tick that preempts
        a ticket at its top ends there: the pump hands the failure over
        before the other slots' superstep, which may run until the next
        of their own deadlines.  ``last_tick`` and ``longest_tick`` keep
        the tick records (seconds of each part, tickets admitted,
        delegated and settled); each settled ticket holds its own.
        Returns True while any query is in flight or waiting."""
        if not (self.active or self.waiting):
            return False
        with otrace.span("scheduler.tick", cat="scheduler",
                         active=len(self.active), waiting=len(self.waiting)):
            now = self.clock()
            tick = self.last_tick = {
                "at": now, "s": 0.0, "expire_s": 0.0, "admit_s": 0.0,
                "superstep_s": 0.0, "harvest_s": 0.0, "slots": 0,
                "admitted": 0, "delegated": 0, "settled": 0,
                "ended_after_expire": False}
            preempted = self.preempted
            self._expire(now)
            t = self.clock()
            tick["expire_s"] = t - now
            if self.preempted > preempted:
                tick["ended_after_expire"] = True
            else:
                admitted, delegated = self.admitted, self.delegated
                self._admit(now)
                t0 = self.clock()
                tick.update(admit_s=t0 - t, slots=len(self.active),
                            admitted=self.admitted - admitted,
                            delegated=self.delegated - delegated)
                if self.active:
                    with otrace.span("scheduler.superstep", cat="scheduler",
                                     slots=len(self.active)):
                        expired = self.slots.step()
                        t = self.clock()
                    dt = tick["superstep_s"] = t - t0
                    # wall time inside superstep dispatch, attributed to
                    # every ticket that occupied a slot during it
                    for a in self.active:
                        a.ticket.stats.supersteps_s += dt
                    for a in [a for a in self.active
                              if any(a.handle is h for h in expired)]:
                        self._preempt(a, "superstep")
                        self.preempted_in_superstep += 1
                    self._harvest()
                    tick["harvest_s"] = self.clock() - t
            tick["s"] = self.clock() - now
            self._hist_tick.observe(tick["s"])
            if self.longest_tick is None \
                    or tick["s"] > self.longest_tick["s"]:
                self.longest_tick = tick
        return bool(self.active or self.waiting)

    def drain(self) -> None:
        """Drive ticks until every submitted query settles."""
        while self.step():
            pass

    @property
    def in_flight(self) -> int:
        return len(self.active)

    def pending(self) -> bool:
        return bool(self.active or self.waiting)

    # -- metrics -------------------------------------------------------------
    def _sync_metrics(self) -> None:
        # the int attributes stay authoritative (cheap, test-friendly);
        # the registry mirrors them on demand so exports see one source
        m = self.metrics
        for name in ("submitted", "admitted", "completed", "preempted",
                     "preempted_in_superstep", "rejected", "cache_hits",
                     "delegated", "updates", "streamed_pairs"):
            m.counter(f"rpq_{name}_total",
                      f"scheduler {name} count").value = getattr(self, name)
        m.gauge("rpq_in_flight", "occupied slots").set(len(self.active))
        m.gauge("rpq_waiting", "admission queue depth").set(len(self.waiting))
        m.gauge("rpq_peak_in_flight",
                "high-water occupied slots").set(self.peak_in_flight)
        # self-observability: the obs layer reports its own saturation
        m.counter("rpq_tracer_dropped_events_total",
                  "span events dropped at the tracer's max_events bound"
                  ).value = otrace.TRACER.dropped
        for cname, cache in (("result", getattr(self.engine, "results", None)),
                             ("plan", getattr(self.engine, "plans", None)),
                             ("decision",
                              getattr(self.engine, "decisions", None))):
            if cache is None:
                continue
            m.gauge(f"rpq_{cname}_cache_hit_rate",
                    f"{cname} cache hits / probes (0 before first probe)"
                    ).set(cache.hits / max(1, cache.hits + cache.misses))
        m.gauge("rpq_recorder_occupancy",
                "flight-recorder ring occupancy").set(self.recorder.occupancy)
        m.counter("rpq_recorder_appended_total",
                  "flight-recorder records ever appended"
                  ).value = self.recorder.appended
        m.counter("rpq_recorder_dropped_total",
                  "flight-recorder records lost to ring overwrite"
                  ).value = self.recorder.dropped

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-able registry snapshot (see
        :meth:`repro_torch.obs.metrics.MetricsRegistry.snapshot`)."""
        self._sync_metrics()
        return self.metrics.snapshot()

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the scheduler's metrics."""
        self._sync_metrics()
        return self.metrics.to_prometheus()

    # -- internals -----------------------------------------------------------
    def _record_ticket(self, ticket: QueryTicket, status: str,
                       cache_hit: bool = False) -> None:
        """Append the settled ticket's compact record to the flight
        recorder — one dict per settle, uniform keys across statuses."""
        q, st = ticket.query, ticket.stats
        try:
            key = normalized_key(q.expr)
        except Exception:
            key = None   # unparseable expr: still record the failure
        self.recorder.append({
            "ts": ticket.finished_at, "key": key, "expr": q.expr,
            "subject": q.subject, "obj": q.obj, "limit": q.limit,
            "plan": st.plan_mode, "epoch": ticket.epoch, "status": status,
            "results": st.results if status == "ok" else None,
            "supersteps": st.supersteps,
            "queue_wait_s": st.queue_wait_s, "service_s": st.service_s,
            "supersteps_s": st.supersteps_s,
            "preempted": status == "timeout", "backpressure": False,
            "cache_hit": cache_hit,
        })

    def _settled(self, ticket: QueryTicket, where: str) -> None:
        ticket.finished_at = self.clock()
        ticket.settled = (where, self.last_tick)
        self.last_tick["settled"] += 1

    def _fail(self, ticket: QueryTicket, err: BaseException,
              where: str) -> None:
        ticket._error = err
        ticket.state = "failed"
        self._settled(ticket, where)
        if ticket.admitted_at is not None:
            ticket.stats.service_s = ticket.finished_at - ticket.admitted_at
        self._record_ticket(
            ticket, "timeout" if isinstance(err, TimeoutError) else "error")

    def _settle_stats(self, ticket: QueryTicket) -> None:
        if ticket.admitted_at is not None:
            ticket.stats.service_s = ticket.finished_at - ticket.admitted_at
            self._hist_service.observe(ticket.stats.service_s)
        self._hist_e2e.observe(ticket.finished_at - ticket.submitted_at)

    def _finish(self, ticket: QueryTicket, out: Set[Tuple[int, int]],
                key: Tuple, footprint: frozenset,
                where: str = "harvest") -> None:
        with otrace.span("scheduler.retire", cat="scheduler",
                         expr=ticket.query.expr, results=len(out)):
            q = ticket.query
            ticket.stats.results = len(out)
            out = truncate_result(out, q.limit)
            if q.limit is None:
                self.streamed_pairs += ticket._emit(out)
            self.engine.results.put(key, out, footprint=footprint,
                                    epoch=ticket.epoch or 0)
            ticket._result = out
            ticket.state = "done"
            self._settled(ticket, where)
            self._settle_stats(ticket)
            self.completed += 1
            self._record_ticket(ticket, "ok")

    def _expire(self, now: float) -> None:
        for ticket in [t for t in self.waiting
                       if t.deadline is not None and now >= t.deadline]:
            self.waiting.remove(ticket)
            with otrace.span("scheduler.preempt", cat="scheduler",
                             where="queued", expr=ticket.query.expr):
                ticket.stats.queue_wait_s = now - ticket.submitted_at
                self._hist_preempt_wait.observe(ticket.stats.queue_wait_s)
                self._fail(ticket, TimeoutError("query deadline exceeded"),
                           "queued")
            self.preempted += 1
        for a in [a for a in self.active
                  if a.ticket.deadline is not None
                  and now >= a.ticket.deadline]:
            # deadline-aware preemption: the slot frees THIS tick, so
            # the stragglers behind it stop paying for the monster query
            self._preempt(a, "running")

    def _preempt(self, a: _Active, where: str) -> None:
        """Fail an in-flight ticket past its deadline and free its slot:
        between ticks (``where="running"``) or, for a ring slot, inside
        the superstep that stopped it (``"superstep"``)."""
        with otrace.span("scheduler.preempt", cat="scheduler",
                         where=where, expr=a.ticket.query.expr):
            self.slots.release(a.handle)
            self.active.remove(a)
            self._hist_preempt_wait.observe(a.ticket.stats.queue_wait_s)
            self._fail(a.ticket, TimeoutError("query deadline exceeded"),
                       where)
        self.preempted += 1

    def _pop_next(self) -> QueryTicket:
        """Next ticket to admit.  FIFO by default; ``edf`` picks the
        earliest (strictly smallest) deadline, falling back to FIFO
        order when no waiting ticket carries a deadline — so
        deadline-less traffic is never starved by policy alone, and
        equal deadlines keep submission order."""
        if self.admission_policy == "edf":
            best_i, best_d = -1, None
            for i, t in enumerate(self.waiting):
                if t.deadline is not None \
                        and (best_d is None or t.deadline < best_d):
                    best_i, best_d = i, t.deadline
            if best_i >= 0:
                ticket = self.waiting[best_i]
                del self.waiting[best_i]
                return ticket
        return self.waiting.popleft()

    def _admit(self, now: float) -> None:
        while self.waiting and len(self.active) < self.max_slots:
            ticket = self._pop_next()
            ticket.admitted_at = now
            ticket.stats.queue_wait_s = now - ticket.submitted_at
            self._hist_queue_wait.observe(ticket.stats.queue_wait_s)
            with otrace.span("scheduler.admit", cat="scheduler",
                             expr=ticket.query.expr) as sp:
                try:
                    self._admit_one(ticket, now)
                except TimeoutError as e:
                    self._fail(ticket, e, "admit")
                sp.set(state=ticket.state)
            self.peak_in_flight = max(self.peak_in_flight, len(self.active))

    def _admit_one(self, ticket: QueryTicket, now: float) -> None:
        eng = self.engine
        q = ticket.query
        key = result_key(q)
        if q.explain is not None:
            # ANALYZE: execute under a private tracer even when cached —
            # the per-superstep timeline is the point.  Delegated
            # synchronously, like other multi-stage admissions.
            from ..obs import explain as oexplain
            self.delegated += 1
            ticket.state = "running"
            remaining = None
            if ticket.deadline is not None:
                remaining = ticket.deadline - now
                if remaining <= 0:
                    raise TimeoutError("query deadline exceeded")
            report, out = oexplain.analyze_query(
                eng, q, stats=ticket.stats, deadline_s=remaining)
            oexplain.deliver(q.explain, report)
            ticket.epoch = eng.epoch
            self._finish(ticket, out, key, eng._footprint(rx.parse(q.expr)),
                         "admit")
            return
        cached = eng.results.get_covering(key)
        if cached is not None:
            ticket.epoch = eng.epoch
            ticket.stats.result_cache_hits += 1
            self.cache_hits += 1
            if q.limit is None:
                self.streamed_pairs += ticket._emit(cached)
            ticket._result = set(cached)
            ticket.stats.results = len(cached)
            ticket.state = "done"
            self._settled(ticket, "admit")
            self._settle_stats(ticket)
            self.completed += 1
            self._record_ticket(ticket, "ok", cache_hit=True)
            return
        ast = rx.parse(q.expr)
        footprint = eng._footprint(ast)
        qplan = eng._decide(ast, q.subject is not None, q.obj is not None,
                            ticket.stats)
        null = rx.nullable(ast)
        ticket.epoch = eng.epoch
        ticket.state = "running"
        if (q.subject is None and q.obj is None) or qplan.mode == "split":
            # multi-stage plans (second stage depends on the first) are
            # delegated synchronously at the current epoch, exactly as
            # eval_many does — they cannot occupy a single-BFS slot
            self.delegated += 1
            remaining = None
            if ticket.deadline is not None:
                remaining = ticket.deadline - now
                if remaining <= 0:
                    raise TimeoutError("query deadline exceeded")
            out = eng.eval(q.expr, q.subject, q.obj, q.limit,
                           deadline_s=remaining)
            self._finish(ticket, out, key, footprint, "admit")
            return
        if q.subject is not None and q.obj is not None:
            if null and q.subject == q.obj:
                self._finish(ticket, {(q.subject, q.obj)}, key, footprint,
                             "admit")
                return
            if qplan.mode == "reverse":
                plan, start, tgt = (self.slots.plan(rx.reverse(ast)),
                                    q.subject, q.obj)
            elif qplan.mode == "forward":
                plan, start, tgt = self.slots.plan(ast), q.obj, q.subject
            else:   # naive: the ring's Sec.-5 start-side heuristic
                p_bwd = self.slots.plan(ast)
                cost = self.slots.start_cost(p_bwd)
                if cost is None:
                    plan, start, tgt = p_bwd, q.obj, q.subject
                else:
                    p_fwd = self.slots.plan(rx.reverse(ast))
                    if cost <= self.slots.start_cost(p_fwd):
                        plan, start, tgt = p_bwd, q.obj, q.subject
                    else:
                        plan, start, tgt = p_fwd, q.subject, q.obj
            kind = "both"
        elif q.obj is not None:                      # (x, E, o)
            plan, start, tgt, kind = self.slots.plan(ast), q.obj, None, "obj"
        else:                                        # (s, E, y)
            plan, start, tgt, kind = (self.slots.plan(rx.reverse(ast)),
                                      q.subject, None, "subj")
        ticket.stats.plan_actual_frontier = 1
        handle = self.slots.admit(plan, start, tgt, self.slots.snapshot(),
                                  ticket.stats, deadline=ticket.deadline)
        active = _Active(ticket=ticket, handle=handle, kind=kind, target=tgt,
                         key=key, footprint=footprint)
        self.active.append(active)
        self.admitted += 1
        if null and kind != "both" and q.limit is None:
            # the zero-length eps match is known at admission — stream it
            anchor = q.obj if kind == "obj" else q.subject
            self.streamed_pairs += ticket._emit([(anchor, anchor)])

    def _harvest(self) -> None:
        for a in list(self.active):
            ticket, q = a.ticket, a.ticket.query
            rep = self.slots.reported(a.handle)
            new = rep - a.seen if len(rep) > len(a.seen) else set()
            a.seen |= new
            if new and q.limit is None:
                # pairs in sorted order, for a sort that only checks it
                if a.kind == "obj":
                    self.streamed_pairs += ticket._emit(
                        zip(sorted(new), repeat(q.obj)))
                elif a.kind == "subj":
                    self.streamed_pairs += ticket._emit(
                        zip(repeat(q.subject), sorted(new)))
            hit = a.kind == "both" and a.target in a.seen
            if not hit and not self.slots.finished(a.handle):
                continue
            self.slots.release(a.handle)
            self.active.remove(a)
            null = rx.nullable(rx.parse(q.expr))
            out: Set[Tuple[int, int]] = set()
            if a.kind == "both":
                if hit:
                    out.add((q.subject, q.obj))
            elif q.limit is None:
                # every pair of the answer has been streamed, the eps
                # match at admission included
                out = set(ticket._emitted)
            elif a.kind == "obj":
                if null:
                    out.add((q.obj, q.obj))
                out.update(zip(a.seen, repeat(q.obj)))
            else:
                if null:
                    out.add((q.subject, q.subject))
                out.update(zip(repeat(q.subject), a.seen))
            self._finish(ticket, out, a.key, a.footprint)


_DONE = object()


class AsyncTicket:
    """Async view of a :class:`QueryTicket`: an async iterator of result
    pairs, awaitable (via :meth:`result`) for the final answer set.  The
    pump queues each tick's new pairs as one batch."""

    def __init__(self, ticket: QueryTicket):
        self.ticket = ticket
        self._queue: asyncio.Queue = asyncio.Queue()
        self._batch: deque = deque()
        self._settled = asyncio.Event()

    def __aiter__(self) -> "AsyncTicket":
        return self

    async def __anext__(self) -> Tuple[int, int]:
        while not self._batch:
            item = await self._queue.get()
            if item is _DONE:
                raise StopAsyncIteration
            self._batch.extend(item)
        return self._batch.popleft()

    async def result(self) -> Set[Tuple[int, int]]:
        await self._settled.wait()
        return self.ticket.result()


class AsyncServer:
    """asyncio pump around a :class:`SlotScheduler`::

        server = AsyncServer(SlotScheduler(engine))
        async with server:
            ticket = await server.submit(Query("a/b*", obj=7))
            async for s, o in ticket:      # pairs stream as discovered
                ...
            final = await ticket.result()

    The pump coroutine runs one scheduler tick per loop iteration and
    forwards each ticket's ``new_pairs()`` into its async queue, so
    slot progress and result streaming interleave with the caller's own
    coroutines; it idles (``idle_sleep_s``) while no query is in
    flight.

    ``metrics_port`` (``0`` picks a free port, exposed as
    ``metrics_addr`` once entered) serves the observability endpoints
    over HTTP:

      * ``/`` and ``/metrics`` — the scheduler's Prometheus text
        exposition
      * ``/flight`` — the flight recorder's current ring as a versioned
        JSONL workload (replayable via ``benchmarks/replay.py``)
      * ``/explain?expr=...[&subject=][&obj=][&limit=][&analyze=1]`` —
        a JSON EXPLAIN (or ANALYZE) report from :mod:`repro_torch.obs.explain`
    """

    def __init__(self, scheduler: SlotScheduler,
                 idle_sleep_s: float = 0.001,
                 metrics_port: Optional[int] = None,
                 metrics_host: str = "127.0.0.1"):
        self.scheduler = scheduler
        self.idle_sleep_s = idle_sleep_s
        self.metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.metrics_addr: Optional[Tuple[str, int]] = None
        self._live: List[AsyncTicket] = []
        self._task: Optional[asyncio.Task] = None
        self._metrics_srv: Optional[asyncio.AbstractServer] = None
        self._closing = False

    async def __aenter__(self) -> "AsyncServer":
        self._task = asyncio.ensure_future(self._pump())
        if self.metrics_port is not None:
            self._metrics_srv = await asyncio.start_server(
                self._serve_metrics, self.metrics_host, self.metrics_port)
            sock = self._metrics_srv.sockets[0]
            self.metrics_addr = sock.getsockname()[:2]
        return self

    async def __aexit__(self, *exc) -> None:
        self._closing = True
        if self._task is not None:
            await self._task
        if self._metrics_srv is not None:
            self._metrics_srv.close()
            await self._metrics_srv.wait_closed()
            self._metrics_srv = None

    async def _serve_metrics(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        # one-shot HTTP/1.0-style exchange: read the request head, route
        # on the path, answer, close — all a scraper needs
        try:
            request = (await reader.readline()).decode("latin-1", "replace")
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            status, ctype, body = self._route(request)
            writer.write(
                b"HTTP/1.0 " + status + b"\r\n"
                b"Content-Type: " + ctype + b"\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Connection: close\r\n\r\n" + body)
            await writer.drain()
        finally:
            writer.close()

    def _route(self, request_line: str) -> Tuple[bytes, bytes, bytes]:
        """(status, content-type, body) for one request line."""
        from urllib.parse import parse_qs, urlsplit
        parts = request_line.split()
        url = urlsplit(parts[1] if len(parts) >= 2 else "/")
        path = url.path or "/"
        if path in ("/", "/metrics"):
            return (b"200 OK", b"text/plain; version=0.0.4",
                    self.scheduler.prometheus_text().encode())
        if path == "/flight":
            return (b"200 OK", b"application/x-ndjson",
                    self.scheduler.recorder.dumps().encode())
        if path == "/explain":
            qargs = parse_qs(url.query)

            def arg(name):
                v = qargs.get(name, [None])[0]
                return int(v) if v not in (None, "") else None

            expr = qargs.get("expr", [None])[0]
            if not expr:
                return (b"400 Bad Request", b"text/plain",
                        b"missing expr parameter\n")
            analyze = qargs.get("analyze", ["0"])[0] \
                not in ("0", "", "false")
            try:
                from ..obs import explain as oexplain
                report = oexplain.explain_query(
                    self.scheduler.engine,
                    Query(expr, arg("subject"), arg("obj"), arg("limit")),
                    analyze=analyze)
                body = json.dumps(report, sort_keys=True) + "\n"
                return (b"200 OK", b"application/json", body.encode())
            except Exception as e:
                return (b"400 Bad Request", b"text/plain",
                        f"{type(e).__name__}: {e}\n".encode())
        return (b"404 Not Found", b"text/plain", b"not found\n")

    async def submit(self, query: QueryLike,
                     deadline_s: Optional[float] = None) -> AsyncTicket:
        """May raise :class:`Backpressure` — admission control applies
        to async callers identically."""
        at = AsyncTicket(self.scheduler.submit(query, deadline_s=deadline_s))
        self._live.append(at)
        return at

    def submit_update(self, add=None, remove=None) -> int:
        return self.scheduler.submit_update(add=add, remove=remove)

    def _flush(self) -> None:
        for at in list(self._live):
            pairs = at.ticket.new_pairs()
            if pairs:
                at._queue.put_nowait(pairs)
            if at.ticket.done:
                at._queue.put_nowait(_DONE)
                at._settled.set()
                self._live.remove(at)

    async def _pump(self) -> None:
        while not (self._closing and not self.scheduler.pending()
                   and not self._live):
            progressed = self.scheduler.step()
            self._flush()
            await asyncio.sleep(0 if progressed else self.idle_sleep_s)
        self._flush()
