"""Serve regular path queries through the port's asyncio front end.

    python -m repro_torch.serve --device cpu --kind ring    # on the CPU
    python -m repro_torch.serve --kind dense --shards 1     # on the card

A closed-loop client streams a mixed request set (the paper's Table 1
pattern mix, one endpoint bound) through :class:`~repro_torch.core.
scheduler.AsyncServer` over a :class:`~repro_torch.core.scheduler.
SlotScheduler`: ``concurrency`` requests in flight, a new one submitted
as each settles, each under its own deadline.  Halfway through the
submissions a batch of edges is added live (``submit_update``).  Then
the client scrapes ``/metrics``, ``/flight`` and ``/explain`` over HTTP,
holds every answer to ``eval_many`` of a dense engine at the ticket's
epoch, and replays the ``/flight`` capture on a fresh engine of the
same kind at the final epoch (answer-count parity).  It prints one JSON
line per step and a report last; it exits non-zero on any mismatch, or
when a timed-out request settled more than ``OVERRUN_BOUND_S`` past its
deadline.

Deadlines: on the ring engine a slot's deadline is checked inside the
superstep (every 64 frontier entries, every 64 wavelet-tree pops and
every 4,096 transition tasks), so it settles within that work of its
deadline; on the dense engine between ticks (a superstep of every
slot).
``eval`` takes a per-query deadline and ``eval_many`` one batch-wide
deadline, both raising ``TimeoutError``.

``run`` and ``replay`` are the library surface (``chip_smoke.py``
phase 9 drives them at full size on the card).
"""
from __future__ import annotations

import argparse
import asyncio
import gc
import json
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple
from urllib.parse import quote

__all__ = ["Outcome", "live_adds", "one_endpoint_requests", "run",
           "check_answers", "replay", "latency_summary", "main"]

# the command line's graph: scale_free_graph(nodes, preds, edges, seed),
# the one examples/serve_rpq.py serves
GRAPH = (3000, 8, 24000, 23)
# how far past its deadline a timed-out request may settle
OVERRUN_BOUND_S = 0.25


@dataclass
class Outcome:
    """One request as the client saw it: ``answer`` (None on timeout),
    the ticket's epoch, client latency, and for a timeout how far past
    its deadline its client resumed (``overrun_s``) and where the
    scheduler settled it (``settled``: see :func:`_settled`)."""

    index: int
    ok: bool
    answer: Optional[Set[Tuple[int, int]]]
    epoch: Optional[int]
    latency_s: float
    overrun_s: Optional[float]
    settled: Optional[Dict[str, Any]] = None


def _settled(ticket) -> Dict[str, Any]:
    """Where a timed-out ticket settled ("queued", "running" at the top
    of a tick, "superstep", "admit"), how far past its deadline the
    scheduler settled it and its tick began (``settled_s``,
    ``tick_began_s``), and that tick's record (seconds of each part,
    tickets admitted, delegated and settled)."""
    where, tick = ticket.settled
    return {"where": where,
            "settled_s": ticket.finished_at - ticket.deadline,
            "tick_began_s": tick["at"] - ticket.deadline,
            "tick": {k: v for k, v in tick.items() if k != "at"}}


def live_adds(V: int, P: int, seed: int = 5, n: int = 16):
    """``n`` edges over the first four labels, drawn from ``seed``: the
    live update a serving run applies halfway."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(V)), int(rng.integers(min(P, 4))),
             int(rng.integers(V))) for _ in range(n)]


def one_endpoint_requests(graph, count: int, seed: int = 13):
    """The first ``count`` requests of ``generate_workload(4 * count,
    ..., seed)`` (Table 1's mix) with exactly one endpoint bound."""
    from .core import patterns
    from .core.engines import Query
    wl = patterns.generate_workload(4 * count, graph.num_preds,
                                    graph.num_nodes, seed=seed)
    out = [Query(e, s, o) for e, s, o, _p in wl.queries
           if (s is None) != (o is None)]
    return out[:count]


async def _scrape(addr, target: str) -> Tuple[int, str]:
    reader, writer = await asyncio.open_connection(*addr)
    writer.write(f"GET {target} HTTP/1.0\r\n\r\n".encode())
    await writer.drain()
    raw = (await reader.read()).decode()
    writer.close()
    return int(raw.split(" ", 2)[1]), raw.split("\r\n\r\n", 1)[1]


async def _stream(sched, queries, concurrency: int, deadline_s, adds,
                  explain_target: str):
    from .core.scheduler import AsyncServer
    n = len(queries)
    outcomes: List[Optional[Outcome]] = [None] * n
    order = iter(range(n))
    submitted = [0]
    update_epoch: List[int] = []
    update_s: List[float] = []

    async with AsyncServer(sched, metrics_port=0) as server:
        async def client():
            for i in order:             # shared: each takes the next one
                if submitted[0] == n // 2 and adds and not update_epoch:
                    t0 = time.perf_counter()
                    update_epoch.append(server.submit_update(add=adds))
                    update_s.append(time.perf_counter() - t0)
                submitted[0] += 1
                t0 = time.monotonic()
                at = await server.submit(queries[i], deadline_s=deadline_s)
                try:
                    answer, ok = await at.result(), True
                except TimeoutError:
                    answer, ok = None, False
                t1 = time.monotonic()
                ticket = at.ticket
                outcomes[i] = Outcome(
                    i, ok, answer, ticket.epoch, t1 - t0,
                    *((None, None) if ok else (t1 - ticket.deadline,
                                               _settled(ticket))))

        t0 = time.perf_counter()
        await asyncio.gather(*(client() for _ in range(concurrency)))
        serve_s = time.perf_counter() - t0
        scraped = {t: await _scrape(server.metrics_addr, t)
                   for t in ("/metrics", "/flight", explain_target)}
    return outcomes, scraped, serve_s, update_epoch, update_s


def run(engine, queries: Sequence, *, slots: int = 64,
        concurrency: int = 64, deadline_s: Optional[float] = None,
        adds: Sequence = ()) -> Dict[str, Any]:
    """Serve ``queries`` through ``AsyncServer`` over a ``SlotScheduler``
    on ``engine`` with a closed-loop client (``concurrency`` in flight,
    ``deadline_s`` each), adding ``adds`` after half are submitted; then
    scrape the three endpoints.  The engine's write path is prepared
    first (``prepare_updates``), as a server does at start-up.  Returns
    ``outcomes`` (one
    :class:`Outcome` per request, in request order), ``scraped``
    ({target: (HTTP status, body)}), ``scheduler``, ``serve_s`` (first
    submit to last settle), ``update_epoch`` and ``update_s`` (the
    write's seconds, which the event loop spends on it), the kernel
    ``launches``
    made meanwhile, and the interpreter's garbage-collection pauses
    (``gc``: a pause stalls the pump like a long tick).

    The interpreter's cycle collector is off while the stream runs: the
    heap that exists before it is frozen (``gc.freeze``), and the
    stream's own objects, answer sets of tuples, hold no cycles and go
    by reference counting.  A collection
    would otherwise traverse every set alive (tens of millions of answer
    pairs cost seconds), and that pause lands on whichever tickets are
    in flight; ``gc`` reports any collection that still ran."""
    from . import kernels
    from .core.scheduler import SlotScheduler
    sched = SlotScheduler(engine, max_slots=slots,
                          max_queue=max(256, concurrency),
                          clock=time.monotonic,
                          recorder_capacity=max(4096, len(queries) + 64))
    q = queries[0]
    target = f"/explain?expr={quote(q.expr, safe='')}" + "".join(
        f"&{k}={v}" for k, v in (("subject", q.subject), ("obj", q.obj))
        if v is not None)
    pauses: List[Tuple[int, float]] = []     # (generation, seconds)
    began = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - began[0]))

    if adds:
        engine.prepare_updates()
    before = kernels.launch_counts()
    frozen, enabled = gc.get_freeze_count(), gc.isenabled()
    gc.freeze()
    gc.disable()
    gc.callbacks.append(on_gc)
    try:
        outcomes, scraped, serve_s, update_epoch, update_s = asyncio.run(
            _stream(sched, list(queries), concurrency, deadline_s,
                    list(adds), target))
    finally:
        gc.callbacks.remove(on_gc)
        if enabled:
            gc.enable()
        if not frozen:            # a heap the caller froze stays frozen
            gc.unfreeze()
    after = kernels.launch_counts()
    return {"outcomes": outcomes, "scraped": scraped, "scheduler": sched,
            "serve_s": serve_s,
            "update_epoch": update_epoch[0] if update_epoch else None,
            "update_s": update_s[0] if update_s else None,
            "launches": {k: after[k] - before[k] for k in after},
            "gc": {"collections": len(pauses),
                   "full": sum(g == 2 for g, _ in pauses),
                   "max_pause_s": max((d for _, d in pauses), default=0.0),
                   "total_s": sum(d for _, d in pauses)}}


def check_answers(outcomes: Sequence[Outcome], queries: Sequence,
                  want: Dict[int, Sequence]) -> int:
    """Every ``ok`` answer must equal ``want[epoch][index]`` (``eval_many``
    at its ticket's epoch); raises ``AssertionError`` on the first
    mismatch.  Returns the answers compared."""
    n = 0
    for o in outcomes:
        if not o.ok:
            continue
        if o.answer != want[o.epoch][o.index]:
            raise AssertionError(
                f"served answer of {queries[o.index]} at epoch {o.epoch} "
                f"differs from eval_many")
        n += 1
    return n


def replay(flight: str, engine) -> Dict[str, Any]:
    """Validate a ``/flight`` body and replay its ``ok`` records settled
    at ``engine``'s epoch through one ``eval_many`` on ``engine`` (a
    fresh engine at the final epoch): the answer counts must match the
    recorded ones (``parity`` 1.0)."""
    from .core.engines import Query
    from .obs import recorder as orecorder
    lines = [ln for ln in flight.splitlines() if ln.strip()]
    header = json.loads(lines[0])
    orecorder.validate_header(header)
    records = [json.loads(ln) for ln in lines[1:]]
    if len(records) != header["records"]:
        raise AssertionError(f"/flight says {header['records']} records, "
                             f"serves {len(records)}")
    for r in records:
        orecorder.validate_record(r)
    ok = [r for r in records
          if r["status"] == "ok" and r["epoch"] == engine.epoch]
    t0 = time.perf_counter()
    outs = engine.eval_many([Query(r["expr"], r["subject"], r["obj"],
                                   r["limit"]) for r in ok])
    seconds = time.perf_counter() - t0
    equal = sum(len(out) == (r["results"] if r["limit"] is None
                             else min(r["results"], r["limit"]))
                for r, out in zip(ok, outs))
    return {"records": len(records), "dropped": header["dropped"],
            "replayed": len(ok), "epoch": engine.epoch,
            "parity": equal / len(ok) if ok else None, "seconds": seconds}


def _quantiles(xs: Sequence[float]) -> Optional[Dict[str, float]]:
    if not xs:
        return None
    s = sorted(xs)
    return {"n": len(s), "p50": statistics.median(s),
            "p99": s[min(len(s) - 1, int(0.99 * len(s)))], "max": s[-1]}


def latency_summary(out: Dict[str, Any],
                    classes: Optional[Dict[str, Sequence[int]]] = None
                    ) -> Dict[str, Any]:
    """Counts and latencies of one :func:`run`: ok and timed-out
    requests, preemptions (inside a superstep too), p50/p99/max latency
    of ``ok`` requests overall and per class (``classes``: name ->
    request indices), the largest overrun past a deadline and the tick
    that held it (``worst_overrun``), and the longest tick's record."""
    outcomes, sched = out["outcomes"], out["scheduler"]
    overruns = [o.overrun_s for o in outcomes if not o.ok]
    worst = max((o for o in outcomes if not o.ok),
                key=lambda o: o.overrun_s, default=None)
    lat = {"all": _quantiles([o.latency_s for o in outcomes if o.ok])}
    for name, idx in (classes or {}).items():
        lat[name] = _quantiles([outcomes[i].latency_s for i in idx
                                if outcomes[i].ok])
        lat[name + "_timeouts"] = sum(not outcomes[i].ok for i in idx)
    epochs: Dict[int, int] = {}
    for o in outcomes:
        if o.ok:
            epochs[o.epoch] = epochs.get(o.epoch, 0) + 1
    return {"requests": len(outcomes),
            "ok": sum(o.ok for o in outcomes), "timeouts": len(overruns),
            "preempted": sched.preempted,
            "preempted_in_superstep": sched.preempted_in_superstep,
            "delegated": sched.delegated, "cache_hits": sched.cache_hits,
            "peak_in_flight": sched.peak_in_flight,
            "ok_by_epoch": {str(k): v for k, v in sorted(epochs.items())},
            "latency_s": lat,
            "max_overrun_s": max(overruns) if overruns else None,
            "worst_overrun": None if worst is None else {
                "index": worst.index, "overrun_s": worst.overrun_s,
                **worst.settled},
            "max_tick_s": sched.metrics_snapshot()["rpq_tick_seconds"]["max"],
            "longest_tick": None if sched.longest_tick is None else {
                k: v for k, v in sched.longest_tick.items() if k != "at"},
            "update_s": out["update_s"], "gc": out["gc"],
            "serve_s": out["serve_s"],
            "http": {t: s for t, (s, _b) in out["scraped"].items()},
            "kernel_launches": {k: v for k, v in out["launches"].items()
                                if v}}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=("ring", "dense"), default="ring")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--shards", type=int, default=None,
                    help="partition the engine over N devices "
                         "(make_engine(..., shards=N))")
    ap.add_argument("--slots", type=int, default=8,
                    help="in-flight slot pool size, and the requests the "
                         "closed-loop client keeps in flight")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--deadline-s", type=float, default=60.0,
                    help="per-request deadline (the paper's 60 s)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace the served stream's spans and export "
                         "Chrome trace-event JSON to PATH")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write the /flight capture to PATH")
    ap.add_argument("--explain", action="store_true",
                    help="print EXPLAIN and ANALYZE of the first request")
    return ap.parse_args(argv)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> Dict[str, Any]:
    """The command line: build ``scale_free_graph(*GRAPH)``, serve
    ``--requests`` one-endpoint requests, check and replay; returns the
    report (also printed last)."""
    a = _args(argv)
    import torch
    from .core import fixtures
    from .core.engines import make_engine
    from .obs import trace as otrace
    graph = fixtures.scale_free_graph(*GRAPH)
    queries = one_endpoint_requests(graph, a.requests)
    adds = live_adds(graph.num_nodes, graph.num_preds)

    def build(kind, shards=None):
        kw = {"shards": shards} if shards else {}
        return make_engine(graph, kind, device=a.device, **kw)

    engine = build(a.kind, a.shards)
    if engine.device.type == "cuda":
        # build the kernels and start the card before the timed stream
        from .kernels import build_all
        build_all()
        torch.cuda.synchronize(engine.device)
    yardstick = build("dense")
    want = {0: yardstick.eval_many(queries)}
    if a.trace:
        otrace.TRACER.enable()
    out = run(engine, queries, slots=a.slots, concurrency=a.slots,
              deadline_s=a.deadline_s, adds=adds)
    if a.trace:
        otrace.TRACER.disable()
        otrace.TRACER.export(a.trace)
    yardstick.add_edges(adds)
    want[yardstick.epoch] = yardstick.eval_many(queries)
    report = {"kind": a.kind, "device": a.device, "shards": a.shards,
              "graph": dict(zip(("nodes", "preds", "edges", "seed"), GRAPH)),
              "slots": a.slots,
              "deadline_s": a.deadline_s, **latency_summary(out)}
    report["answers_equal_eval_many"] = check_answers(
        out["outcomes"], queries, want)
    _emit({"step": "served", **{k: report[k] for k in (
        "requests", "ok", "timeouts", "serve_s", "max_overrun_s")}})
    fresh = build(a.kind, a.shards)
    fresh.add_edges(adds)
    report["flight"] = replay(out["scraped"]["/flight"][1], fresh)
    if a.record:
        with open(a.record, "w") as f:
            f.write(out["scraped"]["/flight"][1])
    if a.explain:
        q = queries[0]
        _emit({"step": "explain", "report": engine.explain(q)})
        analyzed = engine.explain(q, analyze=True)["execution"]
        _emit({"step": "analyze", "supersteps": analyzed["supersteps"],
               "elapsed_ms": analyzed["elapsed_ms"],
               "results": analyzed["results"]})
    bad = [t for t, s in report["http"].items() if s != 200]
    if bad:
        raise AssertionError(f"endpoints answered non-200: {bad}")
    if report["flight"]["parity"] not in (None, 1.0):
        raise AssertionError(f"/flight replay parity "
                             f"{report['flight']['parity']}")
    over = report["max_overrun_s"]
    if over is not None and over > OVERRUN_BOUND_S:
        raise AssertionError(f"a timed-out request settled {over:.3f} s past "
                             f"its deadline (bound {OVERRUN_BOUND_S} s)")
    _emit(report)
    return report


if __name__ == "__main__":
    try:
        main()
    except AssertionError as e:
        print(f"serve: {e}", file=sys.stderr)
        sys.exit(1)
