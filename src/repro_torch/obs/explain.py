"""Query EXPLAIN / ANALYZE: structured per-query plan reports.

**EXPLAIN** (``engine.explain(query)``) answers *why did the planner
pick this shape* without executing anything: it parses, plans
(automaton + tables compile only — no superstep, no kernel dispatch),
prices the alternatives from :class:`repro_torch.core.stats.GraphStats`
selectivity, and predicts the per-superstep collective bytes on the
current shard layout from the same analytic wire model the trace audit
uses (all-gather: ``size * (n - 1) / n`` per device).  The report is a
plain dict of deterministic inputs — byte-identical JSON across calls
for an unchanged graph epoch — so it can be snapshot-tested.

**ANALYZE** (``engine.explain(query, analyze=True)``, or
``Query(explain=sink)`` through ``eval_many`` / the slot scheduler)
executes the query under a private :class:`repro_torch.obs.trace.Tracer` and
attaches a per-superstep timeline (frontier size, new activations,
tasks dispatched, kernel-dispatch count/time, shard skew) plus the
est-vs-actual frontier error — the planner-misprediction signal the
output-sensitive evaluation roadmap item needs.  The private tracer is
installed only for the measured call, so the global disabled path stays
free.

Everything from ``repro_torch.core`` is imported lazily inside functions:
``repro_torch.obs`` must stay importable from the core modules without a
cycle.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

from . import trace as otrace

__all__ = ["REPORT_VERSION", "ExplainSink", "explain_query",
           "analyze_query", "deliver", "validate_report"]

REPORT_VERSION = 1


class ExplainSink:
    """The simplest ``Query(explain=...)`` target: holds the last
    report delivered to it (``sink.report``)."""

    def __init__(self) -> None:
        self.report: Optional[Dict[str, Any]] = None

    def __call__(self, report: Dict[str, Any]) -> None:
        self.report = report


def deliver(sink: Any, report: Dict[str, Any]) -> None:
    """Hand ``report`` to a ``Query.explain`` sink: an
    :class:`ExplainSink`, any callable, or a plain dict (updated in
    place)."""
    if sink is None:
        return
    if isinstance(sink, dict):
        sink.update(report)
        return
    if callable(sink):
        sink(report)
        return
    raise TypeError(f"unsupported explain sink: {type(sink).__name__}")


def _engine_kind(engine) -> str:
    return "ring" if hasattr(engine, "ring") else "dense"


def _shard_layout(engine) -> Tuple[int, Tuple[str, ...]]:
    if _engine_kind(engine) == "ring":
        n = int(getattr(engine, "_num_shards", 0) or 0)
        axes = tuple(getattr(engine, "data_axes", ()) or ())
        return (n if n > 1 else 1), axes
    sh = getattr(engine, "sharded", None)
    if sh is None:
        return 1, ()
    return int(sh.num_shards), tuple(sh.data_axes)


def _collective_model(engine, qplan, automaton) -> Dict[str, Any]:
    """Predicted per-device wire bytes of one superstep's frontier
    all-gather on the current layout (the trace audit's wire model; 0
    off-mesh)."""
    n, _ = _shard_layout(engine)
    if n <= 1:
        return {"model": "all_gather", "num_shards": n,
                "bytes_per_superstep": 0}
    if _engine_kind(engine) == "dense":
        V = int(engine.dg.num_nodes)
        v_pad = -(-V // n) * n
        size = v_pad * (automaton.m + 1)          # int8 planes [V_pad, S]
    else:
        # ring task lists: packed uint32 state words per frontier task
        size = max(1.0, qplan.est_frontier) * automaton.nwords * 4
    return {"model": "all_gather", "num_shards": n,
            "bytes_per_superstep": int(size * (n - 1) / n)}


def _selectivity(engine, ast) -> Dict[str, Any]:
    stats = engine.graph_stats
    lits: Dict[str, Any] = {}
    for lit in ast.literals():
        name = str(lit)
        if name in lits:
            continue
        try:
            p = engine._resolve_lit(lit)
        except Exception:
            p = -1
        ok = 0 <= p < len(stats.freq)
        lits[name] = {
            "lit": name, "pred": int(p),
            "freq": int(stats.freq[p]) if ok else 0,
            "distinct_subj": int(stats.distinct_subj[p]) if ok else 0,
            "distinct_obj": int(stats.distinct_obj[p]) if ok else 0,
        }
    return {
        "num_nodes": int(stats.num_nodes),
        "num_edges": int(stats.num_edges),
        "avg_degree": round(float(stats.avg_degree), 6),
        "literals": [lits[k] for k in sorted(lits)],
    }


def explain_query(engine, query, analyze: bool = False,
                  deadline_s: Optional[float] = None) -> Dict[str, Any]:
    """Build the EXPLAIN report for ``query`` on ``engine``; with
    ``analyze=True`` also execute it and attach the superstep timeline
    (see :func:`analyze_query`, which returns the result rows too)."""
    if analyze:
        report, _ = analyze_query(engine, query, deadline_s=deadline_s)
        return report
    return _plan_report(engine, query, analyze=False)


def _plan_report(engine, query, analyze: bool) -> Dict[str, Any]:
    from ..core import regex as rx
    from ..core.engines import QueryStats, as_query, normalized_key, result_key

    q = as_query(query)
    ast = rx.parse(q.expr)
    key = normalized_key(ast)
    plan = engine._plan(ast)
    g = plan.g
    scratch = QueryStats()
    qplan = engine._decide(ast, q.subject is not None, q.obj is not None,
                           scratch)
    n_shards, axes = _shard_layout(engine)
    report: Dict[str, Any] = {
        "version": REPORT_VERSION,
        "engine": _engine_kind(engine),
        "analyze": bool(analyze),
        "query": {"expr": q.expr, "subject": q.subject, "obj": q.obj,
                  "limit": q.limit},
        "canonical_key": key,
        "automaton": {
            "states": g.m + 1,
            "words": g.nwords,
            "nullable": bool(g.nullable),
            "first_labels": sorted(str(l) for l in g.first_labels()),
            "last_labels": sorted(str(l) for l in g.last_labels()),
        },
        "plan": {
            "mode": qplan.mode,
            "policy": engine.planner,
            "split_pred": int(qplan.split_pred),
            "est_cost": {k: round(float(v), 6)
                         for k, v in sorted(qplan.est.items())},
            "est_frontier": round(float(qplan.est_frontier), 6),
        },
        "selectivity": _selectivity(engine, ast),
        "sharding": {"num_shards": n_shards, "data_axes": list(axes)},
        "collective": _collective_model(engine, qplan, g),
        "epoch": int(engine.epoch),
        "result_cached": engine.results.get_covering(result_key(q)) is not None,
    }
    return report


def _ring_timeline(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-superstep rows from enriched ``ring.superstep`` spans, with
    kernel dispatches attributed by time containment."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    rows = []
    for e in events:
        if e["name"] != "ring.superstep":
            continue
        t0, t1 = e["ts"], e["ts"] + e.get("dur", 0.0)
        mine = [k for k in kernels if t0 <= k["ts"] and
                k["ts"] + k.get("dur", 0.0) <= t1]
        a = e.get("args", {})
        tasks = int(a.get("tasks", 0))
        shards = max((int(k["args"].get("shards", 1)) for k in mine
                      if "shards" in k.get("args", {})), default=1)
        padded = sum(int(k["args"].get("tasks", 0)) for k in mine
                     if "shards" in k.get("args", {}))
        rows.append({
            "superstep": len(rows),
            "frontier": int(a.get("entries", 0)),
            "activations": int(a.get("activations", 0)),
            "reported": int(a.get("reported", 0)),
            "tasks": tasks,
            "kernel_dispatches": len(mine),
            "kernel_ms": round(sum(k.get("dur", 0.0) for k in mine) / 1e3, 6),
            "shards": shards,
            "skew_ratio": round(padded / tasks, 6) if shards > 1 and tasks
            else 1.0,
        })
    return rows


def _dense_timeline(collector: List[Dict[str, Any]],
                    events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-superstep rows from the host-stepped collector, joined 1:1
    (in order) with the ``dense.bfs_chunk`` kernel spans — analyzing
    runs step chunk=1, so each chunk dispatch IS one superstep."""
    kernels = [e for e in events if e["name"] == "dense.bfs_chunk"]
    rows = []
    for i, c in enumerate(collector):
        k = kernels[i] if i < len(kernels) else None
        rows.append({
            "superstep": i,
            "frontier": int(c["frontier"]),
            "activations": int(c["activations"]),
            "tasks": int(c["frontier"]),
            "kernel_dispatches": 1 if k is not None else 0,
            "kernel_ms": round(k.get("dur", 0.0) / 1e3, 6) if k else 0.0,
            "shards": 1,
            "skew_ratio": 1.0,
        })
    return rows


def analyze_query(engine, query, stats=None,
                  deadline_s: Optional[float] = None):
    """Execute ``query`` under a private tracer and return
    ``(report, result_pairs)``.  ``stats`` (a ``QueryStats``) is filled
    by the engine as usual — the scheduler passes the ticket's so
    latency attribution lands in both places."""
    from ..core.engines import QueryStats, as_query

    q = as_query(query)
    report = _plan_report(engine, q, analyze=True)
    if stats is None:
        stats = QueryStats()
    tr = otrace.Tracer()
    tr.enable()
    collector: List[Dict[str, Any]] = []
    kind = _engine_kind(engine)
    t0 = time.perf_counter()
    with otrace.use(tr):
        if kind == "dense":
            engine._analyze = collector
            try:
                out = engine.eval(q.expr, q.subject, q.obj, limit=q.limit,
                                  stats=stats, deadline_s=deadline_s)
            finally:
                engine._analyze = None
        else:
            out = engine.eval(q.expr, q.subject, q.obj, limit=q.limit,
                              stats=stats, deadline_s=deadline_s)
    elapsed = time.perf_counter() - t0
    events = tr.events
    timeline = _dense_timeline(collector, events) if kind == "dense" \
        else _ring_timeline(events)

    est = report["plan"]["est_frontier"]
    actual = float(stats.plan_actual_frontier)
    if actual == 0.0 and (q.subject is not None or q.obj is not None) \
            and report["plan"]["mode"] in ("forward", "reverse", "naive"):
        actual = 1.0   # anchored non-split plans seed from the one endpoint
    report["execution"] = {
        "results": len(out),
        "elapsed_ms": round(elapsed * 1e3, 3),
        "supersteps": len(timeline),
        "kernel_dispatches": sum(r["kernel_dispatches"] for r in timeline),
        "est_frontier": est,
        "actual_frontier": actual,
        "frontier_error": round((est - actual) / max(1.0, actual), 6),
        "epoch": int(stats.epoch),
        "stats": stats.as_dict(),
        "timeline": timeline,
    }
    return report, out


_TOP_KEYS = ("version", "engine", "analyze", "query", "canonical_key",
             "automaton", "plan", "selectivity", "sharding", "collective",
             "epoch", "result_cached")


def validate_report(report: Dict[str, Any]) -> None:
    """Schema check (hand-rolled; no jsonschema dependency).  Raises
    ``ValueError`` on any missing/ill-typed field."""
    def need(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"bad explain report: {msg}")

    need(isinstance(report, dict), "not a dict")
    for k in _TOP_KEYS:
        need(k in report, f"missing {k!r}")
    need(report["version"] == REPORT_VERSION,
         f"version {report['version']!r} != {REPORT_VERSION}")
    need(report["engine"] in ("ring", "dense"),
         f"engine {report['engine']!r}")
    for k in ("expr", "subject", "obj", "limit"):
        need(k in report["query"], f"query missing {k!r}")
    auto = report["automaton"]
    for k in ("states", "words", "nullable", "first_labels", "last_labels"):
        need(k in auto, f"automaton missing {k!r}")
    need(auto["states"] >= 1 and auto["words"] >= 1, "automaton sizes")
    plan = report["plan"]
    for k in ("mode", "policy", "split_pred", "est_cost", "est_frontier"):
        need(k in plan, f"plan missing {k!r}")
    need(plan["mode"] in ("forward", "reverse", "split", "naive"),
         f"plan mode {plan['mode']!r}")
    sel = report["selectivity"]
    for k in ("num_nodes", "num_edges", "avg_degree", "literals"):
        need(k in sel, f"selectivity missing {k!r}")
    for row in sel["literals"]:
        for k in ("lit", "pred", "freq", "distinct_subj", "distinct_obj"):
            need(k in row, f"selectivity literal missing {k!r}")
    sh = report["sharding"]
    need("num_shards" in sh and "data_axes" in sh, "sharding fields")
    col = report["collective"]
    for k in ("model", "num_shards", "bytes_per_superstep"):
        need(k in col, f"collective missing {k!r}")
    need(col["bytes_per_superstep"] >= 0, "negative collective bytes")
    if report["analyze"]:
        need("execution" in report, "analyze report missing execution")
        ex = report["execution"]
        for k in ("results", "elapsed_ms", "supersteps", "kernel_dispatches",
                  "est_frontier", "actual_frontier", "frontier_error",
                  "epoch", "stats", "timeline"):
            need(k in ex, f"execution missing {k!r}")
        for row in ex["timeline"]:
            for k in ("superstep", "frontier", "activations",
                      "kernel_dispatches", "kernel_ms"):
                need(k in row, f"timeline row missing {k!r}")
            need(row["frontier"] >= 0 and row["kernel_dispatches"] >= 0,
                 "negative timeline counters")
    else:
        need("execution" not in report, "explain-only report has execution")
    # the whole point: the report must be JSON-serializable & stable
    json.dumps(report, sort_keys=True)
