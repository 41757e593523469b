"""Live updates, the slot scheduler and EXPLAIN ANALYZE on the port's
dense engine against the JAX package's, on the CPU (see
``torch_parity``): equal answers, counters, epochs and timelines.
Graphs stay small (V <= 30): every new shape compiles on the JAX side.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import fixtures as rfix  # noqa: E402
from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.oracle import eval_oracle  # noqa: E402
from repro.core.scheduler import SlotScheduler as RSched  # noqa: E402
from repro.obs import explain as rexplain  # noqa: E402
from repro.obs import trace as rtrace  # noqa: E402
from repro_torch.core.engines import Query  # noqa: E402
from repro_torch.core.scheduler import SlotScheduler as PSched  # noqa: E402
from repro_torch.obs import explain as pexplain  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402
from torch_parity import (BINDINGS, check_dense_eval,  # noqa: E402
                          check_dense_eval_many, dense_engines)

EXPRS = ["0/1*", "(0|1)/2", "2+", "^1/0*", "0/1/2", "(0|2)*"]


@pytest.mark.parametrize("seed", [0, 1])
def test_live_updates_parity_with_compaction_at_every_epoch(seed):
    """add_edges / remove_edges on both packages' dense engines, one pair
    compacting after every mutation: equal answers, counters and
    effective graphs at every epoch, and compaction changes nothing."""
    rnd = random.Random(seed)
    g = rfix.random_graph(24, 3, 80, seed=seed + 3)
    ref, port = dense_engines(g)
    ref_c, port_c = dense_engines(g)

    def check_epoch():
        eff = ref.effective_graph()
        for r, p in ((ref, port), (ref_c, port_c)):
            assert p.epoch == r.epoch == ref.epoch
            pe = p.effective_graph()
            for f in ("s", "p", "o"):
                np.testing.assert_array_equal(np.sort(getattr(pe, f)),
                                              np.sort(getattr(eff, f)))
            for expr in EXPRS[:3]:
                for s, o in BINDINGS:
                    check_dense_eval(r, p, eff, expr, s, o)
                check_dense_eval(r, p, eff, expr, None, 2, deadline_s=60.0)
            qs = [(e, None, rnd.randrange(24)) for e in EXPRS[:4]]
            check_dense_eval_many(r, p, eff, qs)

    check_epoch()
    for step in range(3):
        adds = [(rnd.randrange(24), rnd.randrange(3), rnd.randrange(24))
                for _ in range(4)]
        rems = [(int(g.s[step]), int(g.p[step]), int(g.o[step]))]
        for eng in (ref, port, ref_c, port_c):
            eng.add_edges(adds)
            eng.remove_edges(rems)
        port_c.compact()
        ref_c.compact()
        check_epoch()
    assert port_c.compactions == ref_c.compactions == 3
    assert port._eff is not None and port_c._eff is None


def test_live_update_insert_buffer_is_unsorted_and_padded():
    """Inserts land after the base edges, unsorted by subject and padded
    to a power of two with inert-label rows; tombstoned base edges take
    the inert label."""
    g = rfix.random_graph(16, 2, 40, seed=5)
    _ref, port = dense_engines(g)
    L = port.dg.num_labels
    E = port.dg.edges.subj.numel()
    port.add_edges([(9, 0, 1), (2, 1, 3), (7, 0, 0)])
    port.remove_edges([(int(g.s[0]), int(g.p[0]), int(g.o[0]))])
    eff = port._edges()
    subj, pred = eff.subj, eff.pred
    assert subj.numel() == E + 8
    assert (pred[:E] == L).sum() == 2        # the edge and its inverse
    tail = subj[E:E + 6].tolist()
    assert tail != sorted(tail) and (pred[E + 6:] == L).all()


def _script(rnd, V, P, n):
    """A random interleaving of submits, ticks and live updates."""
    ops = []
    for _ in range(n):
        r = rnd.random()
        if r < 0.45:
            shape = rnd.randrange(4)
            e = rnd.choice(EXPRS)
            v, w = rnd.randrange(V), rnd.randrange(V)
            ops.append(("submit", (e, None, v) if shape == 0 else
                        (e, v, None) if shape == 1 else
                        (e, v, w) if shape == 2 else (e, None, None)))
        elif r < 0.6:
            ops.append(("update",
                        [(rnd.randrange(V), rnd.randrange(P), rnd.randrange(V))
                         for _ in range(2)],
                        [(rnd.randrange(V), rnd.randrange(P), rnd.randrange(V))]))
        else:
            ops.append(("step",))
    return ops


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000))
def test_scheduler_interleaving_parity(seed):
    """The same random interleaving on both packages' slot schedulers
    over dense engines (one or two supersteps a tick): every ticket's
    answer and epoch agree and equal the oracle on the effective graph
    at the ticket's admission epoch; the engines' counters agree."""
    rnd = random.Random(seed)
    g = rfix.random_graph(14, 3, 45, seed=seed % 13, pred_zipf=False)
    ref, port = dense_engines(g)
    per_tick = 1 + seed % 2
    rs = RSched(ref, max_slots=3, steps_per_tick=per_tick)
    ps = PSched(port, max_slots=3, steps_per_tick=per_tick)
    snapshots = {0: ref.effective_graph()}
    tickets = []
    for op in _script(rnd, g.num_nodes, g.num_preds, 24):
        if op[0] == "submit":
            tickets.append((op[1], rs.submit(RQuery(*op[1])),
                            ps.submit(Query(*op[1]))))
        elif op[0] == "update":
            ep = rs.submit_update(add=op[1], remove=op[2])
            assert ps.submit_update(add=op[1], remove=op[2]) == ep
            snapshots[ep] = ref.effective_graph()
        else:
            assert ps.step() == rs.step()
    rs.drain()
    ps.drain()
    for q, rt, pt in tickets:
        assert pt.epoch == rt.epoch
        assert pt.result() == rt.result() == eval_oracle(snapshots[pt.epoch],
                                                         *q)
        if q[1] is None or q[2] is None:
            assert pt._emitted == rt._emitted
    assert ps.admitted == rs.admitted and ps.completed == rs.completed
    assert port.hetero_dispatches == ref.hetero_dispatches
    assert port._superstep_acc == ref._superstep_acc
    assert port.traces.retraces == ref.traces.retraces


def test_scheduler_deadline_preempts_and_spans_cover_dense():
    """A deadline preempts an in-flight dense slot and frees it for the
    query behind it; a traced drain records the dense engine's
    ``dense.superstep`` and ``dense.bfs_chunk`` spans (rows, width,
    live), as the reference's does."""
    g = rfix.random_graph(12, 3, 40, seed=6, pred_zipf=False)
    clk = [0.0]
    _ref, port = dense_engines(g)
    sched = PSched(port, max_slots=1, clock=lambda: clk[0])
    slow = sched.submit(Query("(0|1|2)*", obj=5), deadline_s=1.0)
    fast = sched.submit(Query("0/1*", obj=3))
    sched.step()
    assert slow.state == "running"
    clk[0] = 2.0
    sched.drain()
    with pytest.raises(TimeoutError):
        slow.result()
    assert sched.preempted == 1 and sched.in_flight == 0
    assert fast.result() == eval_oracle(g, "0/1*", None, 3)

    spans = []
    ref, port = dense_engines(g)
    for tr_mod, sched_cls, eng, q_cls in (
            (rtrace, RSched, ref, RQuery), (otrace, PSched, port, Query)):
        tr = tr_mod.Tracer()
        tr.enable()
        with tr_mod.use(tr):
            sched = sched_cls(eng, max_slots=2)
            sched.submit(q_cls("0/1*", obj=3))
            sched.submit(q_cls("(0|1)/2", subject=2))
            sched.drain()
        spans.append([(e["name"], e.get("args", {})) for e in tr.events
                      if e["name"].startswith("dense.")])
    assert spans[0] == spans[1]
    assert {"dense.superstep", "dense.bfs_chunk"} <= {n for n, _ in spans[1]}


ANALYZE_CASES = [
    ("cost", ("0/1*", None, 3)),            # anchored, obj
    ("reverse", ("0/1*", 1, 3)),            # forced reverse
    ("cost", ("0/1*", 3, None)),            # anchored, subj
    ("cost", ("(0|1)/2", 1, 4)),            # both bound
    ("split", ("0/1", None, 2)),            # forced split
    ("cost", ("0/1*", None, None)),         # unanchored
]


@pytest.mark.parametrize("planner,q", ANALYZE_CASES)
def test_analyze_timeline_matches_reference(planner, q):
    """EXPLAIN ANALYZE on both dense engines: the same plan, automaton
    and answers, and per-superstep timelines equal row for row
    (superstep, frontier, activations, tasks, dispatches)."""
    g = rfix.random_graph(14, 3, 50, seed=5, pred_zipf=False)
    ref, port = dense_engines(g, planner=planner)
    want, want_res = rexplain.analyze_query(ref, RQuery(*q))
    got, got_res = pexplain.analyze_query(port, Query(*q))
    pexplain.validate_report(got)
    assert got_res == want_res == eval_oracle(g, *q)
    assert got["plan"] == want["plan"]
    assert got["automaton"] == want["automaton"]
    keys = ("superstep", "frontier", "activations", "tasks",
            "kernel_dispatches", "shards", "skew_ratio")
    tl = got["execution"]["timeline"]
    assert [{k: r[k] for k in keys} for r in tl] == \
        [{k: r[k] for k in keys} for r in want["execution"]["timeline"]]
    assert got["execution"]["supersteps"] == len(tl) >= 1
    for f in ("supersteps", "results", "plan_mode", "plan_actual_frontier"):
        assert got["execution"]["stats"][f] == want["execution"]["stats"][f]


def test_eval_many_delivers_analyze_reports():
    """ANALYZE-tagged queries inside a dense ``eval_many`` deliver their
    report and settle like any other query."""
    g = rfix.random_graph(14, 3, 50, seed=5, pred_zipf=False)
    _ref, port = dense_engines(g)
    got = {}
    qs = [Query("0/1*", obj=3, explain=lambda r: got.setdefault("r", r)),
          Query("2+", subject=1)]
    res = port.eval_many(qs)
    assert res[0] == eval_oracle(g, "0/1*", None, 3)
    assert res[1] == eval_oracle(g, "2+", 1, None)
    assert got["r"]["analyze"] and got["r"]["execution"]["timeline"]
