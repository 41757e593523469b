"""The JAX package's slot-scheduler suite (``tests/test_scheduler.py``)
run on the port with ``device="cpu"``: parity with one-shot
``eval_many`` over random arrival interleavings (both engines, also
under interleaved updates), admission backpressure, deadline
preemption, limits, the result-cache fast path, the dynamic PlanBundle
slot allocator, the async layer, latency attribution, spans and the
metrics endpoint.  Wherever answers are compared, the JAX engines'
``eval_many`` and the oracle are the yardstick."""
import asyncio
import json
import random

import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from repro.core.engines import Query as RQuery, eval_many as reval_many  # noqa: E402
from repro.core.engines import make_engine as rmake  # noqa: E402
from repro.core.fixtures import random_graph  # noqa: E402
from repro.core.oracle import eval_oracle  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engines import PlanBundle, Query, eval_many  # noqa: E402
from repro_torch.core.engines import make_engine  # noqa: E402
from repro_torch.core.scheduler import (AsyncServer, Backpressure,  # noqa: E402
                                        SlotScheduler)

EXPRS = ["0/1*", "(0|1)/2", "2+", "^1/0*", "0/1/2", "(0|2)*"]
KINDS = ("ring", "dense")


def pmake(g, kind):
    return make_engine(convert.graph_from_reference(g), kind, device="cpu")


def _random_query(rnd, V):
    expr = rnd.choice(EXPRS)
    shape = rnd.randrange(4)
    if shape == 0:
        return Query(expr, obj=rnd.randrange(V))
    if shape == 1:
        return Query(expr, subject=rnd.randrange(V))
    if shape == 2:
        return Query(expr, subject=rnd.randrange(V), obj=rnd.randrange(V))
    return Query(expr)            # unanchored — delegated synchronously


def _ref(queries):
    return [RQuery(q.expr, q.subject, q.obj, q.limit) for q in queries]


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000))
def test_scheduler_matches_eval_many_random_interleavings(seed):
    """Continuous admission/retirement returns exactly the one-shot
    ``eval_many`` answer sets of the port and of the JAX engine, on both
    engines; streamed pairs union to the final answer."""
    rnd = random.Random(seed)
    g = random_graph(12, 3, 40, seed=1 + seed % 7, pred_zipf=False)
    queries = [_random_query(rnd, g.num_nodes)
               for _ in range(rnd.randrange(4, 14))]
    for kind in KINDS:
        eng = pmake(g, kind)
        want = eval_many(pmake(g, kind), queries)
        assert want == reval_many(rmake(g, kind), _ref(queries)), kind
        sched = SlotScheduler(eng, max_slots=rnd.randrange(1, 5))
        tickets: list = []
        i = 0
        while i < len(queries) or sched.pending():
            if i < len(queries) and rnd.random() < 0.5:
                tickets.append(sched.submit(queries[i]))
                i += 1
            else:
                sched.step()
        for q, t, w in zip(queries, tickets, want):
            assert t.result() == w, (kind, q)
            if q.limit is None:
                assert t._emitted == w, (kind, q)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000))
def test_scheduler_snapshot_isolation_under_updates(seed):
    """Interleaved submit / step / submit_update: every ticket's answer
    equals the oracle on the effective graph at its admission epoch, and
    the JAX engine's ``eval_many`` on that graph."""
    rnd = random.Random(seed)
    g = random_graph(11, 3, 35, seed=2 + seed % 5, pred_zipf=False)
    V, P = g.num_nodes, g.num_preds
    for kind in KINDS:
        eng = pmake(g, kind)
        sched = SlotScheduler(eng, max_slots=2)
        snapshots = {0: eng.effective_graph()}
        issued = []
        for _ in range(rnd.randrange(10, 30)):
            op = rnd.random()
            if op < 0.45:
                q = _random_query(rnd, V)
                issued.append((sched.submit(q), q))
            elif op < 0.65:
                adds = [(rnd.randrange(V), rnd.randrange(P),
                         rnd.randrange(V))
                        for _ in range(rnd.randrange(1, 3))]
                rems = [(rnd.randrange(V), rnd.randrange(P),
                         rnd.randrange(V))]
                ep = sched.submit_update(add=adds, remove=rems)
                snapshots[ep] = eng.effective_graph()
            else:
                sched.step()
        sched.drain()
        for ticket, q in issued:
            snap = snapshots[ticket.epoch]
            want = eval_oracle(snap, q.expr, q.subject, q.obj)
            ref = rmake(snap, kind).eval_many(_ref([q]))[0]
            assert ticket.result() == want == ref, (kind, q, ticket.epoch)


def test_backpressure_rejects_at_max_queue():
    g = random_graph(10, 2, 20, seed=2, pred_zipf=False)
    sched = SlotScheduler(pmake(g, "ring"), max_slots=1, max_queue=2)
    sched.submit(Query("0/1*", obj=1))
    sched.submit(Query("0/1*", obj=2))
    with pytest.raises(Backpressure):
        sched.submit(Query("0/1*", obj=3))
    assert sched.rejected == 1
    sched.drain()
    t = sched.submit(Query("0/1*", obj=3))
    sched.drain()
    assert t.result() == eval_oracle(g, "0/1*", None, 3) == \
        rmake(g, "ring").eval("0/1*", None, 3)


def test_deadline_preempts_in_flight_slot_and_spares_stragglers():
    g = random_graph(12, 3, 40, seed=6, pred_zipf=False)
    clk = [0.0]
    for kind in KINDS:
        sched = SlotScheduler(pmake(g, kind), max_slots=1,
                              clock=lambda: clk[0])
        clk[0] = 0.0
        slow = sched.submit(Query("(0|1|2)*", obj=5), deadline_s=1.0)
        fast = sched.submit(Query("0/1*", obj=3))
        sched.step()                  # admits `slow` into the only slot
        assert slow.state == "running"
        clk[0] = 2.0                  # past the deadline mid-flight
        sched.drain()
        with pytest.raises(TimeoutError):
            slow.result()
        assert sched.preempted == 1 and sched.in_flight == 0
        assert fast.result() == eval_oracle(g, "0/1*", None, 3) == \
            rmake(g, kind).eval("0/1*", None, 3), kind


def test_deadline_expires_queued_ticket_before_admission():
    g = random_graph(10, 2, 20, seed=2, pred_zipf=False)
    clk = [0.0]
    sched = SlotScheduler(pmake(g, "ring"), clock=lambda: clk[0])
    t = sched.submit(Query("0/1*", obj=1), deadline_s=0.5)
    clk[0] = 1.0
    sched.drain()
    with pytest.raises(TimeoutError):
        t.result()
    assert sched.preempted == 1 and sched.preempted_in_superstep == 0


def test_limit_queries_do_not_stream_and_truncate_sorted():
    g = random_graph(12, 3, 45, seed=19, pred_zipf=False)
    full = sorted(eval_oracle(g, "0/1*", None, 3))
    assert len(full) >= 2, "fixture must have enough results to truncate"
    for kind in KINDS:
        sched = SlotScheduler(pmake(g, kind))
        t = sched.submit(Query("0/1*", obj=3, limit=2))
        sched.drain()
        assert t.new_pairs() == []
        assert t.result() == set(full[:2]) == \
            rmake(g, kind).eval("0/1*", None, 3, limit=2), kind


def test_result_cache_hit_completes_without_occupying_a_slot():
    g = random_graph(10, 2, 20, seed=2, pred_zipf=False)
    sched = SlotScheduler(pmake(g, "ring"))
    a = sched.submit(Query("0/1*", obj=1))
    sched.drain()
    b = sched.submit(Query("0/1*", obj=1))
    sched.step()
    assert b.done and b.result() == a.result() == \
        rmake(g, "ring").eval("0/1*", None, 1)
    assert sched.cache_hits == 1 and sched.admitted == 1


class _G:                          # minimal stand-in with a state count
    def __init__(self, m):
        self.m = m


class _P:
    def __init__(self, m):
        self.g = _G(m)


def test_plan_bundle_dynamic_slots_reuse_freed_blocks():
    b = PlanBundle.empty()
    p1, p2, p3 = _P(2), _P(6), _P(2)
    off1 = b.add_slot(p1, p1.g.m + 1)        # bucket 4
    off2 = b.add_slot(p2, p2.g.m + 1)        # bucket 8
    assert (off1, off2) == (0, 4)
    assert b.padded_total >= b.S_total
    b.free_slot(p1)
    assert b.add_slot(p3, p3.g.m + 1) == off1
    assert len(b.live_plans()) == 2
    off2b = b.add_slot(p2, p2.g.m + 1)
    assert off2b == off2
    b.free_slot(p2)
    assert any(p is p2 for p, _ in b.live_plans())
    b.free_slot(p2)
    assert not any(p is p2 for p, _ in b.live_plans())


def test_plan_bundle_static_build_rejects_slot_ops():
    b = PlanBundle.build([_P(2)], [3])
    with pytest.raises(ValueError):
        b.add_slot(_P(2), 3)


def test_async_server_streams_pairs_and_settles():
    g = random_graph(12, 3, 40, seed=6, pred_zipf=False)
    eng = pmake(g, "dense")

    async def main():
        async with AsyncServer(SlotScheduler(eng, max_slots=2)) as server:
            t1 = await server.submit(Query("0/1*", obj=3))
            t2 = await server.submit(Query("(0|1)/2", subject=2))
            streamed = [p async for p in t1]
            return streamed, await t1.result(), await t2.result()

    streamed, r1, r2 = asyncio.run(main())
    ref = rmake(g, "dense")
    assert set(streamed) == r1 == eval_oracle(g, "0/1*", None, 3) == \
        ref.eval("0/1*", None, 3)
    assert r2 == eval_oracle(g, "(0|1)/2", 2, None) == \
        ref.eval("(0|1)/2", 2, None)


def test_async_server_interleaves_updates():
    g = random_graph(11, 3, 35, seed=23, pred_zipf=False)
    eng = pmake(g, "ring")

    async def main():
        sched = SlotScheduler(eng, max_slots=2)
        async with AsyncServer(sched) as server:
            before = eng.effective_graph()
            t1 = await server.submit(Query("0/1*", obj=3))
            server.submit_update(add=[(0, 1, 3), (2, 0, 1)])
            after = eng.effective_graph()
            t2 = await server.submit(Query("0/1*", obj=3))
            return before, after, await t1.result(), await t2.result(), t1, t2

    before, after, r1, r2, t1, t2 = asyncio.run(main())
    at1 = before if t1.ticket.epoch == 0 else after
    assert r1 == eval_oracle(at1, "0/1*", None, 3) == \
        rmake(at1, "ring").eval("0/1*", None, 3)
    assert t2.ticket.epoch == 1
    assert r2 == eval_oracle(after, "0/1*", None, 3) == \
        rmake(after, "ring").eval("0/1*", None, 3)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000))
def test_latency_attribution_sums_under_random_interleavings(seed):
    """queue_wait_s + service_s equals the end-to-end latency under the
    injectable clock, across interleavings, cache hits, delegated
    queries and both engines."""
    rnd = random.Random(seed)
    g = random_graph(12, 3, 40, seed=1 + seed % 7, pred_zipf=False)
    clk = [0.0]
    for kind in KINDS:
        sched = SlotScheduler(pmake(g, kind),
                              max_slots=rnd.randrange(1, 4),
                              clock=lambda: clk[0])
        queries = [_random_query(rnd, g.num_nodes)
                   for _ in range(rnd.randrange(3, 9))]
        tickets = []
        i = 0
        while i < len(queries) or sched.pending():
            clk[0] += rnd.random() * 0.01
            if i < len(queries) and rnd.random() < 0.5:
                tickets.append(sched.submit(queries[i]))
                i += 1
            else:
                sched.step()
        for t in tickets:
            assert t.state == "done"
            s = t.stats
            assert s.queue_wait_s >= 0.0 and s.service_s >= 0.0
            assert s.queue_wait_s + s.service_s == pytest.approx(
                t.finished_at - t.submitted_at, rel=1e-12, abs=1e-12)
            assert s.supersteps_s <= s.service_s + 1e-12


def test_zero_slack_deadline_preempts_deterministically():
    """now == deadline preempts — a queued ticket and one holding a
    slot — and preempted tickets record their queue wait."""
    g = random_graph(12, 3, 40, seed=6, pred_zipf=False)
    clk = [0.0]
    sched = SlotScheduler(pmake(g, "ring"), max_slots=1,
                          clock=lambda: clk[0])
    running = sched.submit(Query("(0|1|2)*", obj=5), deadline_s=1.0)
    sched.step()
    assert running.state == "running"
    queued = sched.submit(Query("0/1*", obj=3), deadline_s=1.0)
    clk[0] = 1.0
    sched.step()
    for t in (running, queued):
        assert t.state == "failed"
        with pytest.raises(TimeoutError):
            t.result()
    assert sched.preempted == 2
    assert queued.stats.queue_wait_s == pytest.approx(1.0)
    snap = sched.metrics_snapshot()
    assert snap["rpq_preempted_queue_wait_seconds"]["count"] == 2
    assert snap["rpq_preempted_queue_wait_seconds"]["max"] >= 1.0


def test_spans_cover_scheduler_and_both_engines():
    """A traced drain produces admission, superstep and retire spans plus
    the engine's own superstep span, for both engines; the module tracer,
    off by default, records nothing."""
    from repro_torch.obs import trace as otrace
    g = random_graph(12, 3, 40, seed=6, pred_zipf=False)
    for kind, eng_span in (("ring", "ring.superstep"),
                           ("dense", "dense.superstep")):
        tr = otrace.Tracer()
        tr.enable()
        with otrace.use(tr):
            sched = SlotScheduler(pmake(g, kind), max_slots=2)
            sched.submit(Query("0/1*", obj=3))
            sched.submit(Query("(0|1)/2", subject=2))
            sched.drain()
        names = {e["name"] for e in tr.events}
        assert {"scheduler.tick", "scheduler.admit", "scheduler.superstep",
                "scheduler.retire", eng_span} <= names, (kind, names)
        json.dumps(tr.chrome_trace())
    sched = SlotScheduler(pmake(g, "ring"), max_slots=2)
    assert not otrace.TRACER.enabled
    sched.submit(Query("0/1*", obj=3))
    sched.drain()
    assert otrace.TRACER.events == []


def test_async_server_metrics_endpoint_scrapes():
    g = random_graph(10, 2, 20, seed=2, pred_zipf=False)
    eng = pmake(g, "dense")

    async def main():
        sched = SlotScheduler(eng, max_slots=2)
        async with AsyncServer(sched, metrics_port=0) as server:
            t = await server.submit(Query("0/1*", obj=1))
            await t.result()
            host, port = server.metrics_addr
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(b"GET /metrics HTTP/1.0\r\n\r\n")
            await writer.drain()
            data = await reader.read()
            writer.close()
            return data.decode()

    text = asyncio.run(main())
    head, body = text.split("\r\n\r\n", 1)
    assert "200 OK" in head
    assert "rpq_completed_total 1" in body
    assert "rpq_preempted_in_superstep_total 0" in body
    assert 'rpq_e2e_seconds{quantile="0.5"}' in body
