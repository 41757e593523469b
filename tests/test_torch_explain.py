"""The JAX package's flight-recorder and endpoint suite
(``tests/test_explain.py``) run on the port with ``device="cpu"``:
capture -> dump -> load -> replay parity under interleaved updates (the
replay held to the JAX engines too), timeout and backpressure records,
bounded-ring drop accounting, schema-valid dumps, earliest-deadline-first
admission, the self-observability metrics, and the ``/flight`` and
``/explain`` endpoints; then EXPLAIN's determinism and contents and the
scheduler's ANALYZE rules, each body run on both packages
(``torch_parity.both``)."""
import asyncio
import json

import pytest

torch = pytest.importorskip("torch")

from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.engines import make_engine as rmake  # noqa: E402
from repro.core.fixtures import random_graph  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engines import Query, make_engine  # noqa: E402
from repro_torch.core.scheduler import (AsyncServer, Backpressure,  # noqa: E402
                                        SlotScheduler)
from repro_torch.obs import recorder as orecorder  # noqa: E402
from repro_torch.obs.explain import validate_report  # noqa: E402
from torch_parity import both  # noqa: E402


def _graph(seed=3):
    return random_graph(12, 3, 40, seed=seed, pred_zipf=False)


def pmake(g, kind):
    return make_engine(convert.graph_from_reference(g), kind, device="cpu")


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_recorder_capture_dump_replay_parity_under_updates(tmp_path, kind):
    """Recorded queries settle at the final epoch; a fresh engine over
    the final effective graph (the port's, and the JAX package's) replays
    each with the recorded answer count."""
    g = _graph(seed=11)
    eng = pmake(g, kind)
    sched = SlotScheduler(eng, max_slots=2)
    sched.submit_update(add=[(0, 1, 5), (3, 0, 7)])
    sched.submit_update(remove=[(0, 1, 5)])
    sched.drain()
    queries = [Query("0/1*", obj=2), Query("2+", subject=1),
               Query("(0|1)/2", obj=4), Query("0/1*", obj=2),
               Query("0*", subject=2, limit=3)]
    for q in queries:
        sched.submit(q)
    sched.drain()
    path = str(tmp_path / f"wl-{kind}.jsonl")
    sched.recorder.dump(path, graph={"fixture": "random_graph",
                                     "args": [12, 3, 40]})
    header, records = orecorder.load(path)
    assert header["records"] == len(records) == len(queries)
    ok = [r for r in records if r["status"] == "ok"]
    assert len(ok) == len(queries)
    assert any(r["cache_hit"] for r in ok)           # the repeat query
    final = eng.effective_graph()
    replay = [(r["expr"], r["subject"], r["obj"], r["limit"]) for r in ok]
    outs = make_engine(final, kind, device="cpu").eval_many(
        [Query(*q) for q in replay])
    ref = rmake(final, kind).eval_many([RQuery(*q) for q in replay])
    for r, out, want in zip(ok, outs, ref):
        count = r["results"] if r["limit"] is None \
            else min(r["results"], r["limit"])
        assert len(out) == count and out == want, (kind, r["expr"])


def test_recorder_records_timeouts_and_backpressure():
    g = _graph(seed=13)
    clk = [0.0]
    sched = SlotScheduler(pmake(g, "ring"), max_slots=1, max_queue=2,
                          clock=lambda: clk[0])
    sched.submit(Query("0/1*", obj=2), deadline_s=0.5)
    sched.submit(Query("2+", obj=1))
    with pytest.raises(Backpressure):
        sched.submit(Query("0*", obj=3))
    clk[0] = 10.0
    sched.drain()
    statuses = [r["status"] for r in sched.recorder.records()]
    assert "shed" in statuses and "timeout" in statuses
    shed = next(r for r in sched.recorder.records() if r["status"] == "shed")
    assert shed["backpressure"] is True and shed["results"] is None
    for r in sched.recorder.records():
        orecorder.validate_record(r)


def test_recorder_ring_buffer_drop_accounting():
    rec = orecorder.FlightRecorder(capacity=4)
    base = {k: None for k in orecorder.REQUIRED_KEYS}
    for i in range(10):
        rec.append(dict(base, ts=float(i), status="ok"))
    assert rec.appended == 10 and rec.dropped == 6 and rec.occupancy == 4
    assert [r["ts"] for r in rec.records()] == [6.0, 7.0, 8.0, 9.0]
    h = rec.header()
    assert (h["appended"], h["dropped"], h["records"]) == (10, 6, 4)
    off = orecorder.FlightRecorder(capacity=0)
    off.append(dict(base, ts=0.0, status="ok"))
    assert off.appended == 1 == off.dropped and off.occupancy == 0
    with pytest.raises(ValueError):
        orecorder.validate_record({"ts": 0.0})
    with pytest.raises(ValueError):
        orecorder.validate_record(dict(base, status="exploded"))
    with pytest.raises(ValueError):
        orecorder.validate_header({"kind": "not-a-flight"})


def test_recorder_dump_is_schema_valid_jsonl(tmp_path):
    rec = orecorder.FlightRecorder(capacity=8)
    base = {k: None for k in orecorder.REQUIRED_KEYS}
    for i in range(3):
        rec.append(dict(base, ts=float(i), status="ok"))
    path = str(tmp_path / "wl.jsonl")
    rec.dump(path, graph={"fixture": "random_graph", "args": [12, 3, 40]})
    header, records = orecorder.load(path)
    assert header["kind"] == orecorder.RECORD_KIND
    assert header["version"] == orecorder.RECORD_VERSION
    assert header["graph"]["fixture"] == "random_graph"
    assert len(records) == 3
    lines = open(path).read().splitlines()
    for ln in lines[1:]:
        assert ln == json.dumps(json.loads(ln), sort_keys=True)


def test_edf_admission_pulls_earliest_deadline_forward():
    g = _graph(seed=2)

    def run(policy):
        clk = [0.0]
        sched = SlotScheduler(pmake(g, "ring"), max_slots=1,
                              admission_policy=policy,
                              clock=lambda: clk[0])
        order = []
        orig = sched._admit_one

        def spy(ticket, now):
            order.append(ticket.query.expr)
            return orig(ticket, now)

        sched._admit_one = spy
        sched.submit(Query("0/1*", obj=2))
        sched.step()
        sched.submit(Query("2+", obj=1), deadline_s=100.0)
        sched.submit(Query("0*", obj=3), deadline_s=5.0)
        sched.submit(Query("(0|1)/2", obj=4))
        sched.drain()
        return order

    assert run("edf") == ["0/1*", "0*", "2+", "(0|1)/2"]
    assert run("fifo") == ["0/1*", "2+", "0*", "(0|1)/2"]


def test_admission_policy_is_validated():
    g = _graph(seed=2)
    with pytest.raises(ValueError):
        SlotScheduler(pmake(g, "ring"), admission_policy="lifo")


def test_prometheus_exports_self_observability_metrics():
    g = _graph(seed=4)
    sched = SlotScheduler(pmake(g, "dense"), max_slots=2)
    q = Query("0/1*", obj=2)
    sched.submit(q)
    sched.drain()
    sched.submit(Query(q.expr, obj=q.obj))      # a result-cache hit
    sched.drain()
    text = sched.prometheus_text()
    for name in ("rpq_tracer_dropped_events_total",
                 "rpq_result_cache_hit_rate", "rpq_plan_cache_hit_rate",
                 "rpq_recorder_occupancy", "rpq_recorder_appended_total",
                 "rpq_recorder_dropped_total"):
        assert name in text, name
    lines = dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                 if ln and not ln.startswith("#"))
    assert float(lines["rpq_recorder_occupancy"]) == 2.0
    assert float(lines["rpq_recorder_appended_total"]) == 2.0
    hit_rate = float(lines["rpq_result_cache_hit_rate"])
    assert 0.0 < hit_rate <= 1.0


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_async_server_flight_and_explain_endpoints(kind):
    g = _graph(seed=6)
    sched = SlotScheduler(pmake(g, kind), max_slots=2)

    async def scrape(server, target):
        host, port = server.metrics_addr
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(f"GET {target} HTTP/1.0\r\n\r\n".encode())
        await writer.drain()
        raw = (await reader.read()).decode()
        writer.close()
        status = int(raw.split(" ", 2)[1])
        return status, raw.split("\r\n\r\n", 1)[1]

    async def main():
        async with AsyncServer(sched, metrics_port=0) as server:
            t = await server.submit(Query("0/1*", obj=2))
            await t.result()
            flight = await scrape(server, "/flight")
            plan = await scrape(server, "/explain?expr=0%2F1%2A&obj=2")
            analyzed = await scrape(
                server, "/explain?expr=0%2F1%2A&obj=2&analyze=1")
            missing = await scrape(server, "/explain")
            nope = await scrape(server, "/nope")
        return flight, plan, analyzed, missing, nope

    flight, plan, analyzed, missing, nope = asyncio.run(main())
    assert flight[0] == 200
    header = json.loads(flight[1].splitlines()[0])
    orecorder.validate_header(header)
    assert header["records"] == 1
    assert plan[0] == 200
    report = json.loads(plan[1])
    validate_report(report)
    assert "execution" not in report
    assert report["engine"] == kind
    assert analyzed[0] == 200
    analyzed_report = json.loads(analyzed[1])
    validate_report(analyzed_report)
    assert analyzed_report["execution"]["timeline"]
    assert missing[0] == 400 and nope[0] == 404


# -- EXPLAIN, and ANALYZE under the scheduler ---------------------------------


def test_explain_is_deterministic_and_execution_free():
    def body(P):
        ox, ot = P.ox, P.ot
        g = _graph()
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            q = P.Query("0/1*", obj=2)
            tr = ot.Tracer()
            tr.enable()
            with ot.use(tr):
                r1 = eng.explain(q)
            ox.validate_report(r1)
            assert r1["engine"] == kind and r1["analyze"] is False
            assert "execution" not in r1
            kernel = [e for e in tr.events if e.get("cat") == "kernel"]
            steps = [e for e in tr.events
                     if e["name"].endswith(".superstep")]
            assert kernel == [] and steps == [], (kind, tr.events)
            r2 = eng.explain(q)
            text = json.dumps(r1, sort_keys=True)
            assert text == json.dumps(r2, sort_keys=True)
            out.append((text, sorted(e["name"] for e in tr.events)))
        return out
    both(body)


def test_explain_report_contents():
    def body(P):
        ox = P.ox
        eng = P.make_engine(_graph(), "dense")
        r = eng.explain(P.Query("(0|1)/2", obj=4))
        assert r["automaton"]["states"] == 4
        assert r["plan"]["mode"] in ("forward", "reverse", "split", "naive")
        lits = {row["lit"] for row in r["selectivity"]["literals"]}
        assert lits == {"0", "1", "2"}
        for row in r["selectivity"]["literals"]:
            assert row["freq"] >= 0 and row["distinct_subj"] >= 0
        assert r["collective"]["bytes_per_superstep"] == 0
        assert r["result_cached"] is False
        eng.eval_many([P.Query("(0|1)/2", obj=4)])
        cached = eng.explain(P.Query("(0|1)/2", obj=4))
        assert cached["result_cached"] is True
        return (json.dumps(r, sort_keys=True),
                json.dumps(cached, sort_keys=True))
    both(body)


def test_analyze_respects_scheduler_deadline():
    """The reference's injected clock: the ticket's 1 s deadline passes
    (the clock jumps to 5 s) before admission, so it times out and its
    sink gets no report."""
    def body(P):
        Sched, ox = P.SlotScheduler, P.ox
        clk = [0.0]
        sched = Sched(P.make_engine(_graph(), "ring"), max_slots=1,
                      clock=lambda: clk[0])
        sink = ox.ExplainSink()
        t = sched.submit(P.Query("0/1*", obj=2, explain=sink),
                         deadline_s=1.0)
        clk[0] = 5.0
        sched.drain()
        with pytest.raises(TimeoutError) as err:
            t.result()
        assert sink.report is None
        return str(err.value), [(r["status"], r["expr"])
                                for r in sched.recorder.records()]
    both(body)


def test_scheduler_analyzes_even_when_cached():
    def body(P):
        Sched, ox = P.SlotScheduler, P.ox
        sched = Sched(P.make_engine(_graph(seed=9), "dense"), max_slots=2)
        q = P.Query("0/1*", obj=3)
        t0 = sched.submit(q)
        sched.drain()
        sink = ox.ExplainSink()
        t1 = sched.submit(P.Query(q.expr, obj=q.obj, explain=sink))
        sched.drain()
        assert t1.result() == t0.result()
        ox.validate_report(sink.report)
        tl = sink.report["execution"]["timeline"]
        assert tl, "ANALYZE must execute (and produce a timeline)"
        return t1.result(), sink.report["plan"], \
            [(r["frontier"], r["activations"]) for r in tl]
    both(body)
