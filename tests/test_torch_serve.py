"""The port's serving entry point (``repro_torch.serve``) on the CPU: the
closed-loop stream through ``AsyncServer`` with a live update halfway,
the three HTTP endpoints, and the ``/flight`` replay; every served
answer equal to the JAX engines' ``eval_many`` at its ticket's epoch."""
import pytest

torch = pytest.importorskip("torch")

from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.engines import make_engine as rmake  # noqa: E402
from repro.core.fixtures import scale_free_graph  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.core.engines import make_engine  # noqa: E402


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_served_answers_equal_reference_at_each_epoch(kind):
    g = scale_free_graph(300, 4, 1500, seed=3)
    pg = convert.graph_from_reference(g)
    queries = serve.one_endpoint_requests(pg, 60)
    adds = serve.live_adds(g.num_nodes, g.num_preds)
    ref = rmake(g, "dense")
    rq = [RQuery(q.expr, q.subject, q.obj) for q in queries]
    want = {0: ref.eval_many(rq)}
    ref.add_edges(adds)
    want[ref.epoch] = ref.eval_many(rq)
    out = serve.run(make_engine(pg, kind, device="cpu"), queries, slots=4,
                    concurrency=6, deadline_s=60.0, adds=adds)
    assert out["update_epoch"] == 1
    assert serve.check_answers(out["outcomes"], queries, want) == 60
    report = serve.latency_summary(out, {"even": range(0, 60, 2)})
    assert report["ok"] == 60 and report["timeouts"] == 0
    assert set(report["ok_by_epoch"]) == {"0", "1"}
    assert report["latency_s"]["even"]["n"] == 30
    assert all(status == 200 for status in report["http"].values())
    fresh = make_engine(pg, kind, device="cpu")
    fresh.add_edges(adds)
    replayed = serve.replay(out["scraped"]["/flight"][1], fresh)
    assert replayed["records"] == 60 and replayed["replayed"] > 0
    assert replayed["parity"] == 1.0


def test_timeouts_settle_and_report_overrun():
    """A deadline no request can meet: every ticket times out, none
    answers, and each overrun is measured from its own deadline."""
    g = convert.graph_from_reference(scale_free_graph(300, 4, 1500, seed=3))
    queries = serve.one_endpoint_requests(g, 12)
    out = serve.run(make_engine(g, "ring", device="cpu"), queries, slots=4,
                    concurrency=4, deadline_s=1e-9)
    report = serve.latency_summary(out)
    assert report["timeouts"] == 12 and report["ok"] == 0
    assert report["preempted"] == 12
    assert 0.0 <= report["max_overrun_s"] < 5.0


def test_worst_overrun_names_its_tick():
    """The summary names where the worst overrun's ticket settled and the
    tick that held it: settled no earlier than that tick began and no
    later than its client resumed; a tick that preempted a queued ticket
    ended there.  The longest tick's record is the histogram's max."""
    g = convert.graph_from_reference(scale_free_graph(300, 4, 1500, seed=3))
    queries = serve.one_endpoint_requests(g, 12)
    out = serve.run(make_engine(g, "ring", device="cpu"), queries, slots=4,
                    concurrency=4, deadline_s=1e-9)
    report = serve.latency_summary(out)
    worst = report["worst_overrun"]
    assert worst["overrun_s"] == report["max_overrun_s"]
    assert worst["tick_began_s"] <= worst["settled_s"] <= worst["overrun_s"]
    assert worst["where"] == "queued" and worst["tick"]["ended_after_expire"]
    assert worst["tick"]["superstep_s"] == 0.0 and worst["tick"]["settled"]
    assert report["longest_tick"]["s"] == report["max_tick_s"]


def test_entry_point_reports_and_refuses_a_missing_card(tmp_path):
    record = tmp_path / "flight.jsonl"
    report = serve.main(["--device", "cpu", "--kind", "dense",
                         "--requests", "24", "--slots", "4",
                         "--record", str(record)])
    assert report["ok"] == 24 and report["flight"]["parity"] == 1.0
    assert report["answers_equal_eval_many"] == 24
    assert record.read_text().splitlines()[0].startswith("{")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            serve.main(["--kind", "ring", "--requests", "4"])


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_prepare_updates_changes_nothing(kind):
    """``prepare_updates`` builds the write path ahead: no answer, epoch
    or later update differs from an unprepared engine's, or the JAX
    engine's."""
    from repro.core.fixtures import random_graph
    from repro_torch.core.engines import Query
    g = random_graph(20, 3, 60, seed=5, pred_zipf=False)
    pg = convert.graph_from_reference(g)
    prepared = make_engine(pg, kind, device="cpu")
    prepared.prepare_updates()
    plain, ref = make_engine(pg, kind, device="cpu"), rmake(g, kind)
    qs = [(e, None, o) for e in ("0/1*", "2+", "(0|2)/1") for o in range(6)]
    for adds in ([], [(0, 1, 5), (3, 0, 7)], [(5, 2, 0)]):
        if adds:
            assert prepared.add_edges(adds) == plain.add_edges(adds) == \
                ref.add_edges(adds)
        assert prepared.epoch == plain.epoch == ref.epoch
        assert prepared.eval_many([Query(*q) for q in qs]) == \
            plain.eval_many([Query(*q) for q in qs]) == \
            ref.eval_many([RQuery(*q) for q in qs])
