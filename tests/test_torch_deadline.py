"""The ring engine's deadline inside a superstep, on a hub.

Node 0 of the fixture has thousands of backward edges, so the first
superstep of a query anchored there enumerates thousands of subjects in
part 2.  A clock that advances with the wavelet-tree pops (``time.time``
monkeypatched for ``eval``, the scheduler's injected clock for slots)
pins how far past its deadline the engine stops: within
``rpq.PROBE_EVERY`` pops.  With no deadline firing, answers and every
``QueryStats`` counter equal the JAX ``RingRPQ``'s."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.oracle import eval_oracle  # noqa: E402
from repro.core.ring import LabeledGraph as RGraph, Ring as RRing  # noqa: E402
from repro.core.rpq import QueryStats as RStats, RingRPQ as RRPQ  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.core import rpq as prpq  # noqa: E402
from repro_torch.core.engines import Query  # noqa: E402
from repro_torch.core.ring import Ring as PRing  # noqa: E402
from repro_torch.core.rpq import QueryStats as PStats, RingRPQ as PRPQ  # noqa: E402
from repro_torch.core.scheduler import SlotScheduler  # noqa: E402
from repro_torch.core.wavelet import WaveletTree  # noqa: E402

HUB_EDGES = 3_000
TICK = 1.0 / 1024          # clock seconds a wavelet-tree pop
# wall-clock fields the scheduler fills; every other field is a counter
CLOCK_FIELDS = {"queue_wait_s", "service_s", "supersteps_s"}


def _hub_graph(n: int = HUB_EDGES, seed: int = 0) -> RGraph:
    """Node 0 is the hub: nodes 1..n each have a 0-labelled edge into
    it; a sparse random tail over labels 1 and 2 continues the paths."""
    rng = np.random.default_rng(seed)
    V = n + 1
    tail = 400
    s = np.concatenate([np.arange(1, n + 1), rng.integers(0, V, tail)])
    p = np.concatenate([np.zeros(n, dtype=np.int64),
                        rng.integers(1, 3, tail)])
    o = np.concatenate([np.zeros(n, dtype=np.int64),
                        rng.integers(0, 64, tail)])
    return RGraph(s=s.astype(np.int64), p=p.astype(np.int64),
                  o=o.astype(np.int64), num_nodes=V, num_preds=3)


@pytest.fixture(scope="module")
def hub():
    g = _hub_graph()
    return g, RRing(g), PRing(convert.graph_from_reference(g))


def _pop_clock(monkeypatch, start: float = 1000.0):
    """Count the probe calls of every ``range_distinct`` (one before each
    stack pop) into ``pops[0]``; returns (pops, clock), the clock reading
    ``start + pops * TICK``."""
    pops = [0]
    original = WaveletTree.range_distinct

    def counting(self, b, e, prune=None, probe=None):
        def counted():
            pops[0] += 1
            return probe() if probe is not None else False
        return original(self, b, e, prune=prune, probe=counted)

    monkeypatch.setattr(WaveletTree, "range_distinct", counting)
    return pops, lambda: start + pops[0] * TICK


def test_range_distinct_probe_checkpoints_and_resumes():
    """A probe that fires yields ``None`` checkpoints and changes nothing
    else; iterating on resumes exactly where it was; closing the
    generator at a checkpoint stops it."""
    rng = np.random.default_rng(3)
    wt = WaveletTree(rng.integers(0, 300, 5_000), 300)
    want = list(wt.range_distinct(100, 4_000))
    calls = [0]

    def every_fifth():
        calls[0] += 1
        return calls[0] % 5 == 0

    got = list(wt.range_distinct(100, 4_000, probe=every_fifth))
    assert [x for x in got if x is not None] == want
    assert got.count(None) == calls[0] // 5 > 0
    assert list(wt.range_distinct(100, 4_000, probe=lambda: False)) == want
    it = wt.range_distinct(100, 4_000, probe=lambda: True)
    assert next(it) is None
    it.close()
    assert list(it) == []


def test_eval_raises_within_probe_pops_of_deadline(hub, monkeypatch):
    """``eval`` under a deadline that falls inside the hub superstep's
    part 2 raises ``TimeoutError`` within ``PROBE_EVERY`` pops of it; the
    same query without a deadline runs many times further."""
    g, _rring, pring = hub
    engine = PRPQ(pring, device="cpu")
    pops, clock = _pop_clock(monkeypatch)
    monkeypatch.setattr(time, "time", clock)
    full = PStats()
    engine.eval("(1|2)*/0", None, 0, stats=full, deadline_s=3600.0)
    total = pops[0]
    assert full.supersteps >= 2 and full.subjects_enumerated >= HUB_EDGES
    due = total // 8                      # inside superstep 1's part 2
    engine.results.clear()
    pops[0] = 0
    stats = PStats()
    with pytest.raises(TimeoutError):
        engine.eval("(1|2)*/0", None, 0, stats=stats,
                    deadline_s=due * TICK)
    assert due < pops[0] <= due + prpq.PROBE_EVERY
    assert stats.supersteps == 1 and 0 < stats.subjects_enumerated \
        < full.subjects_enumerated
    assert total > 4 * (due + prpq.PROBE_EVERY)


def test_eval_many_batch_deadline_raises_inside_superstep(hub, monkeypatch):
    """``eval_many``'s one batch-wide deadline stops the shared wavefront
    within ``PROBE_EVERY`` pops too."""
    _g, _rring, pring = hub
    engine = PRPQ(pring, device="cpu")
    pops, clock = _pop_clock(monkeypatch)
    monkeypatch.setattr(time, "time", clock)
    qs = [Query("(1|2)*/0", obj=0), Query("0", obj=0), Query("1/2", obj=5)]
    engine.eval_many(qs, deadline_s=3600.0)
    total = pops[0]
    engine.results.clear()
    pops[0] = 0
    due = total // 8
    with pytest.raises(TimeoutError):
        engine.eval_many(qs, deadline_s=due * TICK)
    assert due < pops[0] <= due + prpq.PROBE_EVERY


def test_scheduler_preempts_slot_mid_superstep(hub, monkeypatch):
    """A slot whose deadline falls inside a shared hub superstep — in the
    middle of another slot's subject enumeration — fails with
    ``TimeoutError`` in that superstep (within ``PROBE_EVERY`` pops),
    which pauses and resumes the enumeration where it was: the other
    slots' answers equal ``eval_many`` of both packages and the
    oracle."""
    g, rring, pring = hub
    pops, clock = _pop_clock(monkeypatch, start=0.0)
    engine = PRPQ(pring, device="cpu")
    sched = SlotScheduler(engine, max_slots=4, clock=clock)
    timed = Query("0", obj=0)
    others = [Query("(1|2)*/0", obj=0), Query("(0|2)/1*", obj=0),
              Query("1/2", obj=5)]
    first = sched.submit(others[0])       # its hub task is enumerated first
    late = sched.submit(timed, deadline_s=600 * TICK)
    tickets = [first] + [sched.submit(q) for q in others[1:]]
    sched.step()                          # admits all four; superstep 1
    assert late.state == "failed" and sched.preempted_in_superstep == 1
    assert sched.slots.stepper.in_superstep      # paused mid-superstep
    assert 0 <= late.finished_at - late.deadline <= \
        prpq.PROBE_EVERY * TICK
    with pytest.raises(TimeoutError):
        late.result()
    record = sched.recorder.records()[-1]
    assert record["status"] == "timeout" and record["preempted"]
    sched.drain()
    assert sched.preempted == 1 and sched.completed == len(others)
    monkeypatch.undo()
    want = PRPQ(pring, device="cpu").eval_many(others)
    ref = RRPQ(rring).eval_many([RQuery(q.expr, q.subject, q.obj)
                                 for q in others])
    for q, t, w, r in zip(others, tickets, want, ref):
        assert t.result() == w == r == eval_oracle(g, q.expr, q.subject,
                                                   q.obj), q


def test_tick_that_preempts_at_its_top_ends_there(hub, monkeypatch):
    """A slot whose deadline passes outside a superstep (here in a slow
    harvest) is preempted at the top of the next tick, and that tick
    ends there: the pump hands the failure over before the other slots'
    next superstep (a hub's, thousands of pops) runs.  So the caller
    hears within ``serve.OVERRUN_BOUND_S`` of the deadline, and the slot
    admitted meanwhile answers exactly."""
    g, rring, pring = hub
    pops, pop_clock = _pop_clock(monkeypatch, start=0.0)
    slow = [0.0]

    def clock():
        return pop_clock() + slow[0]

    timed_q, hub_q = Query("(1|2)*/0", obj=0), Query("(0|2)/1*", obj=0)
    dry = SlotScheduler(PRPQ(pring, device="cpu"), max_slots=4, clock=clock)
    dry.submit(timed_q)
    dry.step()
    end_of_superstep = clock()            # the pop clock is deterministic
    pops[0] = 0

    sched = SlotScheduler(PRPQ(pring, device="cpu"), max_slots=4,
                          clock=clock)
    harvest = sched._harvest

    def slow_harvest():                   # a hub's answer set, say
        harvest()
        if not slow[0]:
            slow[0] = 0.1

    monkeypatch.setattr(sched, "_harvest", slow_harvest)
    timed = sched.submit(timed_q, deadline_s=end_of_superstep + 0.05)
    sched.step()                          # the deadline passes in harvest
    assert timed.state == "running" and clock() > timed.deadline
    other = sched.submit(hub_q)
    sched.step()
    heard = clock()                       # when the pump could flush
    assert timed.state == "failed"
    assert heard - timed.deadline <= serve.OVERRUN_BOUND_S
    assert timed.settled[0] == "running"
    assert timed.settled[1]["ended_after_expire"]
    assert other.state == "queued"        # admitted by the next tick
    t = clock()
    sched.step()                          # what tick 2 held it behind
    assert other.state == "running" and clock() - t > 0.5
    sched.drain()
    with pytest.raises(TimeoutError):
        timed.result()
    monkeypatch.undo()
    assert other.result() == PRPQ(pring, device="cpu").eval_many(
        [hub_q])[0] == eval_oracle(g, hub_q.expr, hub_q.subject, hub_q.obj)


@pytest.mark.parametrize("slice_", [2, prpq.TRANSITION_SLICE])
@pytest.mark.parametrize("due_calls", [3, 40, 400])
def test_slot_deadline_anywhere_keeps_others_exact(hub, monkeypatch,
                                                    slice_, due_calls):
    """Wherever a slot's deadline falls (a clock advanced by each read:
    part 1's entries, part 1.5's slices, part 2's pops), the superstep
    pauses and resumes, and the slots without a deadline answer as
    ``eval_many`` does."""
    g, rring, pring = hub
    monkeypatch.setattr(prpq, "TRANSITION_SLICE", slice_)
    ticks = [0]

    def clock():
        ticks[0] += 1
        return float(ticks[0])

    sched = SlotScheduler(PRPQ(pring, device="cpu", kernel_threshold=1),
                          max_slots=4, clock=clock)
    others = [Query("(1|2)*/0", obj=0), Query("(1|2)*/0", subject=7),
              Query("(0|2)/1*", obj=0)]
    tickets = [sched.submit(others[0])]
    timed = sched.submit(Query("(0|1|2)*/0", obj=0), deadline_s=due_calls)
    tickets += [sched.submit(q) for q in others[1:]]
    sched.drain()
    assert timed.state in ("done", "failed")
    want = PRPQ(pring, device="cpu").eval_many(others)
    for q, t, w in zip(others, tickets, want):
        assert t.result() == w == eval_oracle(g, q.expr, q.subject,
                                              q.obj), q


def _counters(stats) -> dict:
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in CLOCK_FIELDS}


@pytest.mark.parametrize("expr,s,o", [("(1|2)*/0", None, 0),
                                      ("0/(1|2)*", None, 0),
                                      ("(1|2)*/0", 7, None),
                                      ("0/1*", 12, 0), ("2/1", None, 9)])
def test_unfired_deadline_matches_reference(hub, expr, s, o):
    """A deadline that never fires changes nothing: ``eval`` and
    ``eval_many`` answers and every ``QueryStats`` counter equal the JAX
    ``RingRPQ``'s (and the oracle's)."""
    g, rring, pring = hub
    ref, port = RRPQ(rring), PRPQ(pring, device="cpu")
    rs, ps = RStats(), PStats()
    want = ref.eval(expr, s, o, stats=rs, deadline_s=3600.0)
    got = port.eval(expr, s, o, stats=ps, deadline_s=3600.0)
    assert got == want == eval_oracle(g, expr, s, o)
    assert _counters(ps) == _counters(rs)
    qs = [(expr, s, o), ("0", None, 0), ("1/2", None, 5)]
    rstats, pstats = [], []
    want = RRPQ(rring).eval_many([RQuery(*q) for q in qs],
                                 deadline_s=3600.0, stats_out=rstats)
    got = PRPQ(pring, device="cpu").eval_many(
        [Query(*q) for q in qs], deadline_s=3600.0, stats_out=pstats)
    assert got == want
    for r, p in zip(rstats, pstats):
        assert _counters(p) == _counters(r)


def test_unfired_slot_deadlines_match_eval_many(hub):
    """Slots under deadlines that never fire answer as ``eval_many`` does,
    with the same traversal counters as the JAX engine's ``eval``."""
    g, rring, pring = hub
    qs = [Query("(1|2)*/0", obj=0), Query("(1|2)*/0", subject=7),
          Query("(0|2)/1*", obj=0), Query("2/1", obj=9)]
    sched = SlotScheduler(PRPQ(pring, device="cpu"), max_slots=2)
    tickets = [sched.submit(q, deadline_s=3600.0) for q in qs]
    sched.drain()
    want = PRPQ(pring, device="cpu").eval_many(qs)
    ref = RRPQ(rring)
    for q, t, w in zip(qs, tickets, want):
        rs = RStats()
        assert t.result() == w == ref.eval(q.expr, q.subject, q.obj,
                                           stats=rs)
        for f in ("node_state_activations", "subjects_enumerated",
                  "predicates_enumerated", "wt_nodes_visited", "supersteps"):
            assert getattr(t.stats, f) == getattr(rs, f), (q, f)
    assert sched.preempted == 0 and sched.preempted_in_superstep == 0
