"""The port's ring engine against the JAX package's, on the CPU.

Both engines run with ``kernel_threshold=1``, so every superstep goes
through ``nfa_step`` (the port's plain PyTorch version; the reference's
Pallas kernel in interpret mode).  Answers and the work counters
``node_state_activations``, ``kernel_batches``, ``kernel_tasks`` and the
engine's ``bundle_kernel_batches`` must be equal, and the answers must
equal the brute-force oracle.  Last, the cases of the reference's
``tests/test_engines.py`` that no other port test covers, each body run
on both packages (``torch_parity.both``)."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from helpers import rand_expr_ast  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.ring import Ring as RRing  # noqa: E402
from repro.core.stats import GraphStats as RGraphStats  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fixtures as pfix  # noqa: E402
from repro_torch.core.engines import Query, make_engine  # noqa: E402
from repro_torch.core.oracle import eval_oracle as port_oracle  # noqa: E402
from repro_torch.core.ring import Ring as PRing  # noqa: E402
from repro_torch.core.scheduler import SlotScheduler as PSched  # noqa: E402
from repro_torch.core.stats import GraphStats as PGraphStats  # noqa: E402
from repro_torch.obs.explain import validate_report  # noqa: E402
from torch_parity import (BINDINGS, both, cache_counters,  # noqa: E402
                          check_eval, check_eval_many, engines, stats_fields)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000))
def test_eval_parity_random_graphs(seed):
    rnd = random.Random(seed)
    V = rnd.randrange(4, 30)
    P = rnd.randrange(1, 4)
    g = rfix.random_graph(V, P, rnd.randrange(5, 90), seed=seed % 991,
                          pred_zipf=False)
    ref, port = engines(g)
    for _ in range(2):
        expr = str(rand_expr_ast(rnd, 2, P))
        for s, o in BINDINGS:
            got = check_eval(ref, port, g, expr, s, o)
            pg = convert.graph_from_reference(g)
            assert got == port_oracle(pg, expr, s, o)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_many_heterogeneous_bundles(seed):
    """Fixed-endpoint queries with different automata share one
    block-diagonal bundle per superstep."""
    rnd = random.Random(seed)
    g = rfix.random_graph(80, 4, 300, seed=seed)
    queries = []
    for i in range(10):
        expr = str(rand_expr_ast(rnd, 2, 4))
        shape = i % 4
        v, w = rnd.randrange(80), rnd.randrange(80)
        queries.append((expr, None, v) if shape == 0 else
                       (expr, v, None) if shape == 1 else
                       (expr, v, w) if shape == 2 else (expr, None, None))
    queries += queries[:2]                    # duplicates collapse
    ref, port = engines(g)
    check_eval_many(ref, port, g, queries)
    assert port.bundle_kernel_batches > 0


def test_metro_worked_example():
    """The paper's Fig. 1 example: l5+/bus from Baquedano reaches
    Santa Ana and Universidad de Chile."""
    g = rfix.metro_graph()
    pg = pfix.metro_graph()
    for f in ("s", "p", "o"):
        np.testing.assert_array_equal(getattr(pg, f),
                                      getattr(convert.graph_from_reference(g), f))
    assert pg.node_names == g.node_names and pg.pred_names == g.pred_names
    n2i = {n: i for i, n in enumerate(g.node_names)}
    ref, port = engines(g)
    res = check_eval(ref, port, g, "l5+/bus", n2i["Baq"], None)
    assert {g.node_names[o] for _, o in res} == {"SA", "UCh"}
    assert check_eval(ref, port, g, "l5+/bus", n2i["Baq"], n2i["SA"])
    assert not check_eval(ref, port, g, "l5+/bus", n2i["Baq"], n2i["LH"])
    for expr in ["l1|l2", "^bus/l5*", "(l1|l2|l5)+", "l5|l1|l2|bus"]:
        for s, o in [(None, None), (None, n2i["SA"]), (n2i["UCh"], None)]:
            check_eval(ref, port, g, expr, s, o)


def test_stats_from_reference_roundtrip():
    g = rfix.random_graph(50, 4, 200, seed=9)
    ref_stats = RGraphStats.from_ring(RRing(g))
    port_stats = PGraphStats.from_ring(PRing(convert.graph_from_reference(g)))
    carried = convert.stats_from_reference(ref_stats.to_state())
    assert isinstance(carried, PGraphStats)
    for st_ in (carried, port_stats):
        assert st_.num_nodes == ref_stats.num_nodes
        assert st_.num_edges == ref_stats.num_edges
        assert st_.num_preds_completed == ref_stats.num_preds_completed
        for f in ("freq", "distinct_subj", "distinct_obj"):
            np.testing.assert_array_equal(getattr(st_, f),
                                          getattr(ref_stats, f))
    back = RGraphStats.from_state(carried.to_state())
    np.testing.assert_array_equal(back.freq, ref_stats.freq)
    # injected statistics steer the planner exactly as harvested ones do
    ref, port = engines(g)
    port._stats = carried
    for expr in ["0/1*", "1/2/3"]:
        check_eval(ref, port, g, expr, None, 4)


def test_graph_from_reference_copies():
    g = rfix.metro_graph()
    pg = convert.graph_from_reference(g)
    assert (pg.num_nodes, pg.num_preds) == (g.num_nodes, g.num_preds)
    assert pg.pred_names == g.pred_names and pg.pred_names is not g.pred_names
    pg.s[0] = -1
    assert g.s[0] != -1
    raw = rfix.random_graph(10, 2, 20, seed=1)
    assert convert.graph_from_reference(raw).node_names is None


def test_explain_analyze_matches_reference():
    g = rfix.random_graph(40, 3, 150, seed=2)
    ref, port = engines(g)
    q = ("0/1*", None, 3)
    want = ref.explain(RQuery(*q), analyze=True)
    got = port.explain(Query(*q), analyze=True)
    validate_report(got)
    assert got["plan"] == want["plan"]
    assert got["automaton"] == want["automaton"]
    assert len(got["execution"]["timeline"]) == \
        len(want["execution"]["timeline"])


def test_unported_paths_raise():
    """``shards=N`` past the visible devices raises on both engines (the
    host is one device; a mesh naming it N times is
    ``tests/test_torch_distributed.py``); the dense engine and a
    scheduler over it work (their parity is
    ``tests/test_torch_dense*.py``), and without a card the default
    device raises."""
    from repro_torch.core.dense import DenseRPQ
    g = pfix.random_graph(10, 2, 20, seed=1)
    dense = make_engine(g, kind="dense", device="cpu")
    assert isinstance(dense, DenseRPQ)
    assert dense.eval("0/1*", None, 3) == port_oracle(g, "0/1*", None, 3)
    with pytest.raises(ValueError, match="devices are visible"):
        make_engine(g, device="cpu", shards=2)
    with pytest.raises(ValueError, match="devices are visible"):
        make_engine(g, kind="dense", device="cpu", shards=2)
    sched = PSched(dense)
    assert type(sched.slots).__name__ == "_DenseSlots"
    t = sched.submit(Query("0/1*", obj=3))
    sched.drain()
    assert t.result() == port_oracle(g, "0/1*", None, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_engine(g, kind="dense")
    with pytest.raises(ValueError):
        make_engine(g, kind="other", device="cpu")


def test_tracer_profiler_bridge_records_spans():
    """``Tracer.enable(profiler_annotations=True)`` wraps every span in a
    ``torch.profiler.record_function`` range; spans still record."""
    from repro_torch.obs import trace as otrace
    g = pfix.random_graph(20, 2, 60, seed=5)
    eng = make_engine(g, device="cpu", kernel_threshold=1)
    tracer = otrace.Tracer().enable(profiler_annotations=True)
    with torch.profiler.profile() as prof, otrace.use(tracer):
        eng.eval("0/1*", None, 3)
    names = {e["name"] for e in tracer.events}
    assert {"ring.superstep", "ring.nfa_step"} <= names
    assert "ring.nfa_step" in {e.key for e in prof.key_averages()}


# -- the reference's tests/test_engines.py cases not covered above ------------


def test_eval_many_metro_hot_expr_batch():
    """Serving shape: one hot expression, many endpoints, both engines."""
    def body(P):
        g = P.fixtures.metro_graph()
        queries = [P.Query("l5+/bus", obj=o) for o in range(g.num_nodes)]
        ring_res = P.make_engine(g, "ring").eval_many(queries)
        dense_res = P.make_engine(g, "dense").eval_many(queries)
        assert ring_res == dense_res
        assert any(r for r in ring_res)
        return ring_res
    both(body)


def test_wavefront_matches_sequential_traversal():
    """Wavefront, sequential and forced-kernel traversals: the same answers
    and Theorem-4.1 work, and the same as the reference's."""
    def body(P):
        rnd = random.Random(13)
        out = []
        for trial in range(8):
            V, P_, E = (rnd.randrange(4, 12), rnd.randrange(1, 4),
                        rnd.randrange(5, 30))
            g = P.fixtures.random_graph(V, P_, E, seed=trial + 900,
                                        pred_zipf=False)
            ring = P.Ring(g)
            engines_ = {
                "wavefront": P.RingRPQ(ring),
                "sequential": P.RingRPQ(ring, wavefront=False),
                "kernel": P.RingRPQ(ring, kernel_threshold=1),
            }
            expr = str(rand_expr_ast(rnd, 2, P_))
            for (sub, ob) in [(None, 0), (0, None), (None, None)]:
                runs = {}
                for name, eng in engines_.items():
                    stats = P.QueryStats()
                    res = eng.eval(expr, subject=sub, obj=ob, stats=stats)
                    runs[name] = (res, stats.node_state_activations)
                    out.append((name, res, stats_fields(stats)))
                assert runs["wavefront"] == runs["sequential"], expr
                assert runs["kernel"] == runs["sequential"], expr
        return out
    both(body)


def test_wavefront_kernel_path_fires():
    """``kernel_threshold=1`` dispatches through ``nfa_step``: batches and
    tasks above 0 and equal to the reference's.  On the CPU the port runs
    the plain version, which counts no launch (the card's twin is in
    ``tests/test_torch_cuda.py``)."""
    from repro_torch import kernels

    def body(P):
        eng = P.RingRPQ(P.Ring(P.fixtures.metro_graph()), kernel_threshold=1)
        stats = P.QueryStats()
        res = eng.eval("l5+/bus", stats=stats)
        assert stats.kernel_batches > 0
        assert stats.kernel_tasks > 0
        return res, stats_fields(stats)
    kernels.reset_launch_counts()
    both(body)
    assert set(kernels.launch_counts().values()) == {0}


def test_plan_cache_eviction_accounting():
    def body(P):
        cache = P.PlanCache(max_entries=2)
        cache.get("A", lambda: "a")
        cache.get("B", lambda: "b")
        assert cache.get("A", lambda: "a'") == "a"
        cache.get("C", lambda: "c")
        assert cache.get("A", lambda: "NEW-A") == "a"
        assert cache.get("B", lambda: "new-b") == "new-b"
        assert (cache.hits, cache.misses, cache.evictions) == (2, 4, 2)
        assert len(cache) == 2
        out = [cache_counters(cache)]

        cache = P.PlanCache(max_entries=2)
        cache.get("old", lambda: 0)
        cache.get("hot", lambda: 1)

        def build_x():
            assert cache.get("hot", lambda: -1) == 1
            cache.get("extra", lambda: 2)
            return 3

        assert cache.get("X", build_x) == 3
        assert len(cache) == 2
        assert cache.get("X", lambda: -1) == 3
        out.append((cache_counters(cache), list(cache._entries)))

        cache = P.PlanCache(max_entries=2)
        h = m = 0
        for i in range(20):
            cache.get("hot", lambda: "v")
            m += 1 if i == 0 else 0
            h += 0 if i == 0 else 1
            cache.get(f"cold{i}", lambda: i)
            m += 1
            assert cache.get("hot", lambda: "REBUILT") == "v"
            h += 1
            assert len(cache) <= 2
        assert (cache.hits, cache.misses) == (h, m)
        out.append((cache_counters(cache), list(cache._entries)))
        return out
    both(body)


def test_plan_cache_shares_automata():
    def body(P):
        g = P.fixtures.metro_graph()
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            eng.eval("l5+/bus", obj=0)
            assert eng.plans.misses >= 1
            h0 = eng.plans.hits
            eng.eval_many([P.Query("l5+/bus", obj=o) for o in range(3)])
            assert eng.plans.hits > h0, kind
            assert eng.plans.misses <= 2, kind
            m0 = eng.plans.misses
            eng.eval("(l5)+/(bus)", obj=0)
            assert eng.plans.misses == m0, kind
            out.append((cache_counters(eng.plans),
                        cache_counters(eng.results)))
        return out
    both(body)


def test_limit_truncation_deterministic():
    """``limit=k`` answers are the k smallest pairs, across ring/dense,
    eval/eval_many, repeated runs and result-cache replays; the port's
    engines hold the same caches' counters as the reference's."""
    def body(P):
        g = P.fixtures.random_graph(14, 3, 50, seed=11, pred_zipf=False)
        exprs = ["0/1*", "(0|1)/2", "2+", "^1/0*"]
        cases = [(None, None), (None, 2), (4, None), (4, 2)]
        out = []
        for expr in exprs:
            for s, o in cases:
                full = P.eval_oracle(g, expr, subject=s, obj=o)
                for k in (0, 1, 2, 5):
                    want = set(sorted(full)[:k]) if len(full) > k \
                        else set(full)
                    for kind in ("ring", "dense"):
                        eng = P.make_engine(g, kind)
                        first = eng.eval(expr, s, o, limit=k)
                        assert first == want, (kind, expr, s, o, k)
                        assert eng.eval(expr, s, o, limit=k) == want
                        batched = eng.eval_many(
                            [P.Query(expr, s, o, limit=k)])[0]
                        assert batched == want, (kind, expr, s, o, k)
                        out.append((first, cache_counters(eng.results)))
        return out
    both(body)


def test_result_cache_superset_probe():
    def body(P):
        cache = P.ResultCache()
        cache.put(("E", 1, None, None), {(1, 5), (1, 2), (1, 9)})
        got = cache.get_covering(("E", 1, None, 2))
        assert got == frozenset({(1, 2), (1, 5)})
        assert (cache.hits, cache.misses) == (1, 0)
        cache2 = P.ResultCache()
        cache2.put(("F", None, 0, 3), {(1, 0), (2, 0), (3, 0)})
        got2 = cache2.get_covering(("F", None, 0, 2))
        assert got2 == frozenset({(1, 0), (2, 0)})
        assert (cache2.hits, cache2.misses) == (1, 0)
        assert cache2.get_covering(("F", None, 0, 5)) is None
        assert cache2.misses == 1
        out = [got, got2, cache_counters(cache), cache_counters(cache2)]

        g = P.fixtures.metro_graph()
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            full = eng.eval_many([P.Query("l5+/bus", obj=0)])[0]
            h0 = eng.results.hits
            lim = eng.eval_many([P.Query("l5+/bus", obj=0, limit=1)])[0]
            assert eng.results.hits == h0 + 1, kind
            want = set(sorted(full)[:1]) if len(full) > 1 else full
            assert lim == want, kind
            out.append((full, lim, cache_counters(eng.results)))
        return out
    both(body)
