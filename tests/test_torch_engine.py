"""The port's ring engine against the JAX package's, on the CPU.

Both engines run with ``kernel_threshold=1``, so every superstep goes
through ``nfa_step`` (the port's plain PyTorch version; the reference's
Pallas kernel in interpret mode).  Answers and the work counters
``node_state_activations``, ``kernel_batches``, ``kernel_tasks`` and the
engine's ``bundle_kernel_batches`` must be equal, and the answers must
equal the brute-force oracle."""
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
from torch_parity import (BINDINGS, check_eval,  # noqa: E402
                          check_eval_many, engines)


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
    g = pfix.random_graph(10, 2, 20, seed=1)
    with pytest.raises(NotImplementedError, match="queue 1"):
        make_engine(g, kind="dense", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1"):
        make_engine(g, device="cpu", shards=2)
    with pytest.raises(NotImplementedError, match="queue 1"):
        PSched(type("DenseLike", (), {"dg": None})())
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
