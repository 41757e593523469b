"""The port's dense engine against the JAX package's, on the CPU.

The port's ``DenseRPQ(device="cpu")`` runs the edge pass's plain
version; the reference runs its XLA planes.  Answers must equal the
reference's and the brute-force oracle's, and the ``QueryStats`` fields
``results``, ``supersteps``, ``retraces`` and ``plan_*`` and the
engines' ``hetero_dispatches`` must be equal (``torch_parity``).
Graphs stay small (V <= 40): every new shape compiles on the JAX side.
"""
import random

import pytest

torch = pytest.importorskip("torch")

from helpers import rand_expr_ast  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from repro.core.dense import DenseRPQ as RDense  # noqa: E402
from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.oracle import eval_oracle  # noqa: E402
from repro.core.patterns import generate_workload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engines import Query, make_engine  # noqa: E402
from torch_parity import (BINDINGS, check_dense_eval,  # noqa: E402
                          check_dense_eval_many, dense_engines)

# automaton sizes m+1 from 2 to 9: across the pow2 padding buckets 4, 8
# and 16 (test_hetero_batch.py's pool)
MIXED_EXPRS = ["0", "^1", "0/1", "(0|2)", "2*/0", "^1/0*", "0/1/2*",
               "(0|1)/(2|0)+", "0/1/2/0*", "(0/1/2)|(2/1/0)"]


def _mixed_batch(rnd, V, n):
    """All four query shapes over mixed-size expressions + a duplicate."""
    out = []
    for i in range(n):
        e = MIXED_EXPRS[rnd.randrange(len(MIXED_EXPRS))]
        k = i % 4
        out.append((e, None, rnd.randrange(V)) if k == 0 else
                   (e, rnd.randrange(V), None) if k == 1 else
                   (e, rnd.randrange(V), rnd.randrange(V)) if k == 2 else
                   (e, None, None))
    out.append(out[0])
    return out


def test_dense_metro():
    """The paper's Fig. 1 example on both dense engines."""
    g = rfix.metro_graph()
    n2i = {n: i for i, n in enumerate(g.node_names)}
    ref, port = dense_engines(g)
    res = check_dense_eval(ref, port, g, "l5+/bus", n2i["Baq"], None)
    assert {g.node_names[o] for _, o in res} == {"SA", "UCh"}
    for expr in ["l1|l2", "^bus/l5*", "(l1|l2|l5)+"]:
        for s, o in [(None, None), (None, n2i["SA"]), (n2i["UCh"], None)]:
            check_dense_eval(ref, port, g, expr, s, o, deadline_s=60.0)


@pytest.mark.parametrize("block", range(3))
def test_dense_fuzz_vs_oracle(block):
    """``test_engines.py::test_dense_fuzz_vs_oracle``'s graphs and
    expressions (same seeds), five trials a block, each binding with and
    without a deadline (the chunked path counts supersteps)."""
    rnd = random.Random(21)
    for trial in range(15):
        V, P, E = rnd.randrange(3, 10), rnd.randrange(1, 4), \
            rnd.randrange(3, 20)
        expr = str(rand_expr_ast(rnd, 2, P))
        if trial // 5 != block:
            continue
        g = rfix.random_graph(V, P, E, seed=trial + 50, pred_zipf=False)
        ref, port = dense_engines(g)
        for s, o in BINDINGS:
            check_dense_eval(ref, port, g, expr, s, o)
            check_dense_eval(ref, port, g, expr, s, o, deadline_s=60.0)


def test_ring_and_dense_agree_on_workload():
    """Ring (faithful) and dense engines of the port on a Table-1-style
    workload (``test_engines.py:43``), the dense one held to the
    reference's dense engine too."""
    g = rfix.random_graph(40, 6, 200, seed=7)
    ring = make_engine(convert.graph_from_reference(g), device="cpu")
    ref, port = dense_engines(g)
    wl = generate_workload(30, num_preds=6, num_nodes=40, seed=3)
    for expr, s, o, _pat in wl.queries:
        got = check_dense_eval(ref, port, g, expr, s, o)
        assert ring.eval(expr, s, o) == got, (expr, s, o)


def test_eval_many_ring_dense_oracle_agree():
    """``test_engines.py:92``: eval_many == per-query eval == oracle on
    both port engines across all four query shapes, with a duplicate."""
    rnd = random.Random(77)
    g = rfix.random_graph(12, 3, 40, seed=6, pred_zipf=False)
    queries = []
    for i in range(24):
        e = str(rand_expr_ast(rnd, 2, 3))
        k = i % 4
        queries.append((e, None, None) if k == 0 else
                       (e, None, rnd.randrange(12)) if k == 1 else
                       (e, rnd.randrange(12), None) if k == 2 else
                       (e, rnd.randrange(12), rnd.randrange(12)))
    queries.append(queries[1])
    pg = convert.graph_from_reference(g)
    ring = make_engine(pg, device="cpu")
    ref, port = dense_engines(g)
    got = check_dense_eval_many(ref, port, g, queries)
    assert ring.eval_many([Query(*q) for q in queries]) == got
    for q, res in zip(queries, got):
        assert port.eval(*q) == res, q


def test_dense_deadline():
    """``test_engines.py::test_dense_deadline``: a deadline already past
    raises before the first superstep; a generous one changes nothing,
    and the engine recovers after a timeout.  Supersteps under it equal
    the reference's."""
    g = rfix.random_graph(20, 3, 80, seed=3)
    ref, port = dense_engines(g)
    for eng in (ref, port):
        with pytest.raises(TimeoutError):
            eng.eval("0/1*", obj=0, deadline_s=1e-9)
    with pytest.raises(TimeoutError):
        make_engine(convert.graph_from_reference(g), kind="dense",
                    device="cpu").eval_many([Query("0/1*", obj=0)],
                                            deadline_s=1e-9)
    want = check_dense_eval(ref, port, g, "0/1*", None, 0)
    assert check_dense_eval(ref, port, g, "0/1*", None, 0,
                            deadline_s=60.0) == want
    assert port.eval_many([Query("0/1*", obj=0)], deadline_s=60.0)[0] == want


def test_hetero_ring_dense_cross_engine_parity():
    """``test_hetero_batch.py:64``: one heterogeneous batch on the port's
    ring and dense engines and the reference's dense engine, with and
    without a batch deadline."""
    rnd = random.Random(424)
    g = rfix.random_graph(25, 3, 110, seed=24, pred_zipf=False)
    queries = _mixed_batch(rnd, 25, 32)
    ring = make_engine(convert.graph_from_reference(g), device="cpu")
    ref, port = dense_engines(g)
    got = check_dense_eval_many(ref, port, g, queries)
    assert ring.eval_many([Query(*q) for q in queries]) == got
    assert any(got)
    ref, port = dense_engines(g)
    assert check_dense_eval_many(ref, port, g, queries,
                                 deadline_s=60.0) == got
    assert port.hetero_dispatches > 0 and port._superstep_acc > 0


def test_hetero_dense_crosses_padding_buckets():
    """``test_hetero_batch.py:75``: automata of m+1 = 2 (bucket 4) and
    m+1 = 9 (bucket 16) in one batch dispatch the heterogeneous BFS, and
    a tail chunk pads to the batch size (source_batch 3)."""
    g = rfix.random_graph(20, 3, 80, seed=31, pred_zipf=False)
    queries = [("0", None, o) for o in range(4)] + \
        [("0/1/2/0/1/2/0/1", None, o) for o in range(4)] + \
        [("(0|1)*", s, None) for s in range(3)]
    ref, port = dense_engines(g, source_batch=3)
    check_dense_eval_many(ref, port, g, queries)
    assert port.hetero_dispatches > 0
    for q in queries:
        check_dense_eval(ref, port, g, *q)


@pytest.mark.parametrize("policy", ["cost", "naive", "forward", "reverse",
                                    "split"])
def test_planner_policies_match_reference(policy):
    """Every planner policy, every binding, on a graph whose predicates
    are skewed (so ``cost`` picks reverse and split plans too)."""
    g = rfix.random_graph(30, 4, 120, seed=11)
    ref, port = dense_engines(g, planner=policy)
    for expr in ["0/1*", "1/2/3", "(0|1)/2+", "^3/0*/1", "2/0/1/3"]:
        for s, o in [(None, None), (None, 4), (2, None), (2, 4)]:
            check_dense_eval(ref, port, g, expr, s, o)
        check_dense_eval(ref, port, g, expr, None, 4, deadline_s=60.0)
    rq = [(e, None, 5) for e in ["0/1*", "(0|1)/2+"]] + \
        [(e, 3, None) for e in ["1/2/3", "^3/0*/1"]] + [("2/0/1/3", 1, 6)]
    ref.results.clear()
    port.results.clear()
    check_dense_eval_many(ref, port, g, rq)


def test_planner_shapes_are_exercised():
    """The cost planner on this graph runs forward, reverse and split
    plans (so the policy test above covers each physical shape)."""
    from repro_torch.core.engines import QueryStats
    g = rfix.random_graph(30, 4, 120, seed=11)
    _ref, port = dense_engines(g)
    modes = set()
    for expr in ["0/1*", "1/2/3", "(0|1)/2+", "^3/0*/1", "2/0/1/3"]:
        for s, o in [(None, None), (None, 4), (2, None), (2, 4)]:
            st = QueryStats()
            port.eval(expr, s, o, stats=st)
            modes.add(st.plan_mode)
    assert {"forward", "split"} <= modes, modes


def test_limit_and_result_cache_match_reference():
    """``limit`` truncates to the sorted prefix and a replayed query
    comes from the result cache, as on the reference."""
    g = rfix.random_graph(12, 3, 45, seed=19, pred_zipf=False)
    ref, port = dense_engines(g)
    full = sorted(eval_oracle(g, "0/1*", None, 3))
    assert len(full) >= 2
    for lim in (1, 2):
        want = ref.eval_many([RQuery("0/1*", obj=3, limit=lim)])
        got = port.eval_many([Query("0/1*", obj=3, limit=lim)])
        assert got == want == [set(full[:lim])]
    h0 = port.results.hits
    assert port.eval_many([Query("0/1*", obj=3, limit=1)]) == \
        [set(full[:1])]
    assert port.results.hits == h0 + 1


def test_dense_graph_keeps_host_edges():
    """The engine's host copy of the sorted edges is the device's."""
    g = rfix.random_graph(30, 3, 100, seed=2)
    _ref, port = dense_engines(g)
    e = port.dg.edges
    for t, a in zip((e.subj, e.pred, e.obj), port.dg.host):
        assert torch.equal(t, torch.from_numpy(a))
    assert RDense(g).dg.num_labels == port.dg.num_labels
