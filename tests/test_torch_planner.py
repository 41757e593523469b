"""Every planner policy of the port's ring engine against the JAX
package's, with the kernel path forced (see ``torch_parity``); then the
reference's ``tests/test_planner.py``, each body run on both packages
(``torch_parity.both``): its own asserts on each, and the answers, plan
decisions, statistics and cache counters equal."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import rand_expr_ast  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from torch_parity import (BINDINGS, both, cache_counters,  # noqa: E402
                          check_eval, check_eval_many, engines, stats_fields)


@pytest.mark.parametrize("policy", ["cost", "naive", "forward", "reverse",
                                    "split"])
def test_planner_policy_parity(policy):
    rnd = random.Random(7)
    g = rfix.random_graph(30, 3, 110, seed=4)
    ref, port = engines(g, planner=policy)
    exprs = ["0/1*", "(0|1)/2", "1/^2/0", "(0)/(2)/(1*)",
             str(rand_expr_ast(rnd, 2, 3))]
    for expr in exprs:
        for s, o in BINDINGS:
            check_eval(ref, port, g, expr, s, o)
    check_eval_many(ref, port, g, [(e, None, 3) for e in exprs]
                     + [(e, 5, None) for e in exprs])


# -- the reference's tests/test_planner.py ------------------------------------


def _chain_expr(rnd, npred):
    parts = [str(rand_expr_ast(rnd, 1, npred))
             for _ in range(rnd.randrange(0, 2))]
    parts.append(str(rnd.randrange(npred)))
    parts += [str(rand_expr_ast(rnd, 1, npred))
              for _ in range(rnd.randrange(0, 2))]
    return "/".join(f"({p})" for p in parts)


def test_eval_many_planner_batch_matches_eval():
    def body(P):
        rnd = random.Random(31)
        g = P.fixtures.random_graph(12, 3, 45, seed=8, pred_zipf=False)
        queries = []
        for i in range(12):
            expr = _chain_expr(rnd, 3) if i % 2 \
                else str(rand_expr_ast(rnd, 2, 3))
            kind = i % 4
            if kind == 0:
                queries.append(P.Query(expr, obj=rnd.randrange(12)))
            elif kind == 1:
                queries.append(P.Query(expr, subject=rnd.randrange(12)))
            elif kind == 2:
                queries.append(P.Query(expr, subject=rnd.randrange(12),
                                       obj=rnd.randrange(12)))
            else:
                queries.append(P.Query(expr))
        out = []
        for kind in ("ring", "dense"):
            for mode in ("cost", "reverse", "split"):
                eng = P.make_engine(g, kind, planner=mode)
                rows = []
                got = eng.eval_many(queries, **(
                    {"stats_out": rows} if kind == "ring" else {}))
                for q, r in zip(queries, got):
                    assert r == P.eval_oracle(g, q.expr, subject=q.subject,
                                              obj=q.obj), (kind, mode, q)
                out.append((got, [stats_fields(r) for r in rows],
                            cache_counters(eng.plans),
                            cache_counters(eng.decisions)))
        return out
    both(body)


def test_graph_stats_ring_and_graph_agree():
    def body(P):
        g = P.fixtures.random_graph(30, 4, 120, seed=3)
        stats_r = P.GraphStats.from_ring(P.Ring(g))
        stats_g = P.GraphStats.from_graph(P.graph(g))
        assert stats_r.num_edges == stats_g.num_edges
        for f in ("freq", "distinct_subj", "distinct_obj"):
            assert np.array_equal(getattr(stats_r, f), getattr(stats_g, f))
        Pn = g.num_preds
        assert np.array_equal(stats_r.distinct_obj[:Pn],
                              stats_r.distinct_subj[Pn:])
        return [np.asarray(getattr(stats_r, f)).tolist()
                for f in ("freq", "distinct_subj", "distinct_obj")]
    both(body)


def test_first_last_labels_match_ast_analyses():
    def body(P):
        rnd = random.Random(17)
        resolve = lambda lit: (lit.name, lit.inverse)  # noqa: E731
        out = []
        for _ in range(25):
            ast = P.rx.parse(str(rand_expr_ast(rnd, 3, 3)))
            g = P.Glushkov.from_ast(ast, resolve)
            first, last = set(g.first_labels()), set(g.last_labels())
            assert first == {resolve(lit) for lit in P.qp.first_lits(ast)}
            assert last == {resolve(lit) for lit in P.qp.last_lits(ast)}
            out.append((sorted(first), sorted(last)))
        return out
    both(body)


def test_split_candidates_structure():
    def body(P):
        cands = P.qp.split_candidates(P.rx.parse("0*/1/(2|0)/3"))
        assert [c.lit.name for c in cands] == ["1", "3"]
        assert str(cands[0].left) == "(0)*"
        assert str(cands[0].right) == "((2|0)/3)"
        assert cands[1].right is None
        assert P.qp.split_candidates(P.rx.parse("(0/1)|(1/0)")) == []
        g = P.fixtures.random_graph(8, 2, 20, seed=1, pred_zipf=False)
        eng = P.RingRPQ(P.Ring(g), planner="split")
        stats = P.QueryStats()
        res = eng.eval("(0/1)|(1/0)", obj=0, stats=stats)
        assert stats.plan_mode == "forward"
        assert res == P.eval_oracle(g, "(0/1)|(1/0)", obj=0)
        return ([(c.lit.name, str(c.left), str(c.right)) for c in cands],
                res, stats_fields(stats))
    both(body)


def test_planner_splits_at_rare_predicate():
    def body(P):
        rng = np.random.default_rng(11)
        V, E = 60, 500
        s = rng.integers(0, V, E)
        o = rng.integers(0, V, E)
        p = np.zeros(E, dtype=np.int64)
        p[:3] = 1
        g = P.LabeledGraph.from_arrays(s, p, o, V, 2)
        ring = P.Ring(g)
        naive_stats, cost_stats = P.QueryStats(), P.QueryStats()
        want = P.RingRPQ(ring, planner="naive").eval("0/1/0",
                                                     stats=naive_stats)
        got = P.RingRPQ(ring, planner="cost").eval("0/1/0", stats=cost_stats)
        assert got == want
        assert cost_stats.plan_mode == "split"
        assert cost_stats.plan_split_pred == 1
        assert cost_stats.plan_est_frontier == \
            P.GraphStats.from_ring(ring).freq[1]
        assert cost_stats.plan_actual_frontier <= cost_stats.plan_est_frontier
        assert cost_stats.node_state_activations < \
            naive_stats.node_state_activations
        dstats = P.QueryStats()
        assert P.DenseRPQ(g).eval("0/1/0", stats=dstats) == want
        assert (dstats.plan_mode, dstats.plan_split_pred) == ("split", 1)
        return (got, stats_fields(naive_stats), stats_fields(cost_stats),
                stats_fields(dstats))
    both(body)


def test_unknown_predicate_raises_regardless_of_policy_and_binding():
    def body(P):
        g = P.fixtures.metro_graph()
        out = []
        for policy in ("naive", "cost", "forward", "reverse", "split"):
            eng = P.RingRPQ(P.Ring(g), planner=policy)
            for (sub, ob) in [(None, None), (None, 0), (0, None), (0, 1)]:
                with pytest.raises(KeyError) as err:
                    eng.eval("l5/bogus/l5", subject=sub, obj=ob)
                assert eng.eval("l5/99/l5", subject=sub, obj=ob) == set()
                out.append(str(err.value))
        return out
    both(body)


def test_plan_decision_surfaced_in_stats():
    def body(P):
        g = P.fixtures.metro_graph()
        eng = P.RingRPQ(P.Ring(g))
        stats = P.QueryStats()
        eng.eval("l5+/bus", obj=0, stats=stats)
        assert stats.plan_mode in ("forward", "reverse", "split")
        assert stats.plan_est_cost > 0
        assert stats.plan_est_frontier >= 1
        assert stats.plan_actual_frontier >= 0
        rows = []
        eng.eval_many([P.Query("l5+/bus", obj=1)], stats_out=rows)
        assert rows[0].plan_mode in ("forward", "reverse", "split")
        naive = P.QueryStats()
        P.RingRPQ(P.Ring(g), planner="naive").eval("l5+/bus", obj=0,
                                                   stats=naive)
        assert naive.plan_mode == "naive"
        with pytest.raises(ValueError):
            P.RingRPQ(P.Ring(g), planner="bogus")
        return stats_fields(stats), stats_fields(rows[0]), stats_fields(naive)
    both(body)


def test_normalized_key_canonicalizes_assoc_and_alt_order():
    def body(P):
        nk = P.normalized_key
        assert nk("0/1/2") == nk("(0/1)/2") == nk("0/(1/2)")
        assert nk("0|1") == nk("1|0")
        assert nk("0|(1|2)") == nk("(2|1)|0")
        assert nk("0|0|1") == nk("1|0")
        assert nk("((0/1)/2)*") == nk("(0/(1/2))*")
        assert nk("(1|0)/2") == nk("(0|1)/2")
        assert nk("0/1") != nk("1/0")
        assert nk("0|1") != nk("0/1")
        return [nk(e) for e in ("0/1/2", "0|1", "0|(1|2)", "0|0|1",
                                "((0/1)/2)*", "(1|0)/2", "1/0")]
    both(body)


def test_plan_cache_shared_across_spellings():
    def body(P):
        g = P.fixtures.random_graph(10, 3, 30, seed=2, pred_zipf=False)
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            want = eng.eval("0/1/2", obj=0)
            m0 = eng.plans.misses
            for spelling in ("(0/1)/2", "0/(1/2)", "((0)/(1))/2"):
                assert eng.eval(spelling, obj=0) == want, (kind, spelling)
            assert eng.plans.misses == m0, kind
            out.append((want, cache_counters(eng.plans),
                        cache_counters(eng.decisions)))
        return out
    both(body)


def test_result_cache_replays_rewritten_plan_for_forward_spelling():
    def body(P):
        g = P.fixtures.metro_graph()
        n2i = {n: i for i, n in enumerate(g.node_names)}
        s, o = n2i["Baq"], n2i["SA"]
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind, planner="reverse")
            first = eng.eval_many([P.Query("l5+/bus", subject=s, obj=o)])
            assert eng.results.misses == 1 and eng.results.hits == 0, kind
            replay = eng.eval_many([P.Query("(l5)+/(bus)", subject=s,
                                            obj=o)])
            assert eng.results.hits == 1, kind
            assert replay == first == [{(s, o)}], kind
            out.append((first, cache_counters(eng.results)))
        eng = P.make_engine(g, "ring", planner="split")
        first = eng.eval_many([P.Query("l5/l5/bus", obj=o)])
        assert eng.results.misses == 1
        replay = eng.eval_many([P.Query("(l5/l5)/bus", obj=o)])
        assert eng.results.hits == 1
        assert replay == first
        assert first[0] == P.make_engine(g, "ring", planner="naive").eval(
            "l5/l5/bus", obj=o)
        out.append((first, cache_counters(eng.results)))
        return out
    both(body)
