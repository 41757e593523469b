"""The JAX package's ``tests/test_core.py`` on the port's copies: the
parser and Glushkov cases (``repro_torch.core.regex``, ``.glushkov``,
which ``PathCorpus``'s RPQ filter rests on), then the wavelet tree, the
ring, the paper's RPQ engine and the workload patterns, each body run on
both packages (``torch_parity.both``): the reference test's own asserts
on each, and the same ASTs, tables, answers, counters and sizes.  Exact
everywhere."""
import itertools
import random
import re as pyre

import numpy as np
import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from helpers import rand_expr_ast  # noqa: E402
from repro.core import regex as rrx  # noqa: E402
from repro.core.glushkov import Glushkov as RGlushkov  # noqa: E402
from repro_torch.core import regex as rx  # noqa: E402
from repro_torch.core.glushkov import Glushkov  # noqa: E402
from torch_parity import both, stats_fields  # noqa: E402

EXPRS = ["a/b*/b", "(l1|l2|l5)+", "a*/b/c*", "^bus/l5*/l5", "a?",
         "eps|a/b", "a/(b|c)*/d"]


def _port(ast):
    """The port's AST of a reference AST (through its printed form)."""
    return rx.parse(str(ast))


def _to_py(n):
    if isinstance(n, rx.Eps):
        return ""
    if isinstance(n, rx.Lit):
        return n.name
    if isinstance(n, rx.Cat):
        return f"(?:{_to_py(n.left)}{_to_py(n.right)})"
    if isinstance(n, rx.Alt):
        return f"(?:{_to_py(n.left)}|{_to_py(n.right)})"
    if isinstance(n, rx.Star):
        return f"(?:{_to_py(n.child)})*"
    if isinstance(n, rx.Plus):
        return f"(?:{_to_py(n.child)})+"
    if isinstance(n, rx.Opt):
        return f"(?:{_to_py(n.child)})?"


def _tables(g):
    return (g.m, dict(g.B), g.F, g.nullable, g.initial, g.nwords)


def test_parser_roundtrip():
    for e in EXPRS:
        ast = rx.parse(e)
        assert rx.parse(str(ast)) == ast
        assert str(ast) == str(rrx.parse(e))


def test_parser_errors():
    for bad in ["(a", "a|", "*a", "a//b", "^", "a)("]:
        with pytest.raises(ValueError):
            rx.parse(bad)
        with pytest.raises(ValueError):
            rrx.parse(bad)


def test_reverse_involution():
    rnd = random.Random(5)
    for _ in range(50):
        ast = _port(rand_expr_ast(rnd, 3, 3))
        assert rx.reverse(rx.reverse(ast)) == ast
        assert str(rx.reverse(ast)) == str(rrx.reverse(rrx.parse(str(ast))))


def test_glushkov_paper_example():
    """Fig. 2: a/b*/b — 4 states, B/T tables, forward + backward."""
    g = Glushkov.from_ast(rx.parse("a/b*/b"), lambda lit: lit.name)
    assert g.m == 3
    assert g.B["a"] == 0b0010 and g.B["b"] == 0b1100
    assert g.F == 0b1000 and not g.nullable
    ref = RGlushkov.from_ast(rrx.parse("a/b*/b"), lambda lit: lit.name)
    assert _tables(g) == _tables(ref)
    for w, exp in [("ab", True), ("abb", True), ("a", False), ("abba", False),
                   ("", False), ("b", False)]:
        assert g.match(list(w)) == exp
        assert g.match_backward(list(w)) == exp


def _rename(n):
    """Predicate ids '0'/'1' -> 'a'/'b' for Python ``re``."""
    names = {"0": "a", "1": "b"}
    if isinstance(n, rx.Lit):
        return rx.Lit(names[n.name])
    if isinstance(n, (rx.Cat, rx.Alt)):
        return type(n)(_rename(n.left), _rename(n.right))
    if isinstance(n, (rx.Star, rx.Plus, rx.Opt)):
        return type(n)(_rename(n.child))
    return n


def test_glushkov_vs_python_re():
    """150 random expressions: every word up to length 4 matched as Python
    ``re`` does, forward and backward, and the automaton's tables, its
    forward steps and answers equal to the reference's."""
    rnd = random.Random(0)
    for _ in range(150):
        ast = _rename(_port(rand_expr_ast(rnd, 3, 2, allow_inverse=False)))
        g = Glushkov.from_ast(ast, lambda lit: lit.name)
        ref = RGlushkov.from_ast(rrx.parse(str(ast)), lambda lit: lit.name)
        assert _tables(g) == _tables(ref), str(ast)
        pat = pyre.compile(f"^(?:{_to_py(ast)})$")
        for L in range(0, 5):
            for w in itertools.product("ab", repeat=L):
                exp = pat.match("".join(w)) is not None
                assert g.match(list(w)) == exp == ref.match(list(w))
                assert g.match_backward(list(w)) == exp
        for D in range(1 << min(g.m + 1, 6)):
            for c in "ab":
                assert g.forward_step(D, c) == ref.forward_step(D, c)
                assert g.backward_step(D, c) == ref.backward_step(D, c)


def test_glushkov_multiword_masks():
    """m > 32 forces multi-word packed tables, equal to the reference's."""
    expr = "/".join(["a"] * 40)
    g = Glushkov.from_ast(rx.parse(expr), lambda lit: lit.name)
    assert g.m == 40 and g.nwords == 2
    assert g.match(["a"] * 40)
    assert not g.match(["a"] * 39)
    Bp, bwd, fwd, Fp, ip = g.packed_tables(1, lambda lit: 0)
    assert Bp.shape == (1, 2) and bwd.shape == (41, 2)
    ref = RGlushkov.from_ast(rrx.parse(expr), lambda lit: lit.name)
    for a, b in zip((Bp, bwd, fwd, Fp, ip),
                    ref.packed_tables(1, lambda lit: 0)):
        np.testing.assert_array_equal(a, b)


# -- the wavelet tree, the ring, the paper's RPQ engine, the patterns ---------


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 500), st.integers(1, 60), st.integers(0, 2**31 - 1))
def test_wavelet_rank_access_property(n, sigma, seed):
    def body(P):
        rng = np.random.default_rng(seed)
        seq = rng.integers(0, sigma, n)
        wt = P.WaveletTree(seq, sigma)
        i = rng.integers(0, n, 30)
        acc = wt.access(i)
        assert np.array_equal(acc, seq[i])
        c = rng.integers(0, sigma, 30)
        pos = rng.integers(0, n + 1, 30)
        exp = np.array([(seq[:p] == cc).sum() for cc, p in zip(c, pos)])
        rank = wt.rank(c, pos)
        assert np.array_equal(rank, exp)
        return np.asarray(acc).tolist(), np.asarray(rank).tolist()
    both(body)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 300), st.integers(1, 40), st.integers(0, 2**31 - 1))
def test_wavelet_range_distinct_property(n, sigma, seed):
    def body(P):
        rng = np.random.default_rng(seed)
        seq = rng.integers(0, sigma, n)
        wt = P.WaveletTree(seq, sigma)
        b, e = sorted(rng.integers(0, n + 1, 2))
        got = sorted(wt.range_distinct(int(b), int(e)))
        assert [g[0] for g in got] == sorted(set(seq[b:e].tolist()))
        for sym, rb, re_ in got:
            assert rb == (seq[:b] == sym).sum()
            assert re_ == (seq[:e] == sym).sum()
        return [tuple(int(x) for x in g) for g in got]
    both(body)


def test_bitvector_edges():
    def body(P):
        out = []
        for n in [1, 63, 64, 65, 511, 512, 513]:
            bits = np.arange(n) % 3 == 0
            bv = P.BitVector(bits)
            idx = np.arange(n + 1)
            exp = np.concatenate([[0], np.cumsum(bits)])
            rank, get = bv.rank1(idx), bv.get(np.arange(n))
            assert np.array_equal(rank, exp)
            assert np.array_equal(get, bits.astype(np.int64))
            out.append((np.asarray(rank).tolist(), np.asarray(get).tolist(),
                        np.asarray(bv.words).view(np.uint64).tolist()))
        return out
    both(body)


def test_ring_backward_search():
    def body(P):
        g = P.fixtures.metro_graph()
        ring = P.Ring(g)
        s, p, o = ring.triples_completed()
        ranges = []
        for v in range(g.num_nodes):
            b, e = ring.object_range(v)
            assert e - b == (o == v).sum()
            for pid in range(ring.num_preds_completed):
                sb, se = ring.backward_search(b, e, pid)
                subs = sorted(ring.L_s[sb:se].tolist())
                exp = sorted(s[(o == v) & (p == pid)].tolist())
                assert subs == exp, (v, pid)
                ranges.append((int(b), int(e), int(sb), int(se), subs))
        return ranges
    both(body)


def test_ring_sizes():
    """The port's ``Ring.size_bytes()`` equals the reference's, key by
    key."""
    def body(P):
        g = P.fixtures.random_graph(100, 5, 400, seed=1)
        ring = P.Ring(g)
        sizes = ring.size_bytes()
        assert sizes["wt_Lp"] > 0 and sizes["wt_Ls"] > 0
        assert sizes["total"] < 40 * ring.n
        return dict(sizes)
    both(body)


def test_rpq_paper_worked_example():
    def body(P):
        g = P.fixtures.metro_graph()
        eng = P.RingRPQ(P.Ring(g))
        n2i = {n: i for i, n in enumerate(g.node_names)}
        stats = P.QueryStats()
        res = eng.eval("l5+/bus", subject=n2i["Baq"], stats=stats)
        assert {g.node_names[o] for (_, o) in res} == {"SA", "UCh"}
        yes = eng.eval("l5+/bus", subject=n2i["Baq"], obj=n2i["SA"])
        no = eng.eval("l5+/bus", subject=n2i["Baq"], obj=n2i["LH"])
        assert yes and not no
        return res, yes, no, stats_fields(stats)
    both(body)


def _fuzz_trials(paper_dv: bool):
    """The reference's 40 random (graph, expression) trials, each at four
    bindings, on either package: the answers and the oracle's, the work
    counters, and how many answers miss the oracle's."""
    def body(P):
        rnd = random.Random(11)
        out, misses = [], 0
        for trial in range(40):
            V = rnd.randrange(3, 12)
            P_ = rnd.randrange(1, 4)
            E = rnd.randrange(3, 25)
            g = P.fixtures.random_graph(V, P_, E, seed=trial, pred_zipf=False)
            eng = P.RingRPQ(P.Ring(g), paper_dv=paper_dv)
            expr = str(rand_expr_ast(rnd, 2, P_))
            for (sub, ob) in [(None, None), (0, None), (None, 0),
                              (0, min(1, V - 1))]:
                want = P.eval_oracle(g, expr, subject=sub, obj=ob)
                stats = P.QueryStats()
                have = eng.eval(expr, subject=sub, obj=ob, stats=stats)
                if paper_dv:
                    assert have <= want, (expr, sub, ob)
                    misses += have != want
                else:
                    assert want == have, (expr, sub, ob)
                out.append((have, stats_fields(stats)))
        return out, misses
    return body


def test_rpq_fuzz_vs_oracle():
    both(_fuzz_trials(paper_dv=False))


def test_paper_dv_rule_overprunes():
    """With the paper's literal Sec.-4.2 D[v] rule (``paper_dv=True``)
    answers are a subset of the oracle's, misses occur, and the port
    misses exactly where the reference does."""
    _, misses = both(_fuzz_trials(paper_dv=True))
    assert misses > 0


def test_rpq_work_bounded_by_product_subgraph():
    def body(P):
        rnd = random.Random(3)
        out = []
        for trial in range(10):
            g = P.fixtures.random_graph(10, 3, 30, seed=trial + 100,
                                        pred_zipf=False)
            expr = str(rand_expr_ast(rnd, 2, 3))
            stats = P.QueryStats()
            res = P.RingRPQ(P.Ring(g)).eval(expr, subject=None, obj=0,
                                            stats=stats)
            nodes, edges = P.product_subgraph_size(g, expr, obj=0)
            assert stats.node_state_activations <= 4 * (nodes + edges) + 16
            out.append((res, stats_fields(stats), int(nodes), int(edges)))
        return out
    both(body)


def test_rpq_limit_and_stats():
    def body(P):
        eng = P.RingRPQ(P.Ring(P.fixtures.metro_graph()))
        stats = P.QueryStats()
        res = eng.eval("l5|l1|l2|bus", stats=stats)
        assert stats.results == len(res) > 0
        return res, stats_fields(stats)
    both(body)


def test_classify_patterns():
    def body(P):
        got = [P.classify("0/1*", False, True), P.classify("0*", False, True),
               P.classify("^0", False, False)]
        assert got == ["v /* c", "v * c", "v ^ v"]
        return got
    both(body)


def test_workload_mix():
    def body(P):
        wl = P.generate_workload(500, num_preds=8, num_nodes=100, seed=1)
        assert len(wl.queries) == 500
        pats = {p for (_, _, _, p) in wl.queries}
        assert len(pats) >= 8
        for expr, s, o, pat in wl.queries[:50]:
            P.rx.parse(expr)
        return [tuple(q) for q in wl.queries]
    both(body)


def test_fixed_fixed_direction_planning():
    def body(P):
        T = [("n0", "a", "n1")] + [(f"n{i}", "b", f"n{i+1}")
                                   for i in range(1, 8)]
        g = P.LabeledGraph.from_string_triples(T)
        eng = P.RingRPQ(P.Ring(g))
        n2i = {n: i for i, n in enumerate(g.node_names)}
        yes = eng.eval("a/b*", subject=n2i["n0"], obj=n2i["n5"])
        no = eng.eval("a/b*", subject=n2i["n2"], obj=n2i["n5"])
        assert yes and not no
        bwd = eng._automaton(P.rx.parse("a/b*"))
        fwd = eng._automaton(P.rx.reverse(P.rx.parse("a/b*")))
        costs = (eng._start_cost(fwd), eng._start_cost(bwd))
        assert costs[0] < costs[1]
        return yes, no, costs
    both(body)



@pytest.mark.parametrize("binding", ["subject", "object", "both", "none"])
def test_label_oracle_matches_reference_oracle(binding):
    """The port's ``eval_oracle_by_label`` (a product BFS over each
    position's own labels; backwards from the object when only it is
    bound, with no reversed expression) equals the reference's
    ``eval_oracle`` (a BFS over every edge, from every node unless the
    subject is bound), on random graphs and expressions with inverse
    literals, nullable ones included."""
    from repro.core.fixtures import random_graph
    from repro.core.oracle import eval_oracle
    from repro_torch import convert
    from repro_torch.core.oracle import eval_oracle_by_label
    rnd = random.Random({"subject": 11, "object": 12, "both": 13,
                         "none": 14}[binding])
    nullable = nonempty = 0
    for trial in range(8):
        g = random_graph(14, 3, 40, seed=trial + 300, pred_zipf=False)
        pg = convert.graph_from_reference(g)
        for _ in range(4):
            expr = str(rand_expr_ast(rnd, 3, 3))
            nullable += rx.nullable(rx.parse(expr))
            for node in range(0, 14, 3):
                sub = node if binding in ("subject", "both") else None
                ob = {"object": node, "both": (node * 5) % 14}.get(binding)
                want = eval_oracle(g, expr, sub, ob)
                nonempty += bool(want)
                assert eval_oracle_by_label(pg, expr, sub, ob) == want, \
                    (trial, expr, sub, ob)
    assert nullable > 0 and nonempty > 0


@pytest.mark.parametrize("subject", [None, 8])
def test_label_oracle_limit_is_the_sorted_prefix(subject):
    """``eval_oracle_by_label(..., limit=k)`` is the first ``k`` pairs,
    in sorted order, of the reference oracle's whole answer set."""
    from repro.core.fixtures import random_graph
    from repro.core.oracle import eval_oracle
    from repro_torch import convert
    from repro_torch.core.oracle import eval_oracle_by_label
    g = random_graph(30, 3, 90, seed=5, pred_zipf=False)
    pg = convert.graph_from_reference(g)
    for expr in ("0/^1", "(0|1)+", "^2*/0", "1?/2"):
        want = sorted(eval_oracle(g, expr, subject, None))
        assert len(want) > (10 if subject is None else 1), expr
        for k in (1, 7, len(want) // 2, len(want), len(want) + 5):
            assert eval_oracle_by_label(pg, expr, subject, None,
                                        limit=k) == set(want[:k]), (expr, k)
