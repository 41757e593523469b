"""The port's packed BFS against the JAX package's, bit for bit.

On the CPU the port's ``packed_bfs`` runs the kernels' plain versions;
the JAX side runs its Pallas kernels in interpret mode, so the graphs
stay small (as ``tests/test_engines.py::test_packed_matches_dense``).
The loop on the card is held to this one in ``test_torch_cuda.py``."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import rand_expr_ast  # noqa: E402
from repro.core import regex as jrx  # noqa: E402
from repro.core.dense import DenseGraph as JDenseGraph  # noqa: E402
from repro.core.fixtures import random_graph  # noqa: E402
from repro.core.glushkov import Glushkov as JGlushkov  # noqa: E402
from repro.core.oracle import eval_oracle  # noqa: E402
from repro.core.packed import packed_bfs as j_packed_bfs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import regex as trx  # noqa: E402
from repro_torch.core.dense import DenseGraph  # noqa: E402
from repro_torch.core.glushkov import Glushkov  # noqa: E402
from repro_torch.core.packed import (  # noqa: E402
    answers_from_visited, one_endpoint_bfs, packed_bfs, packed_eval,
    packed_tables)
from repro_torch.kernels.ref import nfa_step_ref, segment_or_ref  # noqa: E402
from repro_torch.core.ring import LabeledGraph  # noqa: E402


def _cases():
    """The eight graphs and expressions of ``test_packed_matches_dense``
    (same seeds), plus one with 40 positions, so W = 2 words."""
    rnd = random.Random(31)
    out = []
    for trial in range(8):
        V, P, E = rnd.randrange(4, 12), rnd.randrange(1, 4), \
            rnd.randrange(5, 30)
        out.append((V, P, E, trial + 80, str(rand_expr_ast(rnd, 2, P))))
    wide = "/".join("(0|^1)" if k % 3 else "1*" for k in range(20))
    out.append((10, 2, 28, 97, wide))
    return out


CASES = _cases()


def _both(V, P, E, seed, expr, starts, max_steps=None):
    g = random_graph(V, P, E, seed=seed, pred_zipf=False)
    jg = JGlushkov.from_ast(jrx.parse(expr), g.resolve_lit)
    want = j_packed_bfs(JDenseGraph.from_graph(g), jg, starts, max_steps)
    tg = convert.graph_from_reference(g)
    pg = Glushkov.from_ast(trx.parse(expr), tg.resolve_lit)
    got = packed_bfs(DenseGraph.from_graph(tg, device="cpu"), pg, starts,
                     max_steps)
    return g, jg, want, got


@pytest.mark.parametrize("V,P,E,seed,expr", CASES)
def test_packed_bfs_matches_reference(V, P, E, seed, expr):
    g, jg, (want_vis, want_it), (vis, it) = _both(V, P, E, seed, expr, [0])
    assert vis.dtype == np.uint32 and vis.shape == want_vis.shape
    np.testing.assert_array_equal(vis, want_vis)
    assert it == want_it
    # and the answers are the oracle's, modulo the eps diagonal
    have = set(np.nonzero(answers_from_visited(vis))[0].tolist())
    want = {s for (s, o) in eval_oracle(g, expr, subject=None, obj=0)}
    if jrx.nullable(jrx.parse(expr)):
        want.discard(0)
        have.discard(0)
    assert have == want, expr


def test_packed_bfs_wide_case_has_two_words():
    V, P, E, seed, expr = CASES[-1]
    _g, jg, _want, (vis, _it) = _both(V, P, E, seed, expr, [0])
    assert jg.nwords >= 2 and vis.shape[1] == jg.nwords


@pytest.mark.parametrize("max_steps", [0, 1, 2])
def test_packed_bfs_max_steps_matches_reference(max_steps):
    V, P, E, seed, expr = CASES[1]
    _g, _jg, (want_vis, want_it), (vis, it) = _both(
        V, P, E, seed, expr, [0, 2, 3], max_steps)
    np.testing.assert_array_equal(vis, want_vis)
    assert it == want_it == min(it, max_steps)


def test_packed_bfs_start_without_live_edge_or_start_matches_reference():
    """A start node that is no edge's object steps once and adds nothing;
    no start at all steps zero times, as the JAX loop's first test."""
    V, P, E, seed, expr = 12, 2, 6, 41, "0/1*"
    g = random_graph(V, P, E, seed=seed, pred_zipf=False)
    idle = sorted(set(range(V)) - set(g.completed_triples()[2].tolist()))
    assert idle
    for starts in ([idle[0]], idle[:3], []):
        _g, _jg, (want_vis, want_it), (vis, it) = _both(
            V, P, E, seed, expr, np.array(starts, dtype=np.int64))
        np.testing.assert_array_equal(vis, want_vis)
        assert it == want_it == (1 if starts else 0)


def test_dense_graph_arrays_match_reference():
    for V, P, E, seed, _expr in CASES:
        g = random_graph(V, P, E, seed=seed, pred_zipf=False)
        want = JDenseGraph.from_graph(g)
        got = DenseGraph.from_graph(convert.graph_from_reference(g),
                                    device="cpu")
        for name in ("subj", "pred", "obj"):
            t = getattr(got.edges, name)
            assert t.dtype == torch.int32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(want, name)))
        assert (got.num_nodes, got.num_labels) == (want.num_nodes,
                                                   want.num_labels)


def test_dense_graph_has_no_silent_cpu_fallback():
    g = convert.graph_from_reference(random_graph(5, 1, 6, seed=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DenseGraph.from_graph(g)          # default device is "cuda"


def test_packed_tables_have_no_silent_cpu_fallback():
    tg = convert.graph_from_reference(random_graph(5, 1, 6, seed=1))
    pg = Glushkov.from_ast(trx.parse("0*"), tg.resolve_lit)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            packed_tables(pg, 2 * tg.num_preds)   # default device is "cuda"


def test_packed_bfs_on_step_sees_every_superstep():
    """The hook gets, before each superstep, the frontier, the visited
    words it does not yet hold, and the tables: the transition of their
    ``f[obj] & Bp[pred]`` ORed by subject is the next call's frontier.
    The hook leaves the result as it was (the W = 2 case)."""
    V, P, E, seed, expr = CASES[-1]
    tg = convert.graph_from_reference(
        random_graph(V, P, E, seed=seed, pred_zipf=False))
    dg = DenseGraph.from_graph(tg, device="cpu")
    pg = Glushkov.from_ast(trx.parse(expr), tg.resolve_lit)
    seen, want_next = [], []

    def hook(frontier, visited, Bp, bwd):
        assert frontier.shape == visited.shape == (V, pg.nwords)
        assert bwd.shape == (pg.m + 1, pg.nwords)
        assert not bool((frontier & visited).any())
        if want_next:
            assert torch.equal(frontier, want_next.pop())
        X = frontier.index_select(0, dg.edges.obj) & \
            Bp.index_select(0, dg.edges.pred)
        Y = nfa_step_ref(X, bwd)
        want_next.append(segment_or_ref(Y, dg.edges.subj, V) &
                         ~(visited | frontier))
        seen.append(int((Y != 0).sum()))

    vis, it = packed_bfs(dg, pg, [0], on_step=hook)
    want_vis, want_it = packed_bfs(dg, pg, [0])
    np.testing.assert_array_equal(vis, want_vis)
    assert it == want_it == len(seen) > 0


@pytest.mark.parametrize("subject,obj", [(None, 3), (3, None)])
def test_one_endpoint_bfs_is_packed_evals_rule(subject, obj):
    """Its automaton and start, run through ``packed_bfs``, give the
    nodes of ``packed_eval``'s pairs at the free endpoint."""
    g = random_graph(9, 3, 24, seed=11, pred_zipf=False)
    tg = convert.graph_from_reference(g)
    dg = DenseGraph.from_graph(tg, device="cpu")
    for expr in ("0/1*", "^2/(0|1)", "1+/^0"):
        ast = trx.parse(expr)
        auto, starts = one_endpoint_bfs(tg, ast, subject, obj)
        assert starts == [3 if subject is None else subject]
        vis, it = packed_bfs(dg, auto, starts)
        pairs, steps = packed_eval(dg, tg, expr, subject, obj)
        free = {a if subject is None else b for a, b in pairs}
        found = set(np.nonzero(answers_from_visited(vis))[0].tolist())
        if trx.nullable(ast):
            free.discard(starts[0])
            found.discard(starts[0])
        assert found == free and it == steps, expr


def test_packed_tables_are_int32_words():
    g = random_graph(6, 2, 10, seed=3, pred_zipf=False)
    tg = convert.graph_from_reference(g)
    pg = Glushkov.from_ast(trx.parse("0/1*"), tg.resolve_lit)
    Bp, bwd, Fp, ip = packed_tables(pg, 2 * tg.num_preds, device="cpu")
    Bn, bn, _f, Fn, iN = pg.packed_tables(2 * tg.num_preds, lambda l: l)
    for t, a in ((Bp, Bn), (bwd, bn), (Fp, Fn), (ip, iN)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy().view(np.uint32), a)


def test_packed_bfs_without_edges_and_with_isolated_nodes():
    """A graph with no edges steps once and finds nothing; nodes with no
    edges keep zero rows."""
    empty = LabeledGraph(s=np.zeros(0, np.int64), p=np.zeros(0, np.int64),
                         o=np.zeros(0, np.int64), num_nodes=4, num_preds=1)
    dg = DenseGraph.from_graph(empty, device="cpu")
    g = Glushkov.from_ast(trx.parse("0+"), empty.resolve_lit)
    vis, it = packed_bfs(dg, g, [2])
    assert it == 1 and not answers_from_visited(vis).any()
    assert vis[[0, 1, 3]].sum() == 0
    one = LabeledGraph(s=np.array([0]), p=np.array([0]), o=np.array([1]),
                       num_nodes=5, num_preds=1)
    dg = DenseGraph.from_graph(one, device="cpu")
    vis, it = packed_bfs(dg, Glushkov.from_ast(trx.parse("0+"),
                                               one.resolve_lit), [1])
    assert answers_from_visited(vis).tolist() == [True, False, False, False,
                                                  False]
    assert vis[[2, 3, 4]].sum() == 0


@pytest.mark.parametrize("subject,obj", [(None, None), (None, 0), (0, None),
                                         (0, 1), (2, 2)])
def test_packed_eval_matches_oracle(subject, obj):
    """The request rule over ``packed_bfs`` equals the oracle, eps pairs
    included, for every binding of the endpoints."""
    rnd = random.Random(5)
    g = random_graph(9, 3, 24, seed=11, pred_zipf=False)
    tg = convert.graph_from_reference(g)
    dg = DenseGraph.from_graph(tg, device="cpu")
    for _ in range(4):
        expr = str(rand_expr_ast(rnd, 2, 3))
        got, steps = packed_eval(dg, tg, expr, subject, obj)
        assert got == eval_oracle(g, expr, subject, obj), (expr, subject,
                                                           obj)
        assert steps >= 0
