"""The JAX package's heterogeneous-batch and result-cache suite
(``tests/test_hetero_batch.py``) on the port, with ``device="cpu"``: each
body runs on both packages (``torch_parity.both``), the reference test's
own asserts on each, and the answers, ``QueryStats`` rows, cache counters
and ``bundle_kernel_batches`` equal."""
import random

import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from torch_parity import both, cache_counters, stats_fields  # noqa: E402

# automaton sizes m+1 from 2 to 9: the dense engine's pow2 padding buckets
# (4 and 8) and the ring bundle's distinct block widths
_MIXED_EXPRS = [
    "0", "^1", "0/1", "(0|2)", "2*/0", "^1/0*",
    "0/1/2*", "(0|1)/(2|0)+", "0/1/2/0*", "(0/1/2)|(2/1/0)",
]


def _mixed_batch(P, rnd, num_nodes, n):
    out = []
    for i in range(n):
        expr = _MIXED_EXPRS[rnd.randrange(len(_MIXED_EXPRS))]
        kind = i % 4
        if kind == 0:
            out.append(P.Query(expr, obj=rnd.randrange(num_nodes)))
        elif kind == 1:
            out.append(P.Query(expr, subject=rnd.randrange(num_nodes)))
        elif kind == 2:
            out.append(P.Query(expr, subject=rnd.randrange(num_nodes),
                               obj=rnd.randrange(num_nodes)))
        else:
            out.append(P.Query(expr))
    out.append(out[0])
    return out


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_hetero_eval_many_matches_eval(seed):
    def body(P):
        rnd = random.Random(seed)
        V = rnd.randrange(8, 16)
        g = P.fixtures.random_graph(V, 3, rnd.randrange(20, 60),
                                    seed=seed % 997, pred_zipf=False)
        queries = _mixed_batch(P, rnd, V, 12)
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            rows = [] if kind == "ring" else None
            batched = eng.eval_many(queries, **(
                {"stats_out": rows} if rows is not None else {}))
            for q, got in zip(queries, batched):
                want = P.eval_oracle(g, q.expr, subject=q.subject, obj=q.obj)
                assert got == want, (kind, q)
                assert eng.eval(q.expr, q.subject, q.obj) == got, (kind, q)
            out.append((batched, [stats_fields(r) for r in rows or []],
                        cache_counters(eng.results),
                        getattr(eng, "bundle_kernel_batches", None),
                        getattr(eng, "hetero_dispatches", None)))
        return out
    both(body)


def test_hetero_ring_kernel_bundle_fires():
    """``kernel_threshold=1`` pushes the multi-plan wavefront through the
    block-diagonal ``nfa_step`` bundle, with the scalar engine's answers
    (the card's twin is in ``tests/test_torch_cuda.py``)."""
    def body(P):
        g = P.fixtures.metro_graph()
        scalar = P.RingRPQ(P.Ring(g))
        kern = P.RingRPQ(P.Ring(g), kernel_threshold=1)
        queries = [P.Query("l5+/bus", obj=o) for o in range(g.num_nodes)] + \
                  [P.Query("bus|(l5/l5)", obj=o) for o in range(g.num_nodes)]
        stats_out = []
        want = scalar.eval_many(queries)
        got = kern.eval_many(queries, stats_out=stats_out)
        assert got == want
        assert kern.bundle_kernel_batches > 0
        assert sum(s.kernel_tasks for s in stats_out) > 0
        return got, [stats_fields(s) for s in stats_out], \
            kern.bundle_kernel_batches
    both(body)


def test_plan_bundle_block_diagonal_layout():
    """Offsets tile the state space; the packed table (the port's own
    ``pack_block_diagonal``, ``int32`` words) confines each plan's
    transitions to its own block, word for word the reference's."""
    import numpy as np

    def body(P):
        gs = [P.build("0/1*"), P.build("(0|1)/0"), P.build("1")]
        bundle = P.PlanBundle.build(gs, [g.m + 1 for g in gs])
        assert bundle.offsets == [0, 3, 7]
        assert bundle.S_total == 9
        assert bundle.S_max == 4
        packed = np.asarray(P.pack_block_diagonal(
            [g.pred_mask for g in gs], bundle.offsets, bundle.S_total))
        assert packed.shape == (bundle.S_total, (bundle.S_total + 31) // 32)
        words = packed.view(np.uint32)
        for g, off in zip(gs, bundle.offsets):
            S = g.m + 1
            block_mask = ((1 << S) - 1) << off
            for j in range(S):
                acc = 0
                for w in range(words.shape[1]):
                    acc |= int(words[off + j, w]) << (32 * w)
                assert acc & ~block_mask == 0, (off, j)
                assert acc == g.pred_mask[j] << off, (off, j)
        return list(bundle.offsets), words.tolist()
    both(body)


def test_result_cache_replay_and_counters():
    def body(P):
        g = P.fixtures.metro_graph()
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            queries = [P.Query("l5+/bus", obj=o) for o in range(4)]
            first = eng.eval_many(queries)
            assert eng.results.hits == 0 and \
                eng.results.misses == len(queries)
            first[0].add((-1, -1))
            replay = eng.eval_many(queries)
            assert eng.results.hits == len(queries), kind
            assert (-1, -1) not in replay[0]
            assert replay[1:] == first[1:]
            out.append((replay, cache_counters(eng.results)))
        return out
    both(body)


def test_result_cache_ttl_and_lru_bounds():
    def body(P):
        fake = [0.0]
        cache = P.ResultCache(max_entries=2, ttl_s=10.0,
                              clock=lambda: fake[0])
        cache.put("a", {(1, 1)})
        cache.put("b", {(2, 2)})
        assert cache.get("a") == frozenset({(1, 1)})
        cache.put("c", {(3, 3)})
        assert cache.get("b") is None
        assert cache.get("a") is not None
        assert cache.evictions == 1
        fake[0] = 11.0
        assert cache.get("a") is None
        assert cache.expirations == 1
        assert len(cache) <= 2
        return cache_counters(cache), list(cache._entries)
    both(body)


def test_result_cache_ttl_in_engine():
    def body(P):
        fake = [0.0]
        g = P.fixtures.metro_graph()
        eng = P.make_engine(g, "dense", result_cache=P.ResultCache(
            ttl_s=5.0, clock=lambda: fake[0]))
        q = [P.Query("l5+/bus", obj=3)]
        first = eng.eval_many(q)
        fake[0] = 100.0
        again = eng.eval_many(q)
        assert again == first
        assert eng.results.expirations == 1
        assert eng.results.misses == 2
        return again, cache_counters(eng.results)
    both(body)


def test_eval_many_stats_surface_result_cache():
    def body(P):
        eng = P.make_engine(P.fixtures.metro_graph(), "ring")
        queries = [P.Query("l5+/bus", obj=1), P.Query("l5+/bus", obj=1)]
        stats_out = []
        res = eng.eval_many(queries, stats_out=stats_out)
        assert [s.result_cache_misses for s in stats_out] == [1, 1]
        first = [stats_fields(s) for s in stats_out]
        stats_out = []
        replay = eng.eval_many(queries, stats_out=stats_out)
        assert [s.result_cache_hits for s in stats_out] == [1, 1]
        assert replay == res
        assert [s.results for s in stats_out] == [len(r) for r in res]
        return res, first, [stats_fields(s) for s in stats_out], \
            cache_counters(eng.results)
    both(body)
