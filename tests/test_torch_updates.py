"""Live updates (add_edges / remove_edges / compact) on the port's ring
engine against the JAX package's, with the kernel path forced (see
``torch_parity``): equal answers, work counters and effective graphs at
every epoch.  Then the reference's ``tests/test_updates.py``, each body
run on both packages (``torch_parity.both``): its own asserts on each,
and the answers, effective edges, epochs and cache counters equal."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fixtures as rfix  # noqa: E402
from repro_torch import convert  # noqa: E402
from torch_parity import (BINDINGS, both, cache_counters,  # noqa: E402
                          check_eval, check_eval_many, engines, stats_fields)


@pytest.mark.parametrize("seed", [0, 1])
def test_live_updates_parity(seed):
    rnd = random.Random(seed)
    g = rfix.random_graph(30, 3, 100, seed=seed + 3)
    ref, port = engines(g)
    exprs = ["0/1*", "(0|2)/1", "^1/0*"]

    def check_epoch():
        assert port.epoch == ref.epoch
        eff = ref.effective_graph()
        pe = port.effective_graph()
        for f in ("s", "p", "o"):
            np.testing.assert_array_equal(getattr(pe, f), getattr(eff, f))
        for expr in exprs:
            for s, o in BINDINGS:
                check_eval(ref, port, eff, expr, s, o)
        qs = [(e, None, rnd.randrange(30)) for e in exprs]
        check_eval_many(ref, port, eff, qs)

    check_epoch()
    for step in range(2):
        adds = [(rnd.randrange(30), rnd.randrange(3), rnd.randrange(30))
                for _ in range(4)]
        s, p, o = g.s[step], g.p[step], g.o[step]
        rems = [(int(s), int(p), int(o))]
        assert port.add_edges(adds) == ref.add_edges(adds)
        check_epoch()
        assert port.remove_edges(rems) == ref.remove_edges(rems)
        check_epoch()
    port.compact()
    ref.compact()
    assert port.compactions == ref.compactions == 1
    check_epoch()


# -- the reference's tests/test_updates.py ------------------------------------


def _random_mutation(rnd, g, current):
    V, P = g.num_nodes, g.num_preds
    adds = [(rnd.randrange(V), rnd.randrange(P), rnd.randrange(V))
            for _ in range(rnd.randrange(1, 4))]
    rems = []
    if current and rnd.random() < 0.8:
        rems.append(rnd.choice(current))
    rems.append((rnd.randrange(V), rnd.randrange(P), rnd.randrange(V)))
    return adds, rems


def _apply_raw(current, adds, rems):
    return sorted((set(current) | set(adds)) - set(rems))


def _edges(g):
    return sorted(zip(np.asarray(g.s).tolist(), np.asarray(g.p).tolist(),
                      np.asarray(g.o).tolist()))


def test_updates_planner_shapes_rebuild_parity():
    def body(P):
        g = P.fixtures.random_graph(12, 3, 45, seed=19, pred_zipf=False)
        adds = [(1, 0, 3), (3, 1, 7), (7, 2, 1), (0, 2, 11)]
        rems = [(int(g.s[i]), int(g.p[i]), int(g.o[i])) for i in (0, 5, 9)]
        out = []
        for policy in ("cost", "naive", "forward", "reverse", "split"):
            for kind in ("ring", "dense"):
                eng = P.make_engine(g, kind, planner=policy)
                eng.eval("0/1/2")
                eng.add_edges(adds)
                eng.remove_edges(rems)
                eff = eng.effective_graph()
                for expr in ("0/1/2", "0/1*", "2+"):
                    for (s, o) in [(None, None), (None, 3), (5, None),
                                   (5, 3)]:
                        want = P.eval_oracle(eff, expr, subject=s, obj=o)
                        stats = P.QueryStats()
                        have = eng.eval(expr, subject=s, obj=o, stats=stats)
                        assert have == want, (policy, kind, expr, s, o)
                        out.append((have, stats_fields(stats)))
        return out
    both(body)


def test_updates_eval_many_and_limit():
    def body(P):
        g = P.fixtures.random_graph(12, 3, 40, seed=3, pred_zipf=False)
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            eng.eval_many([P.Query("0/1*", obj=2)])
            eng.add_edges([(2, 0, 5), (5, 1, 2)])
            eng.remove_edges([(int(g.s[1]), int(g.p[1]), int(g.o[1]))])
            eff = eng.effective_graph()
            qs = [P.Query("0/1*", obj=2), P.Query("2+", obj=3),
                  P.Query("0/1*"), P.Query("0/1*", obj=2),
                  P.Query("0/1*", limit=3)]
            res = eng.eval_many(qs)
            for q, r in zip(qs, res):
                want = P.eval_oracle(eff, q.expr, q.subject, q.obj)
                if q.limit is not None and len(want) > q.limit:
                    want = set(sorted(want)[:q.limit])
                assert r == want, (kind, q)
                assert eng.eval(q.expr, q.subject, q.obj, q.limit) == want
            out.append((res, eng.epoch, cache_counters(eng.results)))
        return out
    both(body)


def test_updates_wavefront_sequential_activation_parity():
    def body(P):
        g = P.fixtures.random_graph(11, 3, 35, seed=23, pred_zipf=False)
        wave = P.make_engine(g, "ring")
        seq = P.make_engine(g, "ring", wavefront=False)
        for eng in (wave, seq):
            eng.add_edges([(1, 0, 4), (4, 1, 9), (9, 2, 1)])
            eng.remove_edges([(int(g.s[2]), int(g.p[2]), int(g.o[2]))])
        out = []
        for expr in ("0/1*", "(0|1)/2", "2+"):
            for (s, o) in [(None, 4), (1, None), (None, None)]:
                st_w, st_s = P.QueryStats(), P.QueryStats()
                rw = wave.eval(expr, subject=s, obj=o, stats=st_w)
                rs = seq.eval(expr, subject=s, obj=o, stats=st_s)
                assert rw == rs, (expr, s, o)
                assert st_w.node_state_activations == \
                    st_s.node_state_activations, (expr, s, o)
                out.append((rw, stats_fields(st_w), stats_fields(st_s)))
        return out
    both(body)


def test_update_cache_invalidation_footprint_precision():
    def body(P):
        g = P.fixtures.random_graph(12, 3, 40, seed=6, pred_zipf=False)
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            qs = [P.Query("0/1*", obj=2), P.Query("2+", obj=3),
                  P.Query("^1", obj=4)]
            r0 = eng.eval_many(qs)
            h0 = eng.results.hits
            eng.eval_many(qs)
            assert eng.results.hits == h0 + 3, kind
            d0 = len(eng.decisions)
            eng.add_edges([(0, 2, 1)])
            assert eng.results.invalidations == 1, kind
            assert len(eng.decisions) < d0 or d0 == 0
            h1, m1 = eng.results.hits, eng.results.misses
            r1 = eng.eval_many(qs)
            assert eng.results.hits == h1 + 2, kind
            assert eng.results.misses == m1 + 1, kind
            assert r1[0] == r0[0] and r1[2] == r0[2], kind
            assert r1[1] == P.eval_oracle(eng.effective_graph(), "2+",
                                          None, 3)
            stats_out = []
            if kind == "ring":
                eng.eval_many(qs, stats_out=stats_out)
                assert all(st_.epoch == eng.epoch for st_ in stats_out)
                assert all(st_.result_cache_invalidations ==
                           eng.results.invalidations for st_ in stats_out)
            out.append((r0, r1, d0, cache_counters(eng.results),
                        cache_counters(eng.decisions),
                        [stats_fields(s) for s in stats_out]))
        return out
    both(body)


def test_update_stale_answers_impossible_by_construction():
    def body(P):
        g = P.fixtures.metro_graph()
        eng = P.make_engine(g, "ring")
        eng.add_edges([(0, 0, 1)])
        key = P.result_key(P.Query("l5", obj=1))
        fp = frozenset({g.pred_of("l5")})
        eng.results._insert(key, frozenset({(7, 7)}), eng.results.clock(),
                            footprint=fp, epoch=eng.epoch)
        assert eng.results.get(key) is not None
        eng.delta.apply(add=[(2, g.pred_of("l5"), 3)])
        assert eng.results.get(key) is None
        assert eng.results.invalidations >= 1
        assert eng.results.misses >= 1
        return key, eng.epoch, cache_counters(eng.results)
    both(body)


def test_updates_compaction_threshold_and_equivalence():
    def body(P):
        rnd = random.Random(29)
        g = P.fixtures.random_graph(12, 3, 35, seed=31, pred_zipf=False)
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind, compact_threshold=12)
            seen_compaction = False
            current = _edges(g)
            for step in range(6):
                adds, rems = _random_mutation(rnd, g, current)
                current = _apply_raw(current, adds, rems)
                eng.add_edges(adds)
                eng.remove_edges(rems)
                seen_compaction |= eng.compactions > 0
                eff = eng.effective_graph()
                assert _edges(eff) == current, (kind, step)
                got = eng.eval("0/1*")
                assert got == P.eval_oracle(eff, "0/1*", None, None)
                out.append((got, eng.compactions, eng.delta.size))
            assert seen_compaction, kind
            assert eng.epoch == 12, kind
            before = eng.eval("2+")
            eng.compact()
            assert eng.delta.size == 0
            assert eng.eval("2+") == before
            out.append((before, eng.compactions, eng.epoch))
        return out
    both(body)


def test_updates_dictionary_bounds_rejected():
    def body(P):
        g = P.fixtures.metro_graph()
        eng = P.make_engine(g, "ring")
        with pytest.raises(ValueError):
            eng.add_edges([(0, g.num_preds, 1)])
        with pytest.raises(ValueError):
            eng.add_edges([(g.num_nodes, 0, 1)])
        with pytest.raises(ValueError):
            eng.remove_edges([(0, 0, -1)])
        assert eng.epoch == 0 and (eng.delta is None or eng.delta.size == 0)
        return eng.epoch, eng.delta is None
    both(body)


def test_updates_noop_mutations_and_double_ops():
    def body(P):
        g = P.fixtures.random_graph(10, 2, 20, seed=2, pred_zipf=False)
        first = (int(g.s[0]), int(g.p[0]), int(g.o[0]))
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            out.append(eng.add_edges([first]))
            out.append(eng.remove_edges(
                [(9, 1, 9)] if (9, 1, 9) != first else [(8, 1, 8)]))
            out.append(eng.add_edges([(3, 1, 4)]))
            out.append(eng.remove_edges([(3, 1, 4)]))
            out.append(eng.remove_edges([first]))
            out.append(eng.add_edges([first]))
            eff = eng.effective_graph()
            for expr in ("0", "1", "^0/1", "(0|1)+"):
                for (s, o) in [(None, None), (None, 4), (3, None)]:
                    got = eng.eval(expr, subject=s, obj=o)
                    assert got == P.eval_oracle(eff, expr, subject=s,
                                                obj=o), (kind, expr)
                    out.append(got)
            out.append((eng.epoch, _edges(eff)))
        return out
    both(body)


def test_updates_overlay_deadline_enforced():
    """The reference's 1e-9 s deadline on a traversal whose adjacency is
    all in the overlay's insert buffer: both packages raise, and recover."""
    def body(P):
        g = P.LabeledGraph.from_arrays([0], [1], [1], num_nodes=140,
                                       num_preds=2)
        eng = P.make_engine(g, "ring")
        eng.add_edges([(i, 0, i + 1) for i in range(2, 132)])
        want = eng.eval("0+", obj=131)
        assert (2, 131) in want
        with pytest.raises(TimeoutError):
            eng.eval("0+", obj=131, deadline_s=1e-9)
        assert eng.eval("0+", obj=131) == want
        return want
    both(body)


def test_updates_load_overlay_invalidates_warm_caches():
    def body(P):
        g = P.fixtures.random_graph(12, 3, 40, seed=21, pred_zipf=False)
        src = P.make_engine(g, "ring")
        src.add_edges([(1, 2, 3), (3, 2, 5)])
        state = src.overlay_state()
        out = [{k: np.asarray(v).tolist() for k, v in state.items()}]
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            r_untouched = eng.eval_many([P.Query("0/1*", obj=2)])[0]
            eng.eval_many([P.Query("2+", obj=3)])
            inv0 = eng.results.invalidations
            eng.load_overlay(state)
            assert eng.results.invalidations > inv0, kind
            h0 = eng.results.hits
            assert eng.eval_many([P.Query("0/1*", obj=2)])[0] == r_untouched
            assert eng.results.hits == h0 + 1, kind
            want = P.eval_oracle(eng.effective_graph(), "2+", None, 3)
            got = eng.eval_many([P.Query("2+", obj=3)])[0]
            assert got == want, kind
            out.append((r_untouched, got, eng.epoch,
                        cache_counters(eng.results),
                        cache_counters(eng.decisions)))
        return out
    both(body)


def test_updates_stats_refresh_keeps_planner_sound():
    def body(P):
        g = P.fixtures.random_graph(14, 3, 50, seed=13, pred_zipf=False)
        out = []
        for kind in ("ring", "dense"):
            eng = P.make_engine(g, kind)
            eng.eval("0/1*", obj=2)
            eng.add_edges([(1, 0, 3), (3, 2, 7), (7, 2, 1)])
            eng.remove_edges([(int(g.s[0]), int(g.p[0]), int(g.o[0]))])
            want = P.GraphStats.from_graph(eng.effective_graph())
            have = eng.graph_stats
            for f in ("freq", "distinct_subj", "distinct_obj"):
                assert np.array_equal(getattr(have, f), getattr(want, f)), \
                    (kind, f)
            assert have.num_edges == want.num_edges, kind
            out.append([np.asarray(getattr(have, f)).tolist() for f in
                        ("freq", "distinct_subj", "distinct_obj")]
                       + [have.num_edges])
        return out
    both(body)


def test_updates_sharded_multidevice_subprocess():
    """The reference's sharded acceptance property on the port.  The
    reference's side fails on jax 0.9.0 (its ``_shard_map``), so the
    yardstick is the port's one-device engines and the oracle: both
    engines sharded over a mesh of 8 x the CPU (each shard its own
    tensors; no subprocess needed) apply the same overlay and answer as
    the rebuild oracle at every epoch."""
    from repro.core.oracle import eval_oracle
    from repro_torch.core.distributed import Mesh
    from repro_torch.core.engines import Query, make_engine

    rnd = random.Random(3)
    g = convert.graph_from_reference(
        rfix.random_graph(18, 3, 60, seed=5, pred_zipf=False))
    mesh = Mesh(["cpu"] * 8, ("data",))
    shd_d = make_engine(g, "dense", device="cpu", mesh=mesh)
    shd_r = make_engine(g, "ring", device="cpu", mesh=mesh,
                        kernel_threshold=1)
    one_d = make_engine(g, "dense", device="cpu")
    one_r = make_engine(g, "ring", device="cpu", kernel_threshold=1)
    for step in range(3):
        adds = [(rnd.randrange(18), rnd.randrange(3), rnd.randrange(18))
                for _ in range(4)]
        rems = [(rnd.randrange(18), rnd.randrange(3), rnd.randrange(18))
                for _ in range(2)]
        for e in (shd_d, shd_r, one_d, one_r):
            e.add_edges(adds)
            e.remove_edges(rems)
        eff = shd_d.effective_graph()
        for expr in ("0/1*", "(0|1)/2", "2+"):
            for s, o in [(None, 3), (5, None), (None, None)]:
                want = eval_oracle(eff, expr, subject=s, obj=o)
                assert shd_d.eval(expr, s, o) == want == \
                    one_d.eval(expr, s, o), ("dense", step, expr, s, o)
                assert shd_r.eval(expr, s, o) == want == \
                    one_r.eval(expr, s, o), ("ring", step, expr, s, o)
        qs = [Query(e, obj=3) for e in ("0/1*", "2+")]
        assert shd_d.eval_many(qs) == shd_r.eval_many(qs) == \
            one_d.eval_many(qs)
    assert shd_d.sharded.dispatches > 0
    assert shd_d.sharded.edge_refreshes > 1
    assert shd_r.sharded_kernel_batches > 0
