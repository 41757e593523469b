"""The object-grouped edge layout that ``packed_superstep`` reads, on the
CPU.

Every edge epoch of the port (a ``DenseGraph``'s base edges, the dense
engine's effective edges after tombstones and inserts, and each shard's
and model replica's device copy on a mesh) carries its edges grouped by
object (``kernels/packed_superstep.py`` ``group_by_object``).  Held
here: the grouped view is exactly the multiset of the epoch's non-inert
edges, in (object, subject) order; the kernel's plain version over it
equals the JAX package's ``_step_core`` and ``_local_bfs_step`` bit for
bit; a ``DenseStepper`` slot admitted before a mutation answers from the
layout of its admission epoch.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as rdist  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from repro.core.dense import DenseGraph as RDenseGraph  # noqa: E402
from repro.core.dense import _step_core  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed as pdist  # noqa: E402
from repro_torch.core import regex as prx  # noqa: E402
from repro_torch.core.dense import DenseRPQ as PDense  # noqa: E402
from repro_torch.core.dense import Edges  # noqa: E402
from repro_torch.core.engines import make_engine as pmake  # noqa: E402
from repro_torch.core.oracle import eval_oracle  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.packed_superstep import (  # noqa: E402
    TILE, new_scratch)


def _rows(*arrays):
    """Sorted (s, p, o) rows of int arrays or tensors."""
    cols = [np.asarray(a.cpu() if torch.is_tensor(a) else a, dtype=np.int64)
            for a in arrays]
    return sorted(zip(*(c.tolist() for c in cols)))


def _check_grouped(edges: Edges, num_objects: int, inert: int):
    """``edges.grouped`` holds exactly the non-inert, in-range edges of
    ``edges``, in (object, subject) order, with consistent offsets and
    tile count; returns those rows."""
    lay = edges.grouped
    subj, pred, obj = edges.subj, edges.pred, edges.obj
    keep = (pred != inert) & (obj >= 0) & (obj < num_objects)
    want = _rows(subj[keep], pred[keep], obj[keep])
    objs = lay.objects()
    assert _rows(lay.subj, lay.pred, objs) == want
    key = objs.to(torch.int64) * (2**32) + lay.subj.to(torch.int64)
    assert bool((key[1:] >= key[:-1]).all())
    off = lay.offsets.to(torch.int64)
    assert off.shape == (num_objects + 1,) and int(off[0]) == 0
    assert bool((off[1:] >= off[:-1]).all())
    assert int(off[-1]) == lay.subj.numel() == len(want)
    assert lay.num_objects == num_objects
    assert lay.tiles == int(((off[1:] - off[:-1] + TILE - 1) // TILE).sum())
    assert all(t.dtype == torch.int32 for t in (lay.offsets, lay.subj,
                                                lay.pred))
    return want


def _mutate(eng, g, step):
    rnd = random.Random(step)
    adds = [(rnd.randrange(g.num_nodes), rnd.randrange(g.num_preds),
             rnd.randrange(g.num_nodes)) for _ in range(5)]
    eng.add_edges(adds)
    eng.remove_edges([(int(g.s[k]), int(g.p[k]), int(g.o[k]))
                      for k in range(step, step + 3)])


@pytest.mark.parametrize("epoch", ["base", "tombstones", "inserts",
                                   "both", "compacted"])
def test_grouped_layout_holds_non_inert_edges(epoch):
    """Unsharded: the base ``DenseGraph``'s epoch, and the effective
    epoch after tombstones, inserts, both, and a compaction; its
    non-inert edges are the effective graph's completed triples."""
    g = rfix.random_graph(40, 3, 150, seed=3)
    eng = PDense(convert.graph_from_reference(g), device="cpu")
    if epoch in ("tombstones", "both", "compacted"):
        eng.remove_edges([(int(g.s[k]), int(g.p[k]), int(g.o[k]))
                          for k in range(6)])
    if epoch in ("inserts", "both", "compacted"):
        eng.add_edges([(1, 0, 2), (2, 1, 3), (39, 2, 0), (5, 0, 5)])
    if epoch == "compacted":
        eng.compact()
    edges = eng._edges()
    assert (edges is eng.dg.edges) == (epoch in ("base", "compacted"))
    got = _check_grouped(edges, eng.dg.num_nodes, eng.dg.num_labels)
    assert got == _rows(*eng.effective_graph().completed_triples())


@pytest.mark.parametrize("shards,model", [(1, 1), (3, 1), (8, 1), (4, 2)])
@pytest.mark.parametrize("mutated", [False, True])
def test_sharded_grouped_layout_holds_each_shards_edges(shards, model,
                                                        mutated):
    """On a mesh: each data shard's, and each model replica's, grouped
    device copy holds exactly its block of the host partition (the
    reference's ``ShardedGraph``, padding included) less the inert
    padding and tombstones, over the gathered frontier's rows; the
    shards together hold the effective graph's completed triples."""
    g = rfix.random_graph(29, 3, 110, seed=shards)
    names = ("data", "model") if model > 1 else ("data",)
    devs = [["cpu"] * model] * shards if model > 1 else ["cpu"] * shards
    eng = pmake(convert.graph_from_reference(g), kind="dense", device="cpu",
                mesh=pdist.Mesh(devs, names),
                model_axis="model" if model > 1 else None)
    if mutated:
        _mutate(eng, g, 2)
    ex = eng.sharded
    if not mutated:
        want = rdist.ShardedGraph.from_dense(RDenseGraph.from_graph(g),
                                             shards, pad_multiple=model)
        for a, b in (("subj_local", "subj_local"), ("pred", "pred"),
                     ("obj", "obj")):
            np.testing.assert_array_equal(getattr(ex.sg, a),
                                          getattr(want, b))
    Vl, Vp, L = ex.sg.nodes_per_shard, ex.sg.num_nodes_padded, ex.num_labels
    Em = ex.sg.subj_local.shape[1] // model
    union = []
    for k in range(shards):
        for j in range(model):
            edges = ex._edges[k][j]
            block = slice(j * Em, (j + 1) * Em)
            for t, host in zip((edges.subj, edges.pred, edges.obj),
                               (ex.sg.subj_local, ex.sg.pred, ex.sg.obj)):
                np.testing.assert_array_equal(t.numpy(), host[k, block])
            rows = _check_grouped(edges, Vp, L)
            union += [(s + k * Vl, p, o) for s, p, o in rows]
    assert sorted(union) == _rows(*eng.effective_graph().completed_triples())


def _planes(rng, shape, share):
    return (rng.random(shape) < share).astype(np.int8)


def _words(planes):
    return ops.words_to_tensor(ops.pack_bits(planes), "cpu")


@pytest.mark.parametrize("R,S,inert_share,seed", [
    (1, 5, 0.0, 0), (1, 33, 0.2, 1), (3, 12, 0.3, 2), (2, 40, 0.5, 3)])
def test_plain_superstep_over_grouped_matches_step_core(R, S, inert_share,
                                                        seed):
    """The kernel's plain version over the grouped layout, each row its
    own tables, against the JAX package's ``_step_core`` row by row on
    numpy inputs from a seed: unsorted subjects, inert-label edges (a
    zero table row) and repeated edges.  The JAX visited holds the
    frontier; the port's ``v`` may too (``v | f`` is the same)."""
    rng = np.random.default_rng(seed)
    V, E, L = 35, 160, 5
    subj = rng.integers(0, V, E).astype(np.int32)
    obj = rng.integers(0, V, E).astype(np.int32)
    pred = rng.integers(0, L, E).astype(np.int32)
    pred[rng.random(E) < inert_share] = L
    subj[:10], pred[:10], obj[:10] = subj[10:20], pred[10:20], obj[10:20]
    B = _planes(rng, (R, L + 1, S), 0.5)
    B[:, L] = 0
    PRED = _planes(rng, (R, S, S), 0.3)
    front = _planes(rng, (R, V, S), 0.2)
    vis = front | _planes(rng, (R, V, S), 0.3)
    edges = Edges.build(*(torch.from_numpy(a) for a in (subj, pred, obj)),
                        V, L)
    f, v = _words(front), _words(vis)
    nxt, spare = torch.zeros_like(f), torch.ones_like(f)
    flag = torch.zeros(1, dtype=torch.int32)
    ops.packed_superstep(f, v, nxt, spare, flag, 1, _words(B), _words(PRED),
                         edges.grouped, new_scratch(edges.grouped, R))
    found = False
    for r in range(R):
        new, visited = _step_core(jnp.asarray(subj), jnp.asarray(pred),
                                  jnp.asarray(obj), jnp.asarray(B[r]),
                                  jnp.asarray(PRED[r]), jnp.asarray(front[r]),
                                  jnp.asarray(vis[r]), V)
        np.testing.assert_array_equal(
            ops.unpack_bits(ops.tensor_to_words(nxt[r]), S), np.asarray(new))
        np.testing.assert_array_equal(
            ops.unpack_bits(ops.tensor_to_words(v[r] | nxt[r]), S),
            np.asarray(visited))
        found |= bool(np.asarray(new).any())
    assert found
    assert int(flag[0]) == 1 and not bool(spare.any())


@pytest.mark.parametrize("shards", [2, 3])
def test_plain_superstep_over_grouped_matches_local_bfs_step(shards):
    """One shard's superstep: the plain version over the shard's grouped
    device copy (padding dropped, objects over the gathered V_pad rows)
    against the reference's ``_local_bfs_step`` on the same gathered
    frontier, shard by shard."""
    rng = np.random.default_rng(shards)
    g = rfix.random_graph(26, 3, 90, seed=shards + 7)
    dg = RDenseGraph.from_graph(g)
    sg = rdist.ShardedGraph.from_dense(dg, shards)
    Vl, Vp, L, S = sg.nodes_per_shard, sg.num_nodes_padded, dg.num_labels, 9
    B = _planes(rng, (L + 1, S), 0.5)
    B[L] = 0
    PRED = _planes(rng, (S, S), 0.4)
    front = _planes(rng, (Vp, S), 0.3)
    front[g.num_nodes:] = 0
    vis = front | _planes(rng, (Vp, S), 0.2)
    for k in range(shards):
        rows = slice(k * Vl, (k + 1) * Vl)
        ids = [getattr(sg, a)[k] for a in ("subj_local", "pred", "obj")]
        new, visited = rdist._local_bfs_step(
            jnp.asarray(front), jnp.asarray(front[rows]),
            jnp.asarray(vis[rows]), *(jnp.asarray(a) for a in ids),
            jnp.asarray(B), jnp.asarray(PRED), None)
        edges = Edges.build(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in ids), Vp, L)
        assert edges.grouped.subj.numel() < ids[0].size or \
            not (ids[1] == L).any()
        f, v = _words(front[rows])[None], _words(vis[rows])[None]
        nxt = torch.zeros_like(f)
        flag = torch.zeros(1, dtype=torch.int32)
        ops.packed_superstep(f, v, nxt, torch.zeros_like(f), flag, 1,
                             _words(B)[None], _words(PRED)[None],
                             edges.grouped,
                             new_scratch(edges.grouped, 1),
                             gathered=_words(front)[None])
        np.testing.assert_array_equal(
            ops.unpack_bits(ops.tensor_to_words(nxt[0]), S), np.asarray(new))
        np.testing.assert_array_equal(
            ops.unpack_bits(ops.tensor_to_words((v | nxt)[0]), S),
            np.asarray(visited))


def test_stepper_slot_answers_from_its_pinned_layout():
    """A ``DenseStepper`` slot admitted before a mutation reads the
    layout of its admission epoch to the end, and answers that epoch's
    question; a slot admitted after it answers the new epoch."""
    g = rfix.random_graph(30, 2, 90, seed=11)
    pg = convert.graph_from_reference(g)
    eng = PDense(pg, device="cpu")
    expr, start = "0/1*", 4
    want0 = {s for s, _o in eval_oracle(pg, expr, None, start)}
    stepper = eng.make_stepper()
    plan = eng._plan(prx.parse(expr))
    old = stepper.add_job(plan, start)
    pinned = old.edges
    assert pinned is eng.dg.edges
    stepper.step()                          # one superstep before the update
    triples = [(int(g.s[k]), int(g.p[k]), int(g.o[k]))
               for k in range(g.s.shape[0]) if int(g.p[k]) in (0, 1)]
    eng.remove_edges(triples[: len(triples) // 2])
    eng.add_edges([(start, 0, 7), (7, 1, 9)])
    assert eng._edges() is not pinned and old.edges is pinned
    new = stepper.add_job(plan, start)
    assert new.edges is eng._edges()
    while stepper.step():
        pass
    want1 = {s for s, _o in eval_oracle(eng.effective_graph(), expr, None,
                                        start)}
    assert want0 != want1
    assert stepper.reported(old) == want0
    assert stepper.reported(new) == want1
