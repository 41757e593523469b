"""The port's ``make_superstep``, ``make_superstep_batched`` and
``make_bfs`` against the JAX package's, on the CPU.

The reference runs on a one-device JAX mesh, with
``repro.core.distributed._shard_map`` replaced by its ``check_vma=False``
form (``tests/test_torch_distributed.py`` does the same; no file of the
JAX package changes).  The port runs on ``Mesh(["cpu"] * 4, ("data",))``
and on a 2 x 2 mesh with ``model_axis="model"``, each with its own edge
partition (``ShardedGraph.from_dense`` for its shard count); the int8
planes of the first V rows (the padding rows stay zero on both) must be
bit-identical after every superstep, and after ``num_steps`` supersteps,
past convergence too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import distributed as rdist  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from repro.core.dense import DenseGraph as RDenseGraph  # noqa: E402
from repro.core.dense import _plane_tables, _start_row  # noqa: E402
from repro.core.glushkov import build as rbuild  # noqa: E402
from repro_torch.core import distributed as pdist  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

EXPRS = ("0/1*", "(0|2)+/1", "^1/(0|3)*")


@pytest.fixture
def ref_sharded(monkeypatch):
    def shard_map(f, mesh, in_specs, out_specs):
        return rdist._resolve_shard_map()(f, mesh=mesh, in_specs=in_specs,
                                          out_specs=out_specs,
                                          check_vma=False)
    monkeypatch.setattr(rdist, "_shard_map", shard_map)


def _ref_mesh():
    from jax.sharding import Mesh as RMesh
    return RMesh(np.array(jax.devices()[:1]), ("data",))


def _port_layouts():
    """(mesh, model_axis, data shards, model shards) of the port."""
    return [(pdist.Mesh(["cpu"] * 4, ("data",)), None, 4, 1),
            (pdist.Mesh([["cpu"] * 2] * 2, ("data", "model")), "model", 2,
             2)]


def _graph(seed):
    return rfix.random_graph(37, 4, 150, seed=seed)


def _problem(g, expr, starts):
    """The reference's tables and start planes of ``expr`` over ``g``'s
    completed edges: (dense graph, B [L+1, S], PRED [S, S], start
    [V, S])."""
    dg = RDenseGraph.from_graph(g)
    gl = rbuild(expr, g.resolve_lit)
    B, PRED, _F = _plane_tables(gl, dg.num_labels)
    start = np.zeros((g.num_nodes, gl.m + 1), dtype=np.int8)
    start[np.asarray(starts)] = _start_row(gl)
    return dg, np.asarray(B), np.asarray(PRED), start


def _pad(planes, Vp):
    out = np.zeros((Vp,) + planes.shape[1:], dtype=np.int8)
    out[:planes.shape[0]] = planes
    return out


def _edges(sg):
    return sg.subj_local, sg.pred, sg.obj


@pytest.mark.parametrize("expr", EXPRS)
def test_make_superstep_every_step(ref_sharded, expr):
    g = _graph(3)
    dg, B, PRED, start = _problem(g, expr, [0, 5, 11])
    S, V = B.shape[1], g.num_nodes
    rsg = rdist.ShardedGraph.from_dense(dg, 1)
    rstep = jax.jit(rdist.make_superstep(_ref_mesh(), ("data",), S))
    ports = []
    for mesh, model_axis, n, m in _port_layouts():
        sg = rdist.ShardedGraph.from_dense(dg, n, pad_multiple=m)
        step = pdist.make_superstep(mesh, tuple(a for a in mesh.axis_names
                                                if a != model_axis), S,
                                    model_axis=model_axis)
        ports.append((step, sg))
    f = v = _pad(start, rsg.num_nodes_padded)
    for _ in range(V * S):
        rf, rv = (np.asarray(a) for a in rstep(f, v, *_edges(rsg), B, PRED))
        for step, sg in ports:
            Vp = sg.num_nodes_padded
            pf, pv = step(_pad(f[:V], Vp), _pad(v[:V], Vp), *_edges(sg), B,
                          PRED)
            assert pf.dtype == pv.dtype == torch.int8
            np.testing.assert_array_equal(pf.numpy()[:V], rf[:V])
            np.testing.assert_array_equal(pv.numpy()[:V], rv[:V])
            assert not pf.numpy()[V:].any() and not pv.numpy()[V:].any()
        f, v = rf, rv
        if not f.any():
            break
    else:
        pytest.fail("the BFS did not converge")


def test_make_superstep_batched_rows_own_tables(ref_sharded):
    g = _graph(5)
    problems = [_problem(g, e, s) for e, s in
                zip(EXPRS, ([1, 2], [7], [0, 30, 36]))]
    dg = problems[0][0]
    S = max(p[1].shape[1] for p in problems)
    L1 = problems[0][1].shape[0]

    def widen(a, shape):
        out = np.zeros(shape, dtype=np.int8)
        out[tuple(slice(0, d) for d in a.shape)] = a
        return out

    Bstk = np.stack([widen(p[1], (L1, S)) for p in problems])
    Pstk = np.stack([widen(p[2], (S, S)) for p in problems])
    start = np.stack([widen(p[3], (g.num_nodes, S)) for p in problems])
    V = g.num_nodes
    rsg = rdist.ShardedGraph.from_dense(dg, 1)
    rstep = jax.jit(rdist.make_superstep_batched(_ref_mesh(), ("data",)))
    f = v = np.stack([_pad(s, rsg.num_nodes_padded) for s in start])
    for _ in range(6):
        rf, rv = (np.asarray(a) for a in rstep(f, v, *_edges(rsg), Bstk,
                                                Pstk))
        for mesh, model_axis, n, m in _port_layouts():
            sg = rdist.ShardedGraph.from_dense(dg, n, pad_multiple=m)
            step = pdist.make_superstep_batched(
                mesh, tuple(a for a in mesh.axis_names if a != model_axis),
                model_axis=model_axis)
            Vp = sg.num_nodes_padded
            pf, pv = step(np.stack([_pad(x[:V], Vp) for x in f]),
                          np.stack([_pad(x[:V], Vp) for x in v]),
                          *_edges(sg), torch.from_numpy(Bstk),
                          torch.from_numpy(Pstk))
            np.testing.assert_array_equal(pf.numpy()[:, :V], rf[:, :V])
            np.testing.assert_array_equal(pv.numpy()[:, :V], rv[:, :V])
        f, v = rf, rv


@pytest.mark.parametrize("num_steps", [1, 2, 5, 40])
def test_make_bfs_fixed_trip_count(ref_sharded, num_steps):
    """40 supersteps run far past convergence (the frontier empties in a
    few): every later superstep leaves the planes as they are, whatever
    buffer of the rotation the trip count ends on."""
    g = _graph(11)
    dg, B, PRED, start = _problem(g, "(0|1|2)/3*", [4, 9])
    S, V = B.shape[1], g.num_nodes
    rsg = rdist.ShardedGraph.from_dense(dg, 1)
    rrun = rdist.make_bfs(_ref_mesh(), ("data",), S, num_steps)
    s0 = _pad(start, rsg.num_nodes_padded)
    rf, rv = (np.asarray(a) for a in rrun(s0, s0, *_edges(rsg), B, PRED))
    mesh = pdist.Mesh(["cpu"] * 4, ("data",))
    sg = rdist.ShardedGraph.from_dense(dg, 4)
    run = pdist.make_bfs(mesh, ("data",), S, num_steps)
    p0 = torch.from_numpy(_pad(start, sg.num_nodes_padded))
    pf, pv = run(p0, p0, *(torch.from_numpy(a) for a in _edges(sg)),
                 torch.tensor(B), torch.tensor(PRED))
    np.testing.assert_array_equal(pf.numpy()[:V], rf[:V])
    np.testing.assert_array_equal(pv.numpy()[:V], rv[:V])
    assert run.last.it == num_steps
    if num_steps == 40:
        assert not rf.any() and rv.sum() > start.sum()


def test_make_bfs_past_convergence_every_rotation(ref_sharded):
    """The trip counts 1 .. 7 each end on some buffer of the three-way
    rotation, before and after the BFS converges (a stale buffer may
    hold an older frontier once it has); all must give the reference's
    planes, and a hook must see each superstep's frontier."""
    g = rfix.metro_graph()
    dg, B, PRED, start = _problem(g, "0*", [0])
    S, V = B.shape[1], g.num_nodes
    rsg = rdist.ShardedGraph.from_dense(dg, 1)
    sg = rdist.ShardedGraph.from_dense(dg, 4)
    s0 = _pad(start, rsg.num_nodes_padded)
    mesh = pdist.Mesh(["cpu"] * 4, ("data",))
    p0 = _pad(start, sg.num_nodes_padded)
    seen = []     # the frontier after each superstep of one 7-step run

    def on_step(n, bfs):
        words = torch.cat(bfs.frontier_words(n), dim=1)
        seen.append(ops.words_to_planes(words, S).numpy()[0])

    pdist.make_bfs(mesh, ("data",), S, 7)(p0, p0, *_edges(sg), B, PRED,
                                          on_step=on_step)
    for k in range(1, 8):
        rf, rv = (np.asarray(a) for a in rdist.make_bfs(
            _ref_mesh(), ("data",), S, k)(s0, s0, *_edges(rsg), B, PRED))
        pf, pv = pdist.make_bfs(mesh, ("data",), S, k)(
            p0, p0, *_edges(sg), B, PRED)
        np.testing.assert_array_equal(pf.numpy()[:V], rf[:V], err_msg=k)
        np.testing.assert_array_equal(pv.numpy()[:V], rv[:V], err_msg=k)
        np.testing.assert_array_equal(seen[k - 1][:V], rf[:V], err_msg=k)
    assert not seen[-1].any() and seen[0].any()


def test_make_bfs_refuses_what_it_cannot_match():
    mesh = pdist.Mesh(["cpu"] * 2, ("data",))
    S = 3
    f = np.zeros((4, S), np.int8)
    f[1, 1] = 1
    e = np.zeros((2, 2), np.int32)
    B = np.zeros((3, S), np.int8)
    P = np.zeros((S, S), np.int8)
    run = pdist.make_bfs(mesh, ("data",), S, 2)
    with pytest.raises(ValueError, match="within visited"):
        run(f, np.zeros_like(f), e, e, e, B, P)
    B[2, 0] = 1
    with pytest.raises(ValueError, match="inert"):
        run(f, f, e, e, e, B, P)


def test_planes_and_words_round_trip():
    rng = np.random.default_rng(0)
    for S in (1, 16, 32, 33, 70):
        p = rng.integers(0, 2, (3, 9, S)).astype(np.int8)
        w = ops.planes_to_words(torch.from_numpy(p))
        np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                      ops.pack_bits(p))
        np.testing.assert_array_equal(ops.words_to_planes(w, S).numpy(), p)
