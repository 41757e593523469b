"""The port's mesh-sharded engines against the JAX package's, on the CPU.

The JAX package's sharded path needs ``shard_map(..., check_vma=False)``
on the installed jax (its ``_shard_map`` passes ``check_rep``), so every
reference call here is taken with ``repro.core.distributed._shard_map``
replaced by one that passes ``check_vma=False``: through ``monkeypatch``
in this process, or by assignment inside the subprocesses that force an
8-device host mesh (``XLA_FLAGS`` must be set before ``jax`` is
imported; ``tests/test_engines.py:255`` is the model).  No file of the
JAX package changes.

The port's meshes name the host device repeatedly: a shard is its own
set of tensors.  Held exactly: answers (equal to the reference's sharded
and unsharded engines, the port's unsharded engine and the oracle),
``QueryStats`` fields, ``sharded.dispatches``/``supersteps``/
``edge_refreshes``, ``sharded_kernel_batches``, ``hetero_dispatches``,
retraces, ANALYZE's sharding and collective sections, across the planner
shapes, heterogeneous ``eval_many``, ``limit`` and live updates with
``compact()`` at every epoch.
"""
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as rdist  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from repro.core.dense import DenseGraph as RDenseGraph  # noqa: E402
from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.engines import make_engine as rmake  # noqa: E402
from repro.core.oracle import eval_oracle  # noqa: E402
from repro.core.rpq import QueryStats as RStats  # noqa: E402
from repro.core.scheduler import SlotScheduler as RSched  # noqa: E402
from repro.obs import explain as rexplain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed as pdist  # noqa: E402
from repro_torch.core.dense import DenseGraph as PDenseGraph  # noqa: E402
from repro_torch.core.engines import Query as PQuery  # noqa: E402
from repro_torch.core.engines import make_engine as pmake  # noqa: E402
from repro_torch.core.rpq import QueryStats as PStats  # noqa: E402
from repro_torch.core.scheduler import SlotScheduler as PSched  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import explain as pexplain  # noqa: E402
from torch_parity import COUNTERS, DENSE_FIELDS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPRS = ["0/1*", "2+", "(0|1)/2", "^1/0*"]
CASES = [(None, None), (None, 3), (5, None), (5, 3)]
POLICIES = ("forward", "reverse", "split", "cost")


def _ref_shard_map(f, mesh, in_specs, out_specs):
    """The reference's ``_shard_map`` with ``check_vma=False``."""
    return rdist._resolve_shard_map()(f, mesh=mesh, in_specs=in_specs,
                                      out_specs=out_specs, check_vma=False)


@pytest.fixture
def ref_sharded(monkeypatch):
    monkeypatch.setattr(rdist, "_shard_map", _ref_shard_map)


# -- the layouts: (reference mesh knobs, port mesh knobs) ----------------------

def _layout(name):
    """Engine knobs of both packages for one layout: ``"1"`` (shards=1 on
    both), ``"3"`` / ``"8"`` (a 1-D data mesh), ``"4x2"`` (data x model,
    the dense engine's edge split)."""
    if name == "1":
        return {"shards": 1}, {"shards": 1}
    import jax
    from jax.sharding import Mesh as RMesh
    if name == "4x2":
        rm = RMesh(np.array(jax.devices()[:8]).reshape(4, 2),
                   ("data", "model"))
        pm = pdist.Mesh([["cpu"] * 2] * 4, ("data", "model"))
        return ({"mesh": rm, "model_axis": "model"},
                {"mesh": pm, "model_axis": "model"})
    n = int(name)
    return ({"mesh": RMesh(np.array(jax.devices()[:n]), ("data",))},
            {"mesh": pdist.Mesh(["cpu"] * n, ("data",))})


def _engines(g, kind, layout, **kw):
    """(reference sharded, port sharded, reference unsharded, port
    unsharded) engines of ``kind`` over ``g``."""
    rk, pk = _layout(layout)
    if kind == "ring":
        kw = {"kernel_threshold": 1, **kw}
    pg = convert.graph_from_reference(g)
    return (rmake(g, kind, **rk, **kw),
            pmake(pg, kind, device="cpu", **pk, **kw),
            rmake(g, kind, **kw), pmake(pg, kind, device="cpu", **kw))


def _check_eval(engs, g, kind, expr, s, o):
    rs, ps = RStats(), PStats()
    ref, port, rbase, pbase = engs
    want = ref.eval(expr, s, o, stats=rs)
    got = port.eval(expr, s, o, stats=ps)
    assert got == want == rbase.eval(expr, s, o) == pbase.eval(expr, s, o) \
        == eval_oracle(g, expr, s, o), (kind, expr, s, o)
    for f in (DENSE_FIELDS if kind == "dense" else COUNTERS + ("retraces",
                                                              "plan_mode")):
        assert getattr(ps, f) == getattr(rs, f), (kind, expr, s, o, f)


def _check_counters(ref, port, kind):
    assert port.traces.retraces == ref.traces.retraces, kind
    if kind == "dense":
        for f in ("dispatches", "supersteps", "edge_refreshes", "num_shards"):
            assert getattr(port.sharded, f) == getattr(ref.sharded, f), f
        assert port.sharded.dispatches > 0
        assert port.hetero_dispatches == ref.hetero_dispatches
        assert port._superstep_acc == ref._superstep_acc
    else:
        assert port.sharded_kernel_batches == ref.sharded_kernel_batches > 0
        assert port.bundle_kernel_batches == ref.bundle_kernel_batches
        assert port._num_shards == ref._num_shards


def _check_eval_many(engs, g, queries):
    ref, port, rbase, pbase = engs
    want = ref.eval_many([RQuery(*q) for q in queries])
    got = port.eval_many([PQuery(*q) for q in queries])
    assert got == want == rbase.eval_many([RQuery(*q) for q in queries]) \
        == pbase.eval_many([PQuery(*q) for q in queries])
    for q, res in zip(queries, got):
        full = eval_oracle(g, *q[:3])
        assert res == (set(sorted(full)[:q[3]]) if len(q) > 3 else full), q


def _check_analyze(ref, port, q):
    """ANALYZE on both sharded engines: plan, sharding and collective
    sections, answers, and the timeline's kernel columns."""
    want, want_res = rexplain.analyze_query(ref, RQuery(*q))
    got, got_res = pexplain.analyze_query(port, PQuery(*q))
    pexplain.validate_report(got)
    assert got_res == want_res
    for sec in ("plan", "automaton", "sharding", "collective"):
        assert got[sec] == want[sec], sec
    keys = ("superstep", "frontier", "activations", "tasks",
            "kernel_dispatches", "shards", "skew_ratio")
    assert [{k: r[k] for k in keys} for r in got["execution"]["timeline"]] \
        == [{k: r[k] for k in keys} for r in want["execution"]["timeline"]]


def layout_parity(layout: str, kinds=("dense", "ring")) -> None:
    """Every check of one layout, both engines (the model-axis layout
    runs the dense engine only: the ring has no model axis)."""
    g = rfix.random_graph(30, 4, 120, seed=9)
    rnd = random.Random(int(layout[0]))
    for kind in kinds:
        for policy in POLICIES:
            engs = _engines(g, kind, layout, planner=policy)
            for expr in EXPRS:
                for s, o in CASES:
                    _check_eval(engs, g, kind, expr, s, o)
            _check_counters(engs[0], engs[1], kind)
        # heterogeneous eval_many buckets, limit, a duplicate
        engs = _engines(g, kind, layout)
        qs = [(e, None, o) for e in EXPRS for o in range(3)]
        qs += [(e, 1, None, 2) for e in EXPRS] + [(EXPRS[0], None, None)]
        qs += [(rnd.choice(EXPRS), rnd.randrange(30), rnd.randrange(30))
               for _ in range(6)] + [qs[0]]
        _check_eval_many(engs, g, qs)
        _check_counters(engs[0], engs[1], kind)
        _check_analyze(engs[0], engs[1], ("0/1*", None, 3))
        _check_analyze(engs[0], engs[1], ("(0|1)/2", 5, None))
        # live updates, one pair compacting after every mutation batch
        engs_c = _engines(g, kind, layout)
        for step in range(3):
            adds = [(rnd.randrange(30), rnd.randrange(4), rnd.randrange(30))
                    for _ in range(4)]
            rems = [(int(g.s[step]), int(g.p[step]), int(g.o[step]))]
            for eng in engs + engs_c:
                eng.add_edges(adds)
                eng.remove_edges(rems)
            engs_c[0].compact()
            engs_c[1].compact()
            eff = engs[0].effective_graph()
            for pair in (engs, engs_c):
                assert pair[1].epoch == pair[0].epoch == step * 2 + 2
                for expr in EXPRS[:3]:
                    for s, o in CASES:
                        _check_eval(pair, eff, kind, expr, s, o)
                _check_eval_many(pair, eff, [(e, None, 2) for e in EXPRS])
                _check_counters(pair[0], pair[1], kind)
        assert engs_c[1].compactions == engs_c[0].compactions == 3
    print("LAYOUT_OK", layout)


# -- the partition and one shard superstep -------------------------------------

@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("pad_multiple", [1, 2])
def test_sharded_graph_partition_matches_reference(n, pad_multiple):
    g = rfix.random_graph(29, 3, 90, seed=n)
    want = rdist.ShardedGraph.from_dense(RDenseGraph.from_graph(g), n,
                                         pad_multiple=pad_multiple)
    got = pdist.ShardedGraph.from_dense(
        PDenseGraph.from_graph(convert.graph_from_reference(g), "cpu"), n,
        pad_multiple=pad_multiple)
    for f in ("subj_local", "pred", "obj"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("nodes_per_shard", "num_shards", "num_nodes_padded",
              "num_labels"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("model_split", [1, 2])
def test_shard_superstep_matches_local_bfs_step(model_split):
    """One superstep on every shard of 3 (``shard_superstep`` over the
    plain version, each data shard's edges split over ``model_split``
    replicas) against the reference's ``_local_bfs_step`` on the same
    gathered frontier, visited planes and tables (the model split under
    a ``vmap`` whose axis name carries its psum): new frontier and
    visited words equal bit for bit."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(model_split)
    g = rfix.random_graph(20, 3, 70, seed=4)
    dg = RDenseGraph.from_graph(g)
    n, S, L = 3, 5, dg.num_labels
    sg = rdist.ShardedGraph.from_dense(dg, n, pad_multiple=model_split)
    Vl, Vp = sg.nodes_per_shard, sg.num_nodes_padded
    B = (rng.random((L + 1, S)) < 0.5).astype(np.int8)
    B[L] = 0                                          # the inert label
    PRED = (rng.random((S, S)) < 0.4).astype(np.int8)
    front = (rng.random((Vp, S)) < 0.3).astype(np.int8)
    front[g.num_nodes:] = 0
    vis = front | (rng.random((Vp, S)) < 0.3).astype(np.int8)
    Em = sg.subj_local.shape[1] // model_split

    want_new, want_vis = [], []
    for k in range(n):
        rows = slice(k * Vl, (k + 1) * Vl)
        parts = [np.stack([a[k, j * Em:(j + 1) * Em]
                           for j in range(model_split)])
                 for a in (sg.subj_local, sg.pred, sg.obj)]
        step = jax.vmap(
            lambda s_, p_, o_: rdist._local_bfs_step(
                jnp.asarray(front), jnp.asarray(front[rows]),
                jnp.asarray(vis[rows]), s_, p_, o_, jnp.asarray(B),
                jnp.asarray(PRED), "model"), axis_name="model")
        new, v = step(*(jnp.asarray(p) for p in parts))
        want_new.append(np.asarray(new[0]))
        want_vis.append(np.asarray(v[0]))

    words = lambda planes: ops.words_to_tensor(ops.pack_bits(planes), "cpu")
    mesh = pdist.Mesh([["cpu"] * model_split] * n, ("data", "model"))
    ex = pdist.ShardedDenseExec(
        PDenseGraph.from_graph(convert.graph_from_reference(g), "cpu"), mesh,
        ("data",), "model" if model_split > 1 else None)
    reps = [pdist._Replica(k, j, torch.device("cpu"),
                           words(front[k * Vl:(k + 1) * Vl])[None],
                           ex._edges[k][j])
            for k in range(n) for j in range(model_split)]
    for r in reps:
        r.v = words(vis[r.k * Vl:(r.k + 1) * Vl])[None]
    dev = torch.device("cpu")
    gathered = {dev: torch.zeros((1, Vp, 1), dtype=torch.int32)}
    flags = {dev: torch.zeros(1, dtype=torch.int32)}
    tables = {dev: (words(B)[None], words(PRED)[None])}
    moved = pdist.shard_superstep(reps, gathered, flags, tables, 0, Vl)
    assert moved == Vp * 4
    assert torch.equal(gathered[dev][0], words(front))
    for r in reps:
        new = ops.tensor_to_words(r.bufs[1][0])
        np.testing.assert_array_equal(new, ops.pack_bits(want_new[r.k]))
        np.testing.assert_array_equal(
            ops.tensor_to_words((r.v | r.bufs[1])[0]),
            ops.pack_bits(want_vis[r.k]))
        assert not r.bufs[2].any()                   # the spare is cleared
    assert int(flags[dev]) == int(any(a.any() for a in want_new))


def test_mesh_and_resolve_mesh():
    m = pdist.Mesh([["cpu"] * 2] * 4, ("data", "model"))
    assert m.shape == {"data": 4, "model": 2}
    assert m.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    mesh, axes = pdist.resolve_mesh(m, model_axis="model", device="cpu")
    assert mesh is m and axes == ("data",)
    assert pdist.resolve_mesh() == (None, ())
    mesh, axes = pdist.resolve_mesh(shards=1, device="cpu")
    assert mesh.shape == {"data": 1} and axes == ("data",)
    with pytest.raises(ValueError, match="devices are visible"):
        pdist.resolve_mesh(shards=2, device="cpu")
    with pytest.raises(ValueError, match="explicit mesh"):
        pdist.resolve_mesh(shards=1, model_axis="model", device="cpu")
    with pytest.raises(ValueError, match="not an axis"):
        pdist.resolve_mesh(m, model_axis="pipe", device="cpu")
    with pytest.raises(ValueError, match="one name"):
        pdist.Mesh(["cpu"] * 2, ("data", "model"))


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_mesh_of_another_device_kind_raises(kind):
    """An explicit mesh whose devices are not of the engine's device kind
    is refused: its shards would run where the engine does not."""
    with pytest.raises(ValueError, match="engine runs on cpu"):
        pdist.resolve_mesh(pdist.Mesh(["cpu", "cuda:0"], ("data",)),
                           device="cpu")
    g = convert.graph_from_reference(rfix.scale_free_graph(40, 3, 120,
                                                           seed=1))
    with pytest.raises(ValueError, match=r"\['cuda:0'\]"):
        pmake(g, kind, device="cpu",
              mesh=pdist.Mesh(["cuda:0"] * 2, ("data",)))
    devs = pdist.shard_devices(pdist.Mesh([["cpu"] * 2] * 3, ("pod", "data")),
                               ("pod", "data"))
    assert len(devs) == 6 and all(len(r) == 1 for r in devs)


# -- the engines -----------------------------------------------------------------

def test_engines_on_one_shard_match_reference(ref_sharded):
    """shards=1 on both packages, in this process."""
    layout_parity("1")


MESH_LAYOUTS = ("3", "8", "4x2")


@pytest.fixture(scope="module", autouse=True)
def mesh_runs():
    """The layouts' subprocesses, started with the module's first test
    so they run beside it and each other; what is left is stopped at
    the end."""
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"),
                                          os.path.join(ROOT, "tests")])}
    runs = {}
    for name in MESH_LAYOUTS:
        kinds = ("dense",) if name == "4x2" else ("dense", "ring")
        code = ("import test_torch_distributed as t\n"
                "t.rdist._shard_map = t._ref_shard_map\n"
                f"t.layout_parity({name!r}, {kinds!r})\n")
        runs[name] = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield runs
    for proc in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_engines_on_meshes_match_reference_subprocess(mesh_runs, layout):
    """Meshes of 3 and 8 host shards (both engines) and 4x2 data x model
    (the dense engine), each against the reference on a forced 8-device
    host mesh in its own subprocess."""
    proc = mesh_runs[layout]
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert f"LAYOUT_OK {layout}" in out, out + err[-6000:]


def _script(rnd, V, P, n):
    """A random interleaving of submits, ticks and live updates."""
    out = []
    for _ in range(n):
        r = rnd.random()
        if r < 0.45:
            e = rnd.choice(EXPRS)
            v, w = rnd.randrange(V), rnd.randrange(V)
            out.append(("submit", [(e, None, v), (e, v, None), (e, v, w),
                                   (e, None, None)][rnd.randrange(4)]))
        elif r < 0.6:
            out.append(("update", [(rnd.randrange(V), rnd.randrange(P),
                                    rnd.randrange(V)) for _ in range(2)],
                        [(rnd.randrange(V), rnd.randrange(P),
                          rnd.randrange(V))]))
        else:
            out.append(("step",))
    return out


@pytest.mark.parametrize("kind,seed", [("dense", 0), ("dense", 1),
                                       ("ring", 2), ("ring", 3)])
def test_scheduler_over_sharded_engine_matches_reference(ref_sharded, kind,
                                                         seed):
    """A random interleaving of submits, ticks and live updates on slot
    schedulers over the reference's sharded engine (shards=1) and the
    port's on a mesh of 3 host shards: every ticket's answer and epoch
    agree with each other and with the oracle at the admission epoch;
    the engines' counters agree."""
    rnd = random.Random(seed)
    g = rfix.random_graph(14, 3, 45, seed=seed + 7, pred_zipf=False)
    kw = {"kernel_threshold": 1} if kind == "ring" else {}
    ref = rmake(g, kind, shards=1, **kw)
    port = pmake(convert.graph_from_reference(g), kind, device="cpu",
                 mesh=pdist.Mesh(["cpu"] * 3, ("data",)), **kw)
    rs, ps = RSched(ref, max_slots=3), PSched(port, max_slots=3)
    snapshots = {0: ref.effective_graph()}
    tickets = []
    for op in _script(rnd, g.num_nodes, g.num_preds, 24):
        if op[0] == "submit":
            tickets.append((op[1], rs.submit(RQuery(*op[1])),
                            ps.submit(PQuery(*op[1]))))
        elif op[0] == "update":
            ep = rs.submit_update(add=op[1], remove=op[2])
            assert ps.submit_update(add=op[1], remove=op[2]) == ep
            snapshots[ep] = ref.effective_graph()
        else:
            assert ps.step() == rs.step()
    rs.drain()
    ps.drain()
    for q, rt, pt in tickets:
        assert pt.epoch == rt.epoch
        assert pt.result() == rt.result() == eval_oracle(snapshots[pt.epoch],
                                                         *q)
    assert ps.admitted == rs.admitted and ps.completed == rs.completed
    if kind == "dense":
        assert port.hetero_dispatches == ref.hetero_dispatches
        assert port._superstep_acc == ref._superstep_acc
        assert port.sharded.dispatches == ref.sharded.dispatches
        assert port.sharded.edge_refreshes == ref.sharded.edge_refreshes
    else:
        assert port.sharded_kernel_batches == ref.sharded_kernel_batches
        assert port.bundle_kernel_batches == ref.bundle_kernel_batches


def test_deadline_on_sharded_dense_engine():
    """A sharded dense engine honours a batch deadline (TimeoutError) and
    answers equal to the unsharded engine under a generous one."""
    g = rfix.random_graph(30, 3, 100, seed=3)
    pg = convert.graph_from_reference(g)
    shd = pmake(pg, "dense", device="cpu",
                mesh=pdist.Mesh(["cpu"] * 4, ("data",)))
    base = pmake(pg, "dense", device="cpu")
    qs = [PQuery(e, obj=o) for e in EXPRS for o in range(4)]
    assert shd.eval_many(qs, deadline_s=60.0) == base.eval_many(qs)
    shd.results.clear()
    with pytest.raises(TimeoutError):
        shd.eval_many(qs, deadline_s=1e-9)


@pytest.mark.parametrize("names,shape,model_axis", [
    (("data",), (4,), None), (("data", "model"), (2, 2), "model")])
def test_scheduler_slots_step_on_the_mesh(names, shape, model_axis):
    """A ``SlotScheduler`` over a sharded dense engine steps its slots on
    the mesh (``step_rows``, counted apart from ``eval``'s dispatches),
    admits, preempts between ticks and releases them, and answers at
    each ticket's epoch as the JAX dense engine's ``eval_many`` and the
    oracle do, across a live update."""
    g = rfix.random_graph(30, 3, 100, seed=4)
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = ["cpu"] * devices.size
    port = pmake(convert.graph_from_reference(g), "dense", device="cpu",
                 mesh=pdist.Mesh(devices.reshape(shape), names),
                 model_axis=model_axis)
    clk = [0.0]
    sched = PSched(port, max_slots=3, clock=lambda: clk[0])
    qs = [PQuery(e, obj=o) for e in EXPRS for o in (1, 7)]
    doomed = sched.submit(PQuery("(0|1|2)*", obj=5), deadline_s=1.0)
    tickets = [sched.submit(q) for q in qs[: len(qs) // 2]]
    sched.step()
    assert doomed.state == "running" and port.sharded.slot_dispatches == 1
    clk[0] = 2.0
    snapshots = {0: port.effective_graph()}
    ep = sched.submit_update(add=[(1, 0, 7), (2, 1, 1)], remove=[(3, 2, 1)])
    snapshots[ep] = port.effective_graph()
    tickets += [sched.submit(q) for q in qs[len(qs) // 2:]]
    sched.drain()
    with pytest.raises(TimeoutError):
        doomed.result()
    assert sched.preempted == 1 and sched.in_flight == 0
    assert port.sharded.dispatches == 0 and port.sharded.slot_dispatches > 1
    assert {t.epoch for t in tickets} == {0, ep}
    for q, t in zip(qs, tickets):
        snap = snapshots[t.epoch]
        want = rmake(snap, "dense").eval_many(
            [RQuery(q.expr, q.subject, q.obj)])[0]
        assert t.result() == want == eval_oracle(snap, q.expr, q.subject,
                                                 q.obj), (q, t.epoch)


@pytest.mark.parametrize("kind,devices,names,model_axis", [
    ("ring", ["cpu", "cpu:0", "cpu", "cpu:0"], ("data",), None),
    ("dense", ["cpu", "cpu:0", "cpu"], ("data",), None),
    ("dense", [["cpu", "cpu:0"], ["cpu:0", "cpu"]], ("data", "model"),
     "model")])
def test_engines_on_meshes_of_several_devices(kind, devices, names,
                                              model_axis):
    """``cpu`` and ``cpu:0`` are two devices to a mesh (one tensor
    memory): the paths for shards on several devices run — one gathered
    frontier and one flag a device, the flags' maximum taken each
    superstep, model replicas ORed across devices — and answer as the
    unsharded engine, before and after a live update."""
    g = convert.graph_from_reference(rfix.random_graph(40, 4, 160, seed=2))
    kw = {"kernel_threshold": 1} if kind == "ring" else {}
    host = pmake(g, kind, device="cpu", **kw)
    if model_axis:
        kw["model_axis"] = model_axis
    shd = pmake(g, kind, device="cpu", mesh=pdist.Mesh(devices, names), **kw)
    if kind == "dense":
        assert len(shd.sharded.devices) == 2
    qs = [PQuery(e, obj=o) for e in EXPRS for o in (0, 7, 33)] + \
        [PQuery(e, subject=s) for e in EXPRS for s in (3, 21)]
    assert shd.eval_many(qs) == host.eval_many(qs)
    for eng in (shd, host):
        eng.add_edges([(1, 0, 2), (2, 1, 3), (30, 2, 0)])
        eng.results.clear()
    assert shd.eval_many(qs) == host.eval_many(qs)
    for q in qs[:4]:
        assert shd.eval(q.expr, q.subject, q.obj) == \
            eval_oracle(shd.effective_graph(), q.expr, q.subject, q.obj)
