"""Mesh-sharded execution for both RPQ engines, on PyTorch devices.

The JAX package's ``core/distributed.py`` with its device side rewritten.
The engines dispatch into it when built with ``make_engine(graph, ...,
mesh=...)`` or ``shards=N``:

  * :class:`Mesh` and :func:`resolve_mesh` — an array of
    ``torch.device``s with axis names, and the engine knobs
    (``mesh=``/``shards=``/``data_axes=``/``model_axis=``) turned into a
    mesh plus the data axes the wavefront is partitioned over;
  * :class:`ShardedGraph` — edges range-partitioned by the owner of their
    backward-push destination (the subject), padded to equal per-shard
    length (the JAX package's numpy, as it is);
  * :func:`make_task_shard_step` — the ring engine's sharded wavefront
    transition: a superstep's merged task list is range-split over the
    data shards, each shard steps its slice through ``ops.nfa_step`` on
    its device, and the results are gathered (disjoint ranges, so the
    gather IS the mask-OR);
  * :func:`shard_superstep` — one superstep of the dense engine on every
    shard, on ``ops.packed_superstep`` over the gathered frontier;
  * :func:`make_superstep` / :func:`make_superstep_batched` /
    :func:`make_bfs` — the JAX package's sharded supersteps and its
    fixed-trip-count BFS (the one the dry run lowers), with its int8
    planes in and out: the planes are packed to words once, every
    superstep is :func:`shard_superstep`, and the words are unpacked
    once at the end;
  * :class:`ShardedDenseExec` — the dense engine's sharded executor:
    ``dense.superstep_loop`` (the unsharded loop, deadline-checked between
    chunks) over those supersteps and per-shard edges, used by ``_run_from`` / ``_run_from_batched`` /
    ``_run_hetero_rows`` so every planner shape and ``eval_many`` bucket
    runs sharded.

One process drives the whole mesh, as in the JAX package: the host
traversal runs once and only the supersteps are spread over the devices.
A shard is its own set of tensors, whichever device holds it, so a mesh
may name one device more than once (the CPU tests run 8 shards on the
host, as the JAX package's tests run a forced 8-device host mesh).
Shards on other devices are reached by ``Tensor.copy_``, and the
all-gather is those copies.

Sharding design (as in the JAX package):
  * graph nodes are range-partitioned over the data axes — shard k owns
    nodes [k*Vl, (k+1)*Vl);
  * edges live with the *owner of their backward-push destination* (the
    subject), so scatter-OR updates are always shard-local;
  * each superstep all-gathers the frontier words (the only collective)
    and runs gather -> Fact-1 mask -> transition -> scatter-OR locally.

``model_axis`` splits each shard's edges over the model axis.  The
shard's state is replicated there, as the JAX package replicates the
frontier over the model axis: each model replica runs its edges into its
own buffers (``(a | b) & ~v == (a & ~v) | (b & ~v)``, so each and-nots
against the same visited words), and the replicas' new frontiers are
ORed together after the launches.

Results are bit-identical to the single-device engines: the superstep
computes exactly the same monotone visited fixpoint, only partitioned.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.packed_superstep import new_scratch
from ..obs import trace as otrace
from .dense import Edges, superstep_loop
from .stats import host_array


class Mesh:
    """Devices on named axes: ``devices`` an object ndarray of
    ``torch.device``s (strings are accepted), one array axis per name.
    A device may appear more than once."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not arr.size:
            raise ValueError(f"a mesh of shape {arr.shape} needs one name "
                             f"per axis, got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def resolve_mesh(
    mesh: Optional[Mesh] = None,
    shards: Optional[int] = None,
    data_axes: Optional[Sequence[str]] = None,
    model_axis: Optional[str] = None,
    device=None,
) -> Tuple[Optional[Mesh], Tuple[str, ...]]:
    """Resolve the engine sharding knobs into (mesh, data_axes).

    ``mesh=`` wins; ``shards=N`` builds a 1-D ``("data",)`` mesh over the
    first N visible devices of ``device``'s kind (every CUDA card, or the
    one host); an explicit mesh must name devices of that kind only.
    ``data_axes`` defaults to every mesh axis except
    ``model_axis``.  Returns ``(None, ())`` when sharding is off.
    """
    if mesh is None and shards is None:
        return None, ()
    kind = ops.resolve_device(device).type
    if mesh is None:
        if model_axis is not None:
            raise ValueError(
                "model_axis requires an explicit mesh= containing that "
                "axis; shards=N builds a 1-D ('data',) mesh")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())] \
            if kind == "cuda" else [torch.device(kind)]
        if not 1 <= shards <= len(devs):
            raise ValueError(
                f"shards={shards} but only {len(devs)} devices are visible "
                "(pass mesh=Mesh([...], ('data',)) to name a device more "
                "than once)")
        mesh = Mesh(devs[:shards], ("data",))
    other = sorted({str(d) for d in mesh.devices.flat if d.type != kind})
    if other:
        raise ValueError(
            f"the mesh names {other} but the engine runs on {kind}: a "
            "shard's supersteps run on its mesh device")
    if model_axis is not None and model_axis not in mesh.axis_names:
        raise ValueError(
            f"model_axis={model_axis!r} is not an axis of the mesh "
            f"(axes: {mesh.axis_names})")
    if data_axes is None:
        data_axes = tuple(a for a in mesh.axis_names if a != model_axis)
    return mesh, tuple(data_axes)


def shard_devices(mesh: Mesh, data_axes: Sequence[str],
                  model_axis: Optional[str] = None
                  ) -> List[List[torch.device]]:
    """``out[k][j]``: the device of data shard k, model shard j.  Data
    shards run over the data axes in row-major order, the first axis
    major (as a ``PartitionSpec`` of several axes splits a dimension);
    an axis that is neither data nor model replicates, and its first
    device holds the shard."""
    names = mesh.axis_names
    sizes = [mesh.shape[a] for a in data_axes]
    M = mesh.shape[model_axis] if model_axis is not None else 1
    out = []
    for k in range(int(np.prod(sizes)) if sizes else 1):
        idx = [0] * len(names)
        for a, c in zip(data_axes, np.unravel_index(k, sizes) if sizes
                        else ()):
            idx[names.index(a)] = int(c)
        row = []
        for j in range(M):
            if model_axis is not None:
                idx[names.index(model_axis)] = j
            row.append(mesh.devices[tuple(idx)])
        out.append(row)
    return out


def _edge_arrays(dg) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(subj, pred, obj) on the host: a port ``DenseGraph``'s ``host``
    copy, else the object's own arrays (numpy, tensors or jax arrays)."""
    host = getattr(dg, "host", None)
    return tuple(host_array(a) for a in
                 (host if host is not None else (dg.subj, dg.pred, dg.obj)))


@dataclass
class ShardedGraph:
    """Edges partitioned by destination(subject)-owner, padded to equal
    per-shard length.  Padding edges carry the reserved label
    ``num_labels`` whose table row is all-zero — they contribute nothing.
    ``pad_multiple`` rounds the per-shard edge count up so a model-axis
    split divides evenly."""

    subj_local: np.ndarray  # [shards, E_max] int32 (owner-local row ids)
    pred: np.ndarray        # [shards, E_max] int32 (padded: num_labels)
    obj: np.ndarray         # [shards, E_max] int32 (global node ids)
    nodes_per_shard: int
    num_shards: int
    num_nodes_padded: int
    num_labels: int

    @classmethod
    def from_dense(cls, dg, num_shards: int,
                   pad_multiple: int = 1) -> "ShardedGraph":
        V = dg.num_nodes
        Vl = -(-V // num_shards)
        Vp = Vl * num_shards
        subj, pred, obj = _edge_arrays(dg)
        owner = subj // Vl
        emax = max(1, int(np.bincount(owner, minlength=num_shards).max()))
        emax = -(-emax // pad_multiple) * pad_multiple
        sl = np.zeros((num_shards, emax), dtype=np.int32)
        pr = np.full((num_shards, emax), dg.num_labels, dtype=np.int32)
        ob = np.zeros((num_shards, emax), dtype=np.int32)
        for k in range(num_shards):
            sel = owner == k
            cnt = int(sel.sum())
            sl[k, :cnt] = subj[sel] - k * Vl
            pr[k, :cnt] = pred[sel]
            ob[k, :cnt] = obj[sel]
        return cls(
            subj_local=sl, pred=pr, obj=ob,
            nodes_per_shard=Vl, num_shards=num_shards,
            num_nodes_padded=Vp, num_labels=dg.num_labels,
        )


def make_task_shard_step(mesh: Mesh, data_axes: Tuple[str, ...]):
    """Sharded wavefront transition for the ring engine.

    Returns ``step(X, bwd)``: the merged superstep task list ``X``
    ([n * per, W] uint32 words, already label-masked — Fact 1 happens
    upstream; ``n`` the data shards) is range-split, shard k runs
    ``ops.nfa_step`` on its ``per`` rows on its device with ``bwd[device]``
    (the packed table's copy there), and the per-shard results are
    gathered onto the first shard's device and returned as uint32 words.
    The shard ranges are disjoint, so the gather is exactly the mask-OR
    merge.  ``step.devices`` lists the shards' devices."""
    devices = [row[0] for row in shard_devices(mesh, data_axes)]

    def step(X: np.ndarray, bwd: Dict[torch.device, torch.Tensor]
             ) -> np.ndarray:
        per = X.shape[0] // len(devices)
        parts = [ops.nfa_step(ops.words_to_tensor(X[k * per:(k + 1) * per],
                                                  dev), bwd[dev])
                 for k, dev in enumerate(devices)]
        # the all-gather: every shard's rows onto the first shard's device
        return ops.tensor_to_words(torch.cat([p.to(devices[0])
                                              for p in parts]))

    step.devices = devices
    return step


class _Replica:
    """One shard's BFS state on its device: three rotating frontier
    buffers and the visited words, [R, Vl, W] int32 each, the shard's
    edges (an :class:`~repro_torch.core.dense.Edges`, subj local, grouped
    over the gathered frontier's rows) and the superstep scratch of this
    BFS."""

    __slots__ = ("k", "j", "device", "bufs", "v", "edges", "scratch")

    def __init__(self, k: int, j: int, device, start: torch.Tensor,
                 edges: Edges, visited: Optional[torch.Tensor] = None):
        self.k, self.j, self.device, self.edges = k, j, device, edges
        f = start.to(device, copy=True).contiguous()
        self.bufs = [f, torch.zeros_like(f), torch.zeros_like(f)]
        self.v = torch.zeros_like(f) if visited is None \
            else visited.to(device, copy=True).contiguous()
        self.scratch = new_scratch(edges.grouped, f.shape[0])


def shard_superstep(replicas: Sequence[_Replica],
                    gathered: Dict[torch.device, torch.Tensor],
                    flags: Dict[torch.device, torch.Tensor],
                    tables: Dict[torch.device, Tuple[torch.Tensor,
                                                     torch.Tensor]],
                    n: int, nodes_per_shard: int) -> int:
    """Superstep ``n`` (stamp ``n + 1``) on every shard; returns the bytes
    the all-gather copied.

    The all-gather copies each data shard's frontier (model replica 0's
    ``bufs[n % 3]``) into its rows of ``gathered[device]`` [R, V_pad, W],
    one buffer per distinct device; with flags on several devices, each
    takes their maximum first, so a launch stops only when no shard found
    a word.  Each replica then launches ``ops.packed_superstep`` over the
    gathered frontier with its edges, into its own buffers; the shards of
    one device share its flag.  Model replicas of a data shard finally OR
    their new frontiers together (each has and-notted against the same
    visited words)."""
    Vl = nodes_per_shard
    if len(flags) > 1:
        home = next(iter(flags))
        top = torch.cat([f.to(home) for f in flags.values()]).max()
        for f in flags.values():
            f.copy_(top.reshape(1))
    owners = [r for r in replicas if r.j == 0]
    moved = 0
    for dev, G in gathered.items():
        for r in owners:
            G[:, r.k * Vl:(r.k + 1) * Vl].copy_(r.bufs[n % 3])
        moved += G.numel() * G.element_size()
    for r in replicas:
        f, nxt, spare = (r.bufs[(n + d) % 3] for d in range(3))
        B, P = tables[r.device]
        ops.packed_superstep(f, r.v, nxt, spare, flags[r.device], n + 1, B,
                             P, r.edges.grouped, r.scratch,
                             gathered=gathered[r.device])
    for owner in owners:
        peers = [r for r in replicas if r.k == owner.k and r.j > 0]
        if not peers:
            continue
        nxt = owner.bufs[(n + 1) % 3]
        for r in peers:
            nxt |= r.bufs[(n + 1) % 3].to(owner.device)
        for r in peers:
            r.bufs[(n + 1) % 3].copy_(nxt)
    return moved


def _as_tensor(a, device=None) -> torch.Tensor:
    """A tensor (kept where it is unless ``device`` is given), or numpy /
    any array the ``__array__`` protocol reads, on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t if device is None else t.to(device)


class _PlaneBFS:
    """The JAX package's sharded BFS state over a mesh, as the port runs
    it: R rows of int8 planes packed to int32 words once, one
    :class:`_Replica` a (data shard, model shard) with its block of the
    shard's edges grouped over the gathered frontier's rows, one
    gathered buffer and one flag a device, and the tables a device.
    ``run(k)`` runs ``k`` supersteps through :func:`shard_superstep`;
    ``planes()`` unpacks the JAX package's ``(frontier, visited)``.

    The JAX package's visited holds its frontier; the kernel's trails it
    by a superstep (it ORs the frontier in first), so its ``(f, v)`` is
    the reference's ``(f, v | f)``.  That is exact when the starting
    frontier lies within the starting visited, as every engine of both
    packages starts a BFS (visited = the start frontier), and is
    checked."""

    def __init__(self, mesh: Mesh, data_axes: Tuple[str, ...],
                 model_axis: Optional[str], frontier, visited, subj, pred,
                 obj, B, PRED):
        self.devs = shard_devices(mesh, data_axes, model_axis)
        home = self.devs[0][0]
        f = _as_tensor(frontier)
        self.out_device = f.device if isinstance(frontier, torch.Tensor) \
            else home
        f, v = f.to(home), _as_tensor(visited, home)
        if f.shape != v.shape or f.dim() != 3:
            raise ValueError(f"frontier {tuple(f.shape)} and visited "
                             f"{tuple(v.shape)} must be equal [R, V_pad, S]")
        R, Vp, S = f.shape
        self.S = S
        n, M = len(self.devs), len(self.devs[0])
        if Vp % n:
            raise ValueError(f"{Vp} rows do not split over {n} shards")
        if bool(((f != 0) & (v == 0)).any()):
            raise ValueError("the frontier must lie within visited (the "
                             "JAX package's engines start a BFS with "
                             "visited = frontier)")
        Bt, Pt = _as_tensor(B, home), _as_tensor(PRED, home)
        if Bt.dim() != 3 or Pt.shape != (R, S, S) or Bt.shape[0] != R or \
                Bt.shape[2] != S:
            raise ValueError(f"tables {tuple(Bt.shape)}, {tuple(Pt.shape)} "
                             f"do not fit planes of {S} states, {R} rows")
        L = Bt.shape[1] - 1            # row L: the inert label
        if bool(Bt[:, L].any()):
            raise ValueError("the inert label's row B[L] must be all zero "
                             "(padding edges carry it)")
        self.Vl = Vp // n
        words = ops.planes_to_words(f)
        seen = ops.planes_to_words(v)
        del f, v
        # bwd row s is the packed word of PRED[s, :]: Y = OR of the rows
        # X selects, the reference's X @ PRED > 0
        Bp, bwd = ops.planes_to_words(Bt), ops.planes_to_words(Pt)
        edges = [_as_tensor(a) for a in (subj, pred, obj)]
        if any(e.dim() != 2 or e.shape != edges[0].shape for e in edges) \
                or edges[0].shape[0] != n:
            raise ValueError(f"edge arrays must be [{n}, E_max], got "
                             f"{[tuple(e.shape) for e in edges]}")
        if edges[0].shape[1] % M:
            raise ValueError(f"E_max {edges[0].shape[1]} does not split "
                             f"over {M} model shards")
        Em = edges[0].shape[1] // M
        self.devices = list(dict.fromkeys(d for row in self.devs
                                          for d in row))
        self.tables = {d: (Bp.to(d).contiguous(), bwd.to(d).contiguous())
                       for d in self.devices}
        self.replicas = []
        for k, row in enumerate(self.devs):
            sl = slice(k * self.Vl, (k + 1) * self.Vl)
            for j, dev in enumerate(row):
                block = [e[k, j * Em:(j + 1) * Em].to(dev, torch.int32)
                         .contiguous() for e in edges]
                self.replicas.append(_Replica(
                    k, j, dev, words[:, sl],
                    Edges.build(*block, Vp, L), seen[:, sl]))
        self.gathered = {d: torch.empty((R, Vp, words.shape[2]),
                                        dtype=torch.int32, device=d)
                         for d in self.devices}
        self.flags = {d: torch.zeros(1, dtype=torch.int32, device=d)
                      for d in self.devices}
        self.it = 0                    # supersteps queued so far
        self.gather_bytes = 0

    def run(self, k: int, on_step: Optional[Callable] = None) -> None:
        """Queue ``k`` supersteps (no flag read); ``on_step(n, self)``
        after superstep ``n``, if given."""
        for n in range(self.it, self.it + k):
            self.gather_bytes += shard_superstep(
                self.replicas, self.gathered, self.flags, self.tables, n,
                self.Vl)
            self.it = n + 1
            if on_step is not None:
                on_step(n, self)

    def _buffer_after(self, n: int) -> int:
        """The rotation's buffer holding the frontier after superstep
        ``n`` (-1: the start).  The flag holds the stamp F of the last
        superstep that found a word; superstep F ran and found nothing,
        and the ones after it changed nothing, not even the spare
        buffer, so a later buffer may still hold an older frontier: after
        superstep ``n >= F`` the frontier is superstep F's output (zero),
        as ``dense.superstep_loop`` counts.  Reads the flags (a sync)."""
        last = max(int(f.item()) for f in self.flags.values())
        return (min(n, last) + 1) % 3

    def frontier_words(self, n: int) -> List[torch.Tensor]:
        """Each data shard's frontier words after superstep ``n``."""
        b = self._buffer_after(n)
        return [r.bufs[b] for r in self.replicas if r.j == 0]

    def planes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(frontier, visited)`` int8 [R, V_pad, S] on the output
        device, after the supersteps queued so far."""
        dev = self.out_device
        f = torch.cat([w.to(dev) for w in self.frontier_words(self.it - 1)],
                      dim=1)
        v = torch.cat([r.v.to(dev) for r in self.replicas if r.j == 0],
                      dim=1) | f
        return (ops.words_to_planes(f, self.S),
                ops.words_to_planes(v, self.S))


def make_superstep(mesh: Mesh, data_axes: Tuple[str, ...], S: int,
                   model_axis: Optional[str] = None) -> Callable:
    """The JAX package's sharded superstep (one shared plane set):
    ``step(frontier, visited, subj, pred, obj, B, PRED) -> (frontier,
    visited)``.  frontier/visited int8 [V_pad, S], node rows split over
    ``data_axes``; edge arrays [shards, E_max] int32 (``ShardedGraph``'s:
    subj owner-local, padding on the inert label L), E_max split over
    ``model_axis`` when given; B [L+1, S] and PRED [S, S] int8,
    replicated (arrays or tensors).  Returns int8 tensors on the
    frontier's device (the first shard's for an array).  Each call packs
    the planes, groups each shard's edges and runs one
    :func:`shard_superstep`; the model replicas' frontiers are ORed (the
    JAX package's psum of 0/1 counts)."""
    batched = make_superstep_batched(mesh, data_axes, model_axis)

    def step(frontier, visited, subj, pred, obj, B, PRED):
        f, v = batched(_as_tensor(frontier)[None], _as_tensor(visited)[None],
                       subj, pred, obj, _as_tensor(B)[None],
                       _as_tensor(PRED)[None])
        if f.shape[2] != S:
            raise ValueError(f"planes of {f.shape[2]} states, not {S}")
        return f[0], v[0]

    return step


def make_superstep_batched(mesh: Mesh, data_axes: Tuple[str, ...],
                           model_axis: Optional[str] = None) -> Callable:
    """The JAX package's batched sharded superstep: row r of the leading
    axis runs its own tables.  ``step(frontier, visited, subj, pred,
    obj, Bstk, PREDstk)``: frontier/visited int8 [R, V_pad, S] (the node
    axis over ``data_axes``), edges as :func:`make_superstep`'s, Bstk
    [R, L+1, S] and PREDstk [R, S, S] replicated.  A call is
    ``step.build`` (the :class:`_PlaneBFS`: planes packed, edges
    grouped), its ``run(1)`` and its ``planes()``."""

    def build(frontier, visited, subj, pred, obj, Bstk, PREDstk):
        return _PlaneBFS(mesh, tuple(data_axes), model_axis, frontier,
                         visited, subj, pred, obj, Bstk, PREDstk)

    def step(frontier, visited, subj, pred, obj, Bstk, PREDstk):
        bfs = build(frontier, visited, subj, pred, obj, Bstk, PREDstk)
        bfs.run(1)
        return bfs.planes()

    step.build = build
    return step


def make_bfs(mesh: Mesh, data_axes: Tuple[str, ...], S: int,
             num_steps: int) -> Callable:
    """The JAX package's fixed-trip-count BFS (the one its dry run
    lowers): ``run(frontier, visited, subj, pred, obj, B, PRED) ->
    (frontier, visited)`` after exactly ``num_steps`` supersteps of
    :func:`make_superstep` (no early exit: a superstep after convergence
    leaves every plane as it is).  The planes are packed once, the
    shards' edges grouped once, and the words unpacked once; the
    supersteps read no flag between them.  ``run.last`` keeps the
    :class:`_PlaneBFS` of the last call (its replicas, gather bytes and
    flags); ``on_step(n, bfs)``, if given, is called after superstep
    ``n`` (``bfs.frontier_words(n)`` are the shards' new frontiers)."""

    def run(frontier, visited, subj, pred, obj, B, PRED, on_step=None):
        bfs = _PlaneBFS(mesh, tuple(data_axes), None,
                        _as_tensor(frontier)[None],
                        _as_tensor(visited)[None], subj, pred, obj,
                        _as_tensor(B)[None], _as_tensor(PRED)[None])
        if bfs.S != S:
            raise ValueError(f"planes of {bfs.S} states, not {S}")
        run.last = bfs
        bfs.run(num_steps, on_step)
        f, v = bfs.planes()
        return f[0], v[0]

    run.last = None
    return run


class ShardedDenseExec:
    """The dense engine's sharded executor.

    Holds the per-shard edges on their devices and drives
    :func:`shard_superstep` through ``dense.superstep_loop``, the loop of
    ``dense.bfs_rows``: it reads the flags once a chunk, which is also
    where per-query/batch deadlines are enforced (``TimeoutError``, the
    same signal the ring engine raises).
    ``run_rows`` is the single entry point of ``eval``/``eval_many``:
    row r of the batch runs its own tables, so the same loop serves the
    single-plan, multi-source and heterogeneous shapes.  ``step_rows``
    is the slot scheduler's: a few supersteps of its slots' rows from
    their frontier and visited words, over the edge shards of their
    epoch (``slot_dispatches`` counts them apart from ``dispatches``).
    ``gather_bytes`` counts the bytes the all-gathers copied.
    """

    def __init__(self, dg, mesh: Mesh,
                 data_axes: Tuple[str, ...] = ("data",),
                 model_axis: Optional[str] = None):
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.model_axis = model_axis
        self.num_shards = int(np.prod([mesh.shape[a] for a in data_axes]))
        self._pad_multiple = int(mesh.shape[model_axis]) if model_axis else 1
        self.num_nodes = dg.num_nodes
        self.num_labels = dg.num_labels
        self.dispatches = 0      # sharded superstep-loop launches
        self.supersteps = 0      # total supersteps across all launches
        self.edge_refreshes = 0  # live-update edge re-partitions
        self.slot_dispatches = 0  # step_rows calls (slot scheduler ticks)
        self.gather_bytes = 0    # bytes copied by the frontier all-gathers
        self._table_cache: dict = {}  # table_key -> {device: (B, PRED)}
        self.shard_devices = shard_devices(mesh, self.data_axes, model_axis)
        self.devices = list(dict.fromkeys(d for row in self.shard_devices
                                          for d in row))
        self.refresh_edges(dg)

    def refresh_edges(self, dg) -> None:
        """(Re)partition the edge arrays over the mesh — called at build
        and after every live-update mutation batch, with ``dg`` any
        object carrying effective ``subj``/``pred``/``obj`` arrays (base
        edges with tombstones relabeled inert, delta rows appended).
        Node count and label alphabet are fixed between rebuilds, so the
        row partition and tables are untouched; only the per-shard edge
        arrays (and their padded length) change.  Model shard j of a data
        shard takes the j-th equal block of its edges.  Each block's
        device copy is grouped by object over the gathered frontier's
        V_pad rows there, which drops the inert padding and tombstones
        (the host partition keeps the JAX package's layout)."""
        self.sg = ShardedGraph.from_dense(dg, self.num_shards,
                                          pad_multiple=self._pad_multiple)
        Em = self.sg.subj_local.shape[1] // self._pad_multiple
        self._edges = [
            [Edges.build(*(torch.from_numpy(np.ascontiguousarray(
                a[k, j * Em:(j + 1) * Em])).to(dev)
                for a in (self.sg.subj_local, self.sg.pred, self.sg.obj)),
                self.sg.num_nodes_padded, self.num_labels)
             for j, dev in enumerate(row)]
            for k, row in enumerate(self.shard_devices)]
        self.edge_refreshes += 1

    def pad_nodes(self, words: torch.Tensor) -> torch.Tensor:
        """[R, V, W] start words -> [R, V_pad, W] (trailing zero rows)."""
        Vp = self.sg.num_nodes_padded
        if words.shape[1] == Vp:
            return words
        out = words.new_zeros((words.shape[0], Vp, words.shape[2]))
        out[:, : words.shape[1]] = words
        return out

    def _pad_tables(self, Bstk: torch.Tensor) -> torch.Tensor:
        """[R, L, W] label tables -> [R, L+1, W]: append the all-zero row
        of the reserved inert label, so padding (and tombstoned) edges
        match nothing.  Plan tables built by ``dense._plane_tables``
        already carry the inert row — those pass through unchanged."""
        R, L, W = Bstk.shape
        if L == self.num_labels + 1:
            return Bstk
        return torch.cat([Bstk, Bstk.new_zeros((R, 1, W))], dim=1)

    def _tables(self, Bstk, PREDstk, table_key):
        cached = self._table_cache.get(table_key) if table_key is not None \
            else None
        if cached is None:
            B = self._pad_tables(Bstk)
            cached = {d: (B.to(d).contiguous(), PREDstk.to(d).contiguous())
                      for d in self.devices}
            if table_key is not None:
                self._table_cache[table_key] = cached
                while len(self._table_cache) > 32:
                    self._table_cache.pop(next(iter(self._table_cache)))
        return cached

    def run_rows(
        self,
        Bstk: torch.Tensor,     # [R, L(+1), W] int32 per-row label tables
        PREDstk: torch.Tensor,  # [R, S, W] int32 per-row transition tables
        start: torch.Tensor,    # [R, V or V_pad, W] int32 start words
        max_steps: int,
        deadline: Optional[float] = None,
        table_key=None,
    ) -> Tuple[torch.Tensor, int]:
        """Run the sharded BFS to convergence (or ``max_steps``).

        Returns (visited [R, V, W] int32 words on ``start``'s device,
        supersteps).  Raises ``TimeoutError`` when ``deadline`` (absolute
        ``time.time()`` seconds) has passed before a chunk.
        ``table_key`` (hashable; hold a strong reference, e.g. the plan
        object itself) memoizes the tables' device copies so repeated
        runs of the same plan stack skip the transfer.
        """
        self.dispatches += 1
        visited, _frontier, it = self._run(Bstk, PREDstk, start, max_steps,
                                           deadline, table_key)
        self.supersteps += it
        return visited, it

    def step_rows(self, Bstk: torch.Tensor, PREDstk: torch.Tensor,
                  frontier: torch.Tensor, max_steps: int,
                  visited: torch.Tensor, edges
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Up to ``max_steps`` supersteps of R slot rows from their
        ``frontier`` and ``visited`` [R, V, W] words over ``edges`` (the
        per-shard rows of the slots' epoch): ``dense.bfs_rows``'s
        contract — (visited with the frontier, frontier, supersteps)."""
        self.slot_dispatches += 1
        return self._run(Bstk, PREDstk, frontier, max_steps, None, None,
                         visited, edges)

    def _run(self, Bstk, PREDstk, start, max_steps, deadline, table_key,
             visited=None, edges=None):
        words = self.pad_nodes(start)
        R, Vp, W = words.shape
        Vl = self.sg.nodes_per_shard
        edges = self._edges if edges is None else edges
        seen = None if visited is None else self.pad_nodes(visited)
        tables = self._tables(Bstk, PREDstk, table_key)
        replicas = [_Replica(k, j, dev, words[:, k * Vl:(k + 1) * Vl],
                             edges[k][j], None if seen is None
                             else seen[:, k * Vl:(k + 1) * Vl])
                    for k, row in enumerate(self.shard_devices)
                    for j, dev in enumerate(row)]
        gathered = {d: torch.empty((R, Vp, W), dtype=torch.int32, device=d)
                    for d in self.devices}
        flags = {d: torch.zeros(1, dtype=torch.int32, device=d)
                 for d in self.devices}

        def chunk(it: int, k: int) -> int:
            with otrace.span("dense.sharded_chunk", cat="kernel", steps=k,
                             shards=self.num_shards, rows=R):
                for n in range(it, it + k):
                    self.gather_bytes += shard_superstep(
                        replicas, gathered, flags, tables, n, Vl)
                return max(int(f.item()) for f in flags.values())

        it = superstep_loop(chunk, max_steps if bool(words.any()) else 0,
                            deadline)
        owners = [r for r in replicas if r.j == 0]
        frontier = torch.cat([r.bufs[it % 3].to(start.device)
                              for r in owners], dim=1)
        visited = torch.cat([r.v.to(start.device) for r in owners], dim=1)
        V = self.num_nodes
        return (visited | frontier)[:, :V], frontier[:, :V], it
