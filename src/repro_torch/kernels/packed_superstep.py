"""One superstep of R packed BFS runs, driven by the live frontier: the
CUDA kernel's wrapper, its plain version, its launch counter, and the
object-grouped edge layout it reads.

For frontier ``f`` and visited ``v`` ([R, V, W] int32 words, a BFS a
row), one call does for every row r

    v[r] |= f[r]
    nxt[r] |= segment_or(nfa_step(g[r][obj] & Bp[r][pred], bwd[r]),
                         subj, V) & ~v[r]
    spare[r][:] = 0
    flag[0] = stamp, if that OR put a non-zero word into some nxt[r]

in place, ``nxt`` zero on entry; the edges ``(subj, pred, obj)`` are
shared by every row, each row has its own tables (its own automaton).
``g`` ([R, Vg, W], the frontier that ``obj`` indexes) is ``f`` itself
unless the caller passes ``gathered``: on a mesh (:mod:`repro_torch.core.
distributed`) it is the frontier gathered over every shard, ``f`` the
shard's own ``V`` rows of it and ``subj`` local to them.  So ``v``
trails the frontier by one superstep and the caller rotates three
frontier buffers: this superstep's ``nxt`` is the next one's frontier,
and its ``spare`` (the frontier before this one) the next one's ``nxt``.
The JAX package's loop state ``(f, v)`` is ``(f, v | f)`` here.

The flag holds the stamp of the last superstep that found a word, so a
caller may queue supersteps ``it + 1 .. it + k`` before it reads it: a
call made while ``flag[0] < stamp - 1`` follows a superstep that found
nothing (every frontier is empty) and changes nothing at all.  A first
superstep takes stamp 1 with the flag at 0.

The edges come as a :class:`GroupedEdges` (:func:`group_by_object`),
built once per edge epoch: grouped by object, inert-label edges dropped.
The kernel scans the frontier for live (row, object) pairs and expands
only their edges, through a worklist in a :class:`SuperstepScratch`
(:func:`new_scratch`) that the caller allocates once per BFS.  The
kernel is ``csrc/packed_superstep.cu`` (see the note there for what
bounds it); :mod:`repro_torch.core.dense` drives it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build
from .ref import packed_superstep_ref

# launches of the CUDA kernel (a superstep's two launches count once)
# since the last reset (see ``repro_torch.kernels.reset_launch_counts``)
launches = {"packed_superstep": 0}

# edges a worklist entry covers at most: a warp's lanes take one edge
# each from a run of 8 entries, so one run is at most 8 warp-wide steps
TILE = 32
_INT32_MAX = 2**31 - 1


@dataclass(frozen=True, eq=False)
class GroupedEdges:
    """Edges grouped by object: those of object o are ``subj[offsets[o]:
    offsets[o + 1]]`` and ``pred[...]``, ascending by subject within the
    group.  ``tiles`` is the sum over objects of ceil(degree / TILE),
    the worklist entries one row can need."""

    offsets: torch.Tensor    # [num_objects + 1] int32
    subj: torch.Tensor       # [E'] int32
    pred: torch.Tensor       # [E'] int32
    num_objects: int
    tiles: int

    @property
    def device(self) -> torch.device:
        return self.subj.device

    def objects(self) -> torch.Tensor:
        """[E'] int32: the object of each edge (its group's id)."""
        degree = self.offsets[1:] - self.offsets[:-1]
        return torch.repeat_interleave(
            torch.arange(self.num_objects, dtype=torch.int32,
                         device=self.device), degree)


def group_by_object(subj: torch.Tensor, pred: torch.Tensor,
                    obj: torch.Tensor, num_objects: int,
                    inert_label: int) -> GroupedEdges:
    """Group [E] int32 edges by object, on their device.  Edges labelled
    ``inert_label`` (tombstones and padding: their table row is zero) and
    those whose object is outside [0, num_objects) select nothing and are
    dropped; the rest sort by (object, subject).  Layout-building calls
    (a stable sort of one int64 key, ``bincount``, ``cumsum``) and one
    host read of the tile count."""
    if not subj.shape == pred.shape == obj.shape or subj.dim() != 1:
        raise ValueError("group_by_object wants three [E] id arrays")
    keep = (pred != inert_label) & (obj >= 0) & (obj < num_objects)
    s, p, o = subj[keep], pred[keep], obj[keep].to(torch.int64)
    if s.numel() > _INT32_MAX:
        raise ValueError(f"{s.numel()} edges do not fit int32 offsets")
    # the object in the high half of an int64 sort key, the subject below
    key = (o << 32) | (s.to(torch.int64) & 0xFFFFFFFF)  # repro: noqa B002
    order = torch.sort(key, stable=True).indices
    degree = torch.bincount(o, minlength=num_objects)
    offsets = torch.zeros(num_objects + 1, dtype=torch.int64,
                          device=subj.device)
    torch.cumsum(degree, 0, out=offsets[1:])
    tiles = int(((degree + TILE - 1) // TILE).sum())
    return GroupedEdges(offsets=offsets.to(torch.int32),
                        subj=s[order].to(torch.int32).contiguous(),
                        pred=p[order].to(torch.int32).contiguous(),
                        num_objects=num_objects, tiles=tiles)


@dataclass(frozen=True, eq=False)
class SuperstepScratch:
    """The kernel's worklist ([capacity, 2] int32 entries: first edge,
    row * Vg + object) and its three rotating counters (zero when a BFS
    starts).  One per BFS (per shard on a mesh), reused by its
    supersteps."""

    work: torch.Tensor       # [capacity, 2] int32
    counters: torch.Tensor   # [3] int32


def new_scratch(layout: GroupedEdges, rows: int) -> SuperstepScratch:
    """Scratch for supersteps of ``rows`` rows over ``layout``, on its
    device: room for ``rows * layout.tiles`` entries, which no superstep
    exceeds."""
    cap = rows * layout.tiles
    if cap > _INT32_MAX:
        raise ValueError(f"a worklist of {cap} entries overflows int32")
    dev = layout.device
    return SuperstepScratch(
        work=torch.empty((cap, 2), dtype=torch.int32, device=dev),
        counters=torch.zeros(3, dtype=torch.int32, device=dev))


# -- byte models ---------------------------------------------------------------

def set_bits_below(X: torch.Tensor, S: int) -> int:
    """Set bits of [N, W] int32 words ``X`` at positions below ``S``."""
    from .ref import popcount, widen
    x = widen(X[:, :(S + 31) // 32])
    if S & 31:
        x[:, -1] &= (1 << (S & 31)) - 1
    return int(popcount(x).sum()) if x.numel() else 0


def _edge_pass(R: int, V: int, W: int, E: int, L: int, S: int,
               remote_objects: int, live_f: int, live_y: int, targets: int,
               written: int, frontier_words: int, set_bits: int):
    """The edge pass's ``(bytes, operations)`` from its counts (see
    :func:`edge_pass_cost`)."""
    n_bytes = (4 * E + 8 * R * V * W + 4 * R * W * remote_objects
               + 4 * (live_f + live_y + targets + written)
               + 8 * frontier_words + 4 * R * (L + S) * W)
    return n_bytes, set_bits * W


def edge_pass_cost(f, v, Bp, bwd, subj, pred, obj, gathered=None):
    """``(bytes, operations)`` one edge pass (the kernel before the
    grouped layout: a thread an edge) of R rows ([R, V, W] state,
    [R, L, W] and [R, S, W] tables) must move and do, from these inputs:
    every edge's obj once and every frontier word (4*E + 4*R*V*W); the
    pred of each edge whose frontier word below S is non-zero in some
    row and the subj of each edge whose transition is non-zero in some
    row (4 each); at each word a row's transition reaches, v read (4)
    and, where the mask leaves bits, nxt written (4); at each non-zero
    frontier word v read and written (8); spare written (4*R*V*W); the
    tables once.  Operations: W ORs per set bit of X below S, over the
    rows.  A shard's superstep (``gathered`` [R, V_pad, W], the frontier
    gathered over the mesh; the state and ``subj`` local) also reads the
    gathered words at its edges' distinct objects (4*R*W each), and its
    state terms are over its own V rows.  :func:`edge_pass_cost_all_live`
    is the same formula with every count at its most."""
    from .ref import nfa_step_ref, segment_or_ref
    E = obj.shape[0]
    (R, V, W), S, L = f.shape, bwd.shape[1], Bp.shape[1]
    g = f if gathered is None else gathered
    live_f = torch.zeros(E, dtype=torch.bool, device=f.device)
    live_y = torch.zeros_like(live_f)
    targets = written = set_bits = 0
    for r in range(R):
        fo = g[r].index_select(0, obj)
        live_f |= (fo[:, :(S + 31) // 32] != 0).any(1)
        X = fo & Bp[r].index_select(0, pred)
        Y = nfa_step_ref(X, bwd[r])
        live_y |= (Y != 0).any(1)
        reach = segment_or_ref(Y, subj, V)
        targets += int((reach != 0).sum())
        written += int(((reach & ~(v[r] | f[r])) != 0).sum())
        set_bits += set_bits_below(X, S)
    remote = 0 if gathered is None else int(torch.unique(obj).numel())
    return _edge_pass(R, V, W, E, L, S, remote, int(live_f.sum()),
                      int(live_y.sum()), targets, written,
                      int((f != 0).sum()), set_bits)


def edge_pass_cost_all_live(R: int, V: int, W: int, E: int, L: int,
                            S: int, Vg=None, objects=None):
    """:func:`edge_pass_cost`'s formula with every count at its most:
    every edge live in both tests, every state word a frontier word, a
    target and written, every state bit below S set in every X.  (A
    frontier word with every bit below S set leaves no bit to write, so
    no input reaches all of them at once: this is an upper bound.)
    ``Vg`` (the gathered frontier's rows, on a mesh) adds the remote
    reads at ``objects`` distinct objects (default ``min(E, Vg)``)."""
    remote = 0 if Vg is None else (min(E, Vg) if objects is None
                                   else objects)
    words = R * V * W
    return _edge_pass(R, V, W, E, L, S, remote, E, E, words, words, words,
                      R * E * S)


def working_set_bytes(R: int, V: int, W: int, Vg: int, edges: int,
                      tiles: int, L: int, S: int) -> dict:
    """Bytes one shard's BFS holds on its device, by part, as the mesh's
    BFS allocates them (``core/distributed.py`` ``_Replica``,
    ``_PlaneBFS``): the three rotating frontier buffers and the visited
    words ([R, V, W] int32 each), the grouped edges (``Vg + 1`` offsets,
    subj and pred of its ``edges`` kept edges), the worklist (``R *
    tiles`` entries of two int32) and its three counters, the gathered
    frontier ([R, Vg, W]: one a device, counted with each shard that
    has a device of its own) and the tables."""
    out = {"words": 4 * 4 * R * V * W,
           "grouped_edges": 4 * (Vg + 1) + 8 * edges,
           "scratch": 8 * R * tiles + 4 * 3,
           "gathered": 4 * R * Vg * W,
           "tables": 4 * R * (L + S) * W}
    out["total"] = sum(out.values())
    return out


def _check(f, v, nxt, spare, flag, Bp, bwd, layout, scratch, g) -> None:
    words = (f, v, nxt, spare, Bp, bwd, g)
    edges = (layout.offsets, layout.subj, layout.pred)
    if any(t.dim() != 3 for t in words) or flag.shape != (1,) or \
            any(t.dim() != 1 for t in edges) or \
            scratch.work.dim() != 2 or scratch.work.shape[1] != 2 or \
            scratch.counters.shape != (3,):
        raise ValueError("packed_superstep wants [R, V, W] state words, "
                         "[R, L, W] and [R, S, W] tables, grouped edges, "
                         "a [capacity, 2] worklist, [3] counters and a [1] "
                         "flag")
    tensors = words + (flag,) + edges + (scratch.work, scratch.counters)
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("packed_superstep wants int32 words, ids, scratch "
                        "and flag")
    if any(t.device != f.device for t in tensors):
        raise ValueError("packed_superstep wants every tensor on one device")
    R, V, W = f.shape
    S = bwd.shape[1]
    if any(t.shape != (R, V, W) for t in (v, nxt, spare)) or \
            g.shape[0] != R or g.shape[2] != W or \
            Bp.shape[0] != R or bwd.shape[0] != R or Bp.shape[2] != W or \
            bwd.shape[2] != W or not 1 <= S <= 32 * W:
        raise ValueError(
            f"packed_superstep shapes disagree: state {tuple(f.shape)}, "
            f"{tuple(v.shape)}, {tuple(nxt.shape)}, {tuple(spare.shape)}; "
            f"gathered {tuple(g.shape)}; "
            f"Bp {tuple(Bp.shape)}, bwd {tuple(bwd.shape)}")
    if layout.offsets.shape[0] != g.shape[1] + 1 or \
            layout.num_objects != g.shape[1] or \
            layout.subj.shape != layout.pred.shape:
        raise ValueError(
            f"packed_superstep's grouped edges ({layout.num_objects} "
            f"objects, offsets {tuple(layout.offsets.shape)}, "
            f"{tuple(layout.subj.shape)} and {tuple(layout.pred.shape)} "
            f"ids) disagree with the frontier's {g.shape[1]} rows")
    if scratch.work.shape[0] < R * layout.tiles:
        raise ValueError(f"packed_superstep's worklist holds "
                         f"{scratch.work.shape[0]} entries, {R} rows need "
                         f"{R * layout.tiles}")
    if R * g.shape[1] > _INT32_MAX:
        raise ValueError("packed_superstep wants R * Vg within int32")
    state = {t.data_ptr() for t in (f, v, nxt, spare)}
    if len(state) != 4 and R * V * W:
        raise ValueError("packed_superstep wants four distinct state "
                         "buffers")
    if g.numel() and g.data_ptr() in {t.data_ptr() for t in (v, nxt,
                                                          spare)}:
        raise ValueError("packed_superstep's gathered frontier must not "
                         "share a buffer the pass writes")


def packed_superstep_cuda(f, v, nxt, spare, flag, stamp: int, Bp, bwd,
                          layout: GroupedEdges, scratch: SuperstepScratch,
                          gathered=None) -> None:
    """Launch the frontier scan and the tile expansion on the current
    stream: every tensor contiguous on one CUDA device, as the module
    note says.  Raises on anything the kernel does not take and on a
    refused launch."""
    g = f if gathered is None else gathered
    _check(f, v, nxt, spare, flag, Bp, bwd, layout, scratch, g)
    _build.check_cuda("packed_superstep_cuda", g, f, v, nxt, spare, flag,
                      Bp, bwd, layout.offsets, layout.subj, layout.pred,
                      scratch.work, scratch.counters)
    R, V, W = f.shape
    lib = _build.library("packed_superstep")
    capacity = R * layout.tiles
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = lib.packed_superstep_launch(
            g.data_ptr(), f.data_ptr(), v.data_ptr(), nxt.data_ptr(),
            spare.data_ptr(), flag.data_ptr(), int(stamp), Bp.data_ptr(),
            bwd.data_ptr(), layout.offsets.data_ptr(),
            layout.subj.data_ptr(), layout.pred.data_ptr(),
            scratch.work.data_ptr(), scratch.counters.data_ptr(), capacity,
            R, V, g.shape[1], Bp.shape[1], bwd.shape[1], W, TILE,
            stream)
    _build.check_launch(rc, "packed_superstep")
    if R and max(R * g.shape[1], V * W, capacity):   # else nothing launched
        launches["packed_superstep"] += 1


def packed_superstep_grouped_ref(f, v, nxt, spare, flag, stamp: int, Bp,
                                 bwd, layout: GroupedEdges,
                                 gathered=None) -> None:
    """The superstep's function over the grouped layout, on any device:
    the edges rebuilt from it (ids out of range dropped, as they
    contribute nothing) through ``packed_superstep_ref``."""
    subj, pred, obj = layout.subj, layout.pred, layout.objects()
    keep = (pred >= 0) & (pred < Bp.shape[1]) & (subj >= 0) & \
        (subj < f.shape[1])
    packed_superstep_ref(f, v, nxt, spare, flag, stamp, Bp, bwd, subj[keep],
                         pred[keep], obj[keep], gathered=gathered)


def packed_superstep_plain(f, v, nxt, spare, flag, stamp: int, Bp, bwd,
                           layout: GroupedEdges, scratch: SuperstepScratch,
                           gathered=None) -> None:
    """The superstep's plain PyTorch version, for CPU tensors
    (:func:`packed_superstep_grouped_ref`).  The scratch is checked and
    left alone."""
    g = f if gathered is None else gathered
    _check(f, v, nxt, spare, flag, Bp, bwd, layout, scratch, g)
    _build.check_cpu("packed_superstep_plain", f)
    packed_superstep_grouped_ref(f, v, nxt, spare, flag, stamp, Bp, bwd,
                                 layout, gathered=gathered)
