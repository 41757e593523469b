"""Dense RPQ engine on the card: frontier-synchronous product-graph BFS
over packed state words.

The paper's two "simultaneity" tricks map onto the two axes of the
BFS state:

  * bit-parallelism  (all NFA states of a node at once)  -> the packed
    state words of a node, S = m+1 bits in W = ceil(S/32) words;
  * range-parallelism (many graph nodes/labels at once)  -> the V node
    axis / the E edge axis of one kernel launch.

One BFS superstep over the *backward* product graph is

    X[e]       = frontier[obj[e]] & B[label[e]]          (Fact 1 filter)
    Y[e]       = T'[X[e]]  =  OR_{j in X[e]} PRED[j]     (bit-matrix step)
    new[v]     = OR_{e : subj[e]=v} Y[e]  & ~visited[v]  (segment-OR)
    visited   |= new ; frontier = new

The JAX package computes it on int8 planes as a matmul plus
``segment_max`` (``repro/core/dense.py:136``); here it is one call of
the hand-written superstep ``ops.packed_superstep`` over packed words,
which computes the same function (the reference's own
``test_packed_matches_dense`` holds the two equal) over the edges
grouped by object, so its work follows the live frontier.  A node is an
*answer* when its state-0 (initial) bit lights up: bit 0 of word 0.

One loop (:func:`bfs_rows`, whose host side :func:`superstep_loop` also
drives the sharded supersteps) runs every BFS: R rows at once, each with
its own tables ([R, L+1, W] and [R, S_pad, W]: the multi-source batch
shares one automaton, the heterogeneous ``eval_many`` batch gives each
row its own, padded to its bucket's power-of-two state width), over one
shared edge list.  It queues a chunk of supersteps, then reads the
kernel's flag once: the flag holds the stamp of the last superstep that
found a word, so the superstep count follows from it exactly, and a
superstep after an empty one returns at once.  Chunks grow 1, 2, 4, ...
up to ``_DEADLINE_CHUNK`` (16); under a deadline, checked between
chunks, each is 16, and ANALYZE and an ``on_step`` hook take one
superstep a chunk.  Padding states have zero tables and can never
activate, so per-row results are bit-identical to a solo run.

Live updates (:mod:`repro_torch.core.delta`): the masked-plane path.
Tables carry one extra all-zero *inert* label row; a mutation relabels
tombstoned base edges to it (they can never fire) and appends the
overlay's insert buffer as extra edge rows (pow2-padded with inert
rows, unsorted by subject); each epoch is an :class:`Edges`, grouped by
object on the device once, inert edges dropped from the grouped view.

Mesh sharding (``mesh=``/``shards=N``): the node axis of every one of
these BFS shapes is range-partitioned over a mesh's data axes and the
supersteps run shard-local over one frontier all-gather per superstep
(:class:`~repro_torch.core.distributed.ShardedDenseExec`); its superstep
counts land in ``QueryStats.supersteps`` on every sharded run, as in the
JAX package.  ANALYZE runs unsharded: the answers are the same.

The engine's device is explicit: ``"cuda"`` unless the caller asks for
``"cpu"`` (the kernel's plain version).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from itertools import repeat
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.packed_superstep import (GroupedEdges, group_by_object,
                                        new_scratch)
from ..kernels.ref import popcount, widen
from ..obs import trace as otrace
from . import delta as dl
from . import planner as qp
from . import regex as rx
from .engines import (PlanCache, QueryLike, QueryStats, ResultCache,
                      TraceTracker, as_query, normalized_key,
                      probe_result_cache, publish_result, result_key,
                      truncate_result)
from .glushkov import Glushkov
from .ring import LabeledGraph
from .stats import GraphStats


@dataclass(frozen=True, eq=False)  # identity hash: slots group by epoch
class Edges:
    """One edge epoch on the device: (subj, pred, obj) [E] int32 (label
    ``inert_label`` for tombstones and padding) and their object-grouped
    view, the layout ``ops.packed_superstep`` reads.  Never mutated, so a
    slot pinned to an epoch reads that epoch's layout."""

    subj: torch.Tensor
    pred: torch.Tensor
    obj: torch.Tensor
    grouped: GroupedEdges

    @classmethod
    def build(cls, subj: torch.Tensor, pred: torch.Tensor, obj: torch.Tensor,
              num_objects: int, inert_label: int) -> "Edges":
        """Group the arrays on their device (:func:`group_by_object`)."""
        return cls(subj, pred, obj, group_by_object(
            subj, pred, obj, num_objects, inert_label))


@dataclass
class DenseGraph:
    """Device-resident completed graph: its base :class:`Edges` epoch
    (``edges``: subj sorted ascending, pred in [0, 2P), obj, [E] int32
    each, and their grouped view), with the same arrays on the host
    (``host``: subj, pred, obj as int32 numpy)."""

    edges: Edges
    num_nodes: int
    num_labels: int     # 2P
    host: Tuple[np.ndarray, np.ndarray, np.ndarray]

    @property
    def device(self) -> torch.device:
        return self.edges.subj.device

    @classmethod
    def from_graph(cls, g: LabeledGraph, device=None) -> "DenseGraph":
        """``device``: ``None`` means ``"cuda"`` (see
        :func:`repro_torch.kernels.ops.resolve_device`)."""
        dev = ops.resolve_device(device)
        s, p, o = g.completed_triples()
        order = np.argsort(s, kind="stable")
        host = tuple(a[order].astype(np.int32) for a in (s, p, o))
        subj, pred, obj = (torch.from_numpy(a).to(dev) for a in host)
        L = 2 * g.num_preds
        return cls(edges=Edges.build(subj, pred, obj, g.num_nodes, L),
                   num_nodes=g.num_nodes, num_labels=L, host=host)


def _words(mask: int, W: int) -> np.ndarray:
    """A Python-int state mask as W uint32 words (bit i of word i // 32)."""
    return np.array([(mask >> (32 * w)) & 0xFFFFFFFF for w in range(W)],
                    dtype=np.uint32)


def _start_row(g: Glushkov) -> np.ndarray:
    """[W] uint32 start words for a start object: F minus the eps bit."""
    return _words(g.F & ~1, g.nwords)


def _plane_tables(g: Glushkov, num_labels: int):
    """Packed tables as uint32 words: Bp [labels + 1, W] and PRED [S, W]
    (row j = pred_mask[j], so T'[X] = OR of the rows X selects), state i
    on bit i.  The extra label row ``num_labels`` is all-zero: the
    *inert* label, to which tombstoned base edges and padding edges are
    relabeled, so they match nothing."""
    W = g.nwords
    Bp = np.zeros((num_labels + 1, W), dtype=np.uint32)
    for lab, mask in g.B.items():
        if 0 <= lab < num_labels:
            Bp[lab] = _words(mask, W)
    PRED = np.stack([_words(m, W) for m in g.pred_mask])
    return Bp, PRED


def _count_bits(words: torch.Tensor) -> int:
    """Set bits of int32 words (ANALYZE's node-state counts; a sync)."""
    return int(popcount(widen(words)).sum())


# supersteps queued between two reads of the kernel's flag under a
# deadline (the clock is read between chunks), and the most queued
# without one; ANALYZE and an ``on_step`` hook take one a chunk
_DEADLINE_CHUNK = 16


def _chunk(chunks_done: int, deadline, stepwise: bool) -> int:
    """Supersteps to queue before the next flag read.  Without a deadline
    the chunks grow 1, 2, 4, ... up to ``_DEADLINE_CHUNK``: a BFS of n
    supersteps then launches fewer than 2n passes (those after its last
    superstep return at once) and reads the flag about log2(n) + 1
    times."""
    if stepwise:
        return 1
    if deadline is not None:
        return _DEADLINE_CHUNK
    return min(_DEADLINE_CHUNK, 1 << chunks_done)


def superstep_loop(chunk: Callable[[int, int], int], max_steps: int,
                   deadline: Optional[float] = None,
                   stepwise: bool = False,
                   after: Optional[Callable[[int], None]] = None) -> int:
    """The host loop of one BFS, unsharded (:func:`bfs_rows`) or on a mesh
    (``ShardedDenseExec.run_rows``).  ``chunk(it, k)`` queues supersteps
    ``it .. it + k - 1`` (superstep n stamps the kernel's flag with n + 1
    where it finds a word) and returns the flag: the chunk's one host
    sync.  ``deadline`` (absolute ``time.time()`` seconds) is checked
    before each chunk and raises ``TimeoutError``; ``after(it)`` is
    called after each chunk with the supersteps so far.  Returns the
    supersteps that ran, the JAX chunk loops' count (the superstep that
    found nothing is one of them)."""
    it = 0         # supersteps that ran (launches that did work)
    chunks = 0
    active = max_steps > 0
    while active:
        if deadline is not None and time.time() > deadline:
            raise TimeoutError("query deadline exceeded")
        k = min(_chunk(chunks, deadline, stepwise), max_steps - it)
        chunks += 1
        last = chunk(it, k)
        launched = it + k
        # flag: the last superstep that found a word; the one after it
        # found nothing and ran, the rest of the chunk changed nothing
        # (so that one's output buffer is still all zero)
        it = launched if last == launched else last + 1
        active = last == launched and it < max_steps
        if after is not None:
            after(it)
    return it


def bfs_rows(edges: Edges, Bp: torch.Tensor, PRED: torch.Tensor,
             frontier: torch.Tensor, max_steps: int,
             visited: Optional[torch.Tensor] = None,
             deadline: Optional[float] = None,
             collector: Optional[list] = None,
             on_step: Optional[Callable] = None,
             span: Optional[Dict] = None):
    """Run R BFS rows over ``edges`` (an :class:`Edges` epoch, whose
    grouped view the supersteps read) until every row's frontier is
    empty or ``max_steps`` supersteps ran.
    ``frontier`` [R, V, W] int32 words (taken over: the loop writes it),
    ``visited`` the same shape (the JAX package's visited, or ``None``
    for the frontier itself), tables Bp [R, L, W] and PRED [R, S, W], all
    on one device.  Returns ``(visited, frontier, supersteps)``:
    ``visited`` holds the frontier, as the JAX package's does; the
    superstep count is the JAX chunk loops' (the supersteps until every
    row stops: max over rows).

    ``deadline`` (absolute ``time.time()`` seconds) is checked before
    each chunk and raises ``TimeoutError``.  ``collector`` (ANALYZE)
    gets one ``{"frontier", "activations"}`` row per superstep, node-
    states over all rows.  ``on_step(frontier, visited, Bp, PRED)`` is
    called before each superstep with the tensors it reads (``visited``
    trails the frontier by one superstep there); it must not write them.
    Each chunk is one ``dense.bfs_chunk`` span (``span``: its arguments,
    default ``steps=``)."""
    dev = frontier.device
    v = torch.zeros_like(frontier) if visited is None else visited.clone()
    # bufs[n % 3] is launch n's frontier, bufs[(n + 1) % 3] its output
    # (zero), bufs[(n + 2) % 3] the frontier before (it zeroes it)
    bufs = [frontier, torch.zeros_like(frontier), torch.zeros_like(frontier)]
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    layout = edges.grouped
    scratch = new_scratch(layout, frontier.shape[0])
    counts: list = []     # ANALYZE: the chunk's (frontier, visited) bits

    def chunk(it: int, k: int) -> int:
        if collector is not None:
            counts[:] = [_count_bits(bufs[it % 3]),
                         _count_bits(v | bufs[it % 3])]
        with otrace.span("dense.bfs_chunk", cat="kernel",
                         **(span if span is not None else {"steps": k})):
            for n in range(it, it + k):
                f, nxt, spare = (bufs[(n + d) % 3] for d in range(3))
                if on_step is not None:
                    on_step(f, v, Bp, PRED)
                ops.packed_superstep(f, v, nxt, spare, flag, n + 1, Bp, PRED,
                                     layout, scratch)
            return int(flag.item())

    def record(it: int) -> None:
        fin, vin = counts
        collector.append({"frontier": fin,
                          "activations": _count_bits(v | bufs[it % 3]) - vin})

    it = superstep_loop(
        chunk, max_steps if bool(frontier.any()) else 0, deadline,
        stepwise=collector is not None or on_step is not None,
        after=record if collector is not None else None)
    frontier = bufs[it % 3]
    return v | frontier, frontier, it


@dataclass(eq=False)  # identity hash, as the JAX package's plans
class _DensePlan:
    """Compiled dense-side plan: automaton + packed tables (Bp, PRED) on
    the engine's device and on the host (for the heterogeneous stacks) —
    shared across queries via the plan cache."""

    g: Glushkov
    B: torch.Tensor      # [L + 1, W] int32 words
    PRED: torch.Tensor   # [S, W] int32 words
    host: Tuple[np.ndarray, np.ndarray]   # (B, PRED) as uint32


class DenseRPQ(dl.LiveUpdateEngine):
    """Dense-engine 2RPQ evaluation with RingRPQ-identical semantics.

    ``planner``/``stats`` mirror :class:`~repro_torch.core.rpq.RingRPQ`:
    the cost-based planner may run ``reverse`` or ``split`` physical
    plans (executed with the same batched BFS), and ``planner="naive"``
    keeps the pre-planner behavior.

    ``device``: where the BFS runs, ``"cuda"`` unless the caller asks for
    ``"cpu"``; without a card the default raises before the build.

    Sharding: ``mesh=`` (a :class:`~repro_torch.core.distributed.Mesh`)
    or ``shards=N`` (the first N devices of ``device``'s kind) routes
    every BFS — single, multi-source, and heterogeneous ``eval_many``
    buckets, under all planner shapes — through the row-partitioned
    sharded executor (:class:`~repro_torch.core.distributed.
    ShardedDenseExec`); ``data_axes`` names the mesh axes the node axis is
    split over and ``model_axis`` optionally edge-splits each shard.
    Sharded results are identical to single-device ``eval``.

    ``deadline_s`` on :meth:`eval` (per query) and :meth:`eval_many`
    (batch-wide, like the ring engine) raises ``TimeoutError``, checked
    between chunks of ``_DEADLINE_CHUNK`` supersteps.
    """

    def __init__(self, graph: LabeledGraph, source_batch: int = 16,
                 result_cache: Optional[ResultCache] = None,
                 planner: str = "cost",
                 stats: Optional[GraphStats] = None,
                 mesh=None, shards: Optional[int] = None,
                 data_axes=None, model_axis: Optional[str] = None,
                 compact_threshold: Optional[int] =
                 dl.DEFAULT_COMPACT_THRESHOLD,
                 device=None):
        self.device = ops.resolve_device(device)
        if planner not in ("cost", "naive", "forward", "reverse", "split"):
            raise ValueError(f"unknown planner policy {planner!r}")
        self.graph = graph
        self.dg = DenseGraph.from_graph(graph, self.device)
        self.source_batch = source_batch
        self.planner = planner
        self.plans = PlanCache()
        self.decisions = PlanCache()
        self.results = result_cache if result_cache is not None else ResultCache()
        self.traces = TraceTracker()  # distinct BFS dispatch signatures
        self.hetero_dispatches = 0   # heterogeneous-batch dispatches
        self.delta: Optional[dl.DeltaOverlay] = None  # live-update overlay
        self.compact_threshold = compact_threshold
        self.compactions = 0
        self._eff: Optional[Edges] = None  # the epoch with the overlay
        self._stats = stats
        self._edge_s: Optional[np.ndarray] = None   # completed edges,
        self._edge_o: Optional[np.ndarray] = None   # label-major order
        self._edge_off: Optional[np.ndarray] = None
        self._edge_eff: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._deadline: Optional[float] = None      # absolute, per eval call
        self._analyze = None        # ANALYZE superstep collector (obs.explain)
        self._superstep_acc = 0     # host-stepped/sharded superstep count
        self.sharded = None
        if mesh is not None or shards is not None:
            from .distributed import ShardedDenseExec, resolve_mesh
            rmesh, raxes = resolve_mesh(mesh, shards, data_axes, model_axis,
                                        device=self.device)
            self.sharded = ShardedDenseExec(self.dg, rmesh, raxes, model_axis)

    @property
    def graph_stats(self) -> GraphStats:
        """Selectivity statistics for the planner (lazy; injectable).
        With a live overlay, a fresh harvest reads the static base, so
        every predicate the overlay ever touched is refreshed from the
        effective edges before first use."""
        if self._stats is None:
            self._stats = GraphStats.from_graph(self.graph)
            self._refresh_touched_stats()
        return self._stats

    # -- live updates (surface shared via delta.LiveUpdateEngine) ------------
    def _base_graph(self) -> LabeledGraph:
        return self.graph

    def _overlay_created(self) -> None:
        # base edge keys, aligned with dg's subject-sorted edge order
        # — the tombstone mask is a per-mutation np.isin over these
        self._base_keys = dl.pack_keys(*self.dg.host, self.graph.num_nodes,
                                       self.dg.num_labels)

    def _on_overlay_change(self, mutated_raw) -> None:
        """Rebuild the effective edge arrays (the masked-plane path):
        tombstoned base edges are relabeled to the inert label — their
        B row is all-zero, so they can never fire — and the overlay's
        insert buffer is appended as extra edge rows (padded to a power
        of two), then grouped by object on the device (inert edges
        dropped).  The epoch is a fresh :class:`Edges`, never the old one
        mutated, so a stepper slot pinned to the old one reads its
        admission epoch.  A mesh-sharded engine re-partitions the same
        arrays."""
        ov = self.delta
        self._edge_eff = {}
        subj, pred, obj = self.dg.host
        L = self.dg.num_labels
        if ov.has_tombs:
            pred = np.where(np.isin(self._base_keys, ov.tombstoned_keys()),
                            np.int32(L), pred)
        ds, dp, do = ov.delta_edge_rows()
        cap = 8
        while cap < ds.size:
            cap *= 2
        if ds.size or ov.has_tombs:
            pad_s = np.zeros(cap, dtype=np.int32)
            pad_p = np.full(cap, L, dtype=np.int32)
            pad_o = np.zeros(cap, dtype=np.int32)
            pad_s[:ds.size] = ds
            pad_p[:dp.size] = dp
            pad_o[:do.size] = do
            subj, pred, obj = (np.concatenate([a, pad]) for a, pad in
                               ((subj, pad_s), (pred, pad_p), (obj, pad_o)))
            self._eff = Edges.build(
                *(torch.from_numpy(a).to(self.device)
                  for a in (subj, pred, obj)), self.dg.num_nodes, L)
        else:
            self._eff = None
        if self.sharded is not None:
            from types import SimpleNamespace
            self.sharded.refresh_edges(SimpleNamespace(
                subj=subj, pred=pred, obj=obj,
                num_nodes=self.dg.num_nodes, num_labels=L))

    def _edges(self) -> Edges:
        """The edge epoch every BFS runs over — the effective set when
        an overlay is live, else the base."""
        return self._eff if self._eff is not None else self.dg.edges

    def compact(self) -> None:
        """Fold the overlay into a fresh base graph + edge arrays.
        Logical no-op: results, the epoch counter, and surviving cache
        entries are unchanged — only the physical base moves."""
        if self.delta is None or self.delta.size == 0:
            return
        self.graph = self.effective_graph()
        self.dg = DenseGraph.from_graph(self.graph, self.device)
        s, p, o = self.graph.completed_triples()
        self.delta.reset_after_compaction(
            dl.pack_keys(s, p, o, self.graph.num_nodes, self.dg.num_labels))
        self._overlay_created()   # re-key the fresh base edge order
        self._eff = None
        self._edge_s = self._edge_o = self._edge_off = None
        self._edge_eff = {}
        if self._stats is not None:
            self._stats = GraphStats.from_graph(self.graph)
        if self.sharded is not None:
            self.sharded.refresh_edges(self.dg)
        self.compactions += 1

    def _resolve_lit(self, lit: rx.Lit) -> int:
        return self.graph.resolve_lit(lit)

    def _automaton(self, ast) -> Glushkov:
        return Glushkov.from_ast(ast, self._resolve_lit)

    def _plan(self, ast) -> _DensePlan:
        """Automaton + packed tables for ``ast``, shared via the plan
        cache (keyed by the canonical AST, so equivalent spellings
        share)."""

        def build():
            g = self._automaton(ast)
            B, PRED = _plane_tables(g, self.dg.num_labels)
            return _DensePlan(g=g, B=ops.words_to_tensor(B, self.device),
                              PRED=ops.words_to_tensor(PRED, self.device),
                              host=(B, PRED))

        return self.plans.get(normalized_key(ast), build)

    def _decide(self, ast, subject_bound: bool, obj_bound: bool,
                stats: Optional[QueryStats]) -> qp.Plan:
        """Planner decision, memoized per (expression, binding) class.
        The higher unanchored margin reflects that dense naive unanchored
        evaluation is already one batched all-nodes BFS."""
        return qp.decide(ast, subject_bound, obj_bound,
                         policy=self.planner, decisions=self.decisions,
                         stats_provider=lambda: self.graph_stats,
                         resolve=self._resolve_lit, record=stats,
                         unanchored_margin=qp.ANCHORED_MARGIN,
                         footprint=self._footprint(ast))

    def make_stepper(self, steps_per_tick: int = 1) -> "DenseStepper":
        """A continuously-batchable superstep executor over this engine
        — the slot scheduler's entry point (see
        :mod:`repro_torch.core.scheduler`)."""
        return DenseStepper(self, steps_per_tick=steps_per_tick)

    # -- split-plan primitives ---------------------------------------------
    def _pred_edges_base(self, p: int) -> Tuple[np.ndarray, np.ndarray]:
        """(subjects, objects) of the *base* completed edges labeled
        ``p``, label-major order built on first use from the host copy."""
        if self._edge_s is None:
            subj, pred, obj = self.dg.host
            order = np.argsort(pred, kind="stable")
            self._edge_s = subj[order].astype(np.int64)
            self._edge_o = obj[order].astype(np.int64)
            cnt = np.bincount(pred, minlength=self.dg.num_labels)
            self._edge_off = np.zeros(self.dg.num_labels + 1, dtype=np.int64)
            np.cumsum(cnt, out=self._edge_off[1:])
        if not (0 <= p < self.dg.num_labels):
            z = np.zeros(0, dtype=np.int64)
            return z, z
        b, e = int(self._edge_off[p]), int(self._edge_off[p + 1])
        return self._edge_s[b:e], self._edge_o[b:e]

    def _half_union(self, side_ast, seeds, reverse: bool = False) -> set:
        """Union half-traversal of a split plan: one multi-start BFS from
        all seeds (the node axis carries them simultaneously), plus the
        seeds themselves when the half matches the empty word."""
        seeds = [int(x) for x in seeds]
        if not seeds:
            return set()
        if side_ast is None:
            return set(seeds)
        ast = rx.reverse(side_ast) if reverse else side_ast
        hit = self._run_from(self._plan(ast), np.asarray(seeds))
        out = set(int(v) for v in np.nonzero(hit)[0])
        if rx.nullable(side_ast):
            out.update(seeds)
        return out

    def _grouped_half(self, side_ast, endpoints: np.ndarray,
                      reverse: bool = False) -> Dict[int, Tuple[int, ...]]:
        """Per-endpoint half results for the unanchored split join: one
        batched-BFS row per distinct seed endpoint."""
        eps = [int(x) for x in endpoints]
        if side_ast is None:
            return {u: (u,) for u in eps}
        ast = rx.reverse(side_ast) if reverse else side_ast
        hits = self._run_from_batched(self._plan(ast), eps)
        null = rx.nullable(side_ast)
        out = {}
        for i, u in enumerate(eps):
            vals = set(int(v) for v in np.nonzero(hits[i])[0])
            if null:
                vals.add(u)
            out[u] = tuple(vals)
        return out

    # -- the BFS dispatches ----------------------------------------------------
    def _stepped(self) -> bool:
        """Whether the supersteps of this call are counted: under a
        deadline or ANALYZE (the JAX package's host-stepped runs)."""
        return self._deadline is not None or self._analyze is not None

    def _use_sharded(self) -> bool:
        """Whether this call's BFS runs on the mesh: ANALYZE runs
        unsharded (per-superstep collector) even on a sharded engine —
        results are identical, only the dispatch site moves."""
        return self.sharded is not None and self._analyze is None

    def _bfs(self, B, PRED, frontier, max_steps: int,
             table_key=None) -> np.ndarray:
        """One dispatch of :func:`bfs_rows` on the current edges (or of
        the sharded executor, whose supersteps are always counted), with
        this call's deadline and ANALYZE collector.  Returns the [R, V]
        hit planes (initial-state bits) on the host."""
        if self._use_sharded():
            visited, it = self.sharded.run_rows(
                B, PRED, frontier, max_steps, deadline=self._deadline,
                table_key=table_key)
            self._superstep_acc += it
        else:
            visited, _f, it = bfs_rows(self._edges(), B, PRED, frontier,
                                       max_steps, deadline=self._deadline,
                                       collector=self._analyze)
            if self._stepped():
                self._superstep_acc += it
        return (visited[:, :, 0] & 1).bool().cpu().numpy()

    def _frontier(self, R: int, W: int, rows, nodes,
                  words: np.ndarray) -> torch.Tensor:
        """[R, V, W] start words on the device: ``words`` [n, W'] (W' <= W)
        at (rows[i], nodes[i])."""
        out = torch.zeros((R, self.graph.num_nodes, W), dtype=torch.int32,
                          device=self.device)
        if len(rows):
            pad = np.zeros((len(rows), W), dtype=np.uint32)
            pad[:, :words.shape[1]] = words
            out[torch.as_tensor(np.asarray(rows, dtype=np.int64)),
                torch.as_tensor(np.asarray(nodes, dtype=np.int64))] = \
                ops.words_to_tensor(pad, self.device)
        return out

    def _run_from(self, plan: _DensePlan, objs) -> np.ndarray:
        """Returns bool[V]: nodes whose initial-state bit activated."""
        V = self.graph.num_nodes
        g = plan.g
        if g.F & ~1 == 0:
            return np.zeros(V, dtype=bool)
        max_steps = V * (g.m + 1) + 1
        if self._use_sharded():
            self.traces.record("sharded_rows", 1, g.m + 1)
        elif self._stepped():
            self.traces.record("bfs_chunk", V, g.m + 1)
        else:
            self.traces.record("bfs", V, g.m + 1, max_steps)
        objs = np.asarray(objs, dtype=np.int64).reshape(-1)
        row = _start_row(g)
        frontier = self._frontier(1, g.nwords, np.zeros_like(objs), objs,
                                  np.broadcast_to(row, (objs.size, row.size)))
        return self._bfs(plan.B[None], plan.PRED[None], frontier,
                         max_steps, table_key=(plan, 1))[0]

    def _run_from_batched(self, plan: _DensePlan, starts: Sequence[int],
                          batch_size: Optional[int] = None) -> np.ndarray:
        """Multi-source batched BFS: bool[len(starts), V] hit planes, one
        independent start node per batch row (chunked over source_batch)."""
        V = self.graph.num_nodes
        g = plan.g
        hits = np.zeros((len(starts), V), dtype=bool)
        if g.F & ~1 == 0 or not len(starts):
            return hits
        Bsz = batch_size or self.source_batch
        S = g.m + 1
        frow = _start_row(g)
        for i in range(0, len(starts), Bsz):
            chunk = np.asarray(starts[i : i + Bsz], dtype=np.int64)
            n = len(chunk)
            R = n
            if self._use_sharded():
                # the tail chunk pads to Bsz rows (zero rows converge at
                # once), so the tables' device copies keyed by (plan,
                # Bsz) serve every chunk
                R = Bsz
                self.traces.record("sharded_rows", Bsz, S)
            elif self._stepped():
                self.traces.record("bfs_chunk_batched", R, V, S)
            else:
                self.traces.record("bfs_batched", R, V, S)
            frontier = self._frontier(R, g.nwords, np.arange(n), chunk,
                                      np.broadcast_to(frow, (n, frow.size)))
            hits[i : i + n] = self._bfs(
                plan.B.expand(R, -1, -1).contiguous(),
                plan.PRED.expand(R, -1, -1).contiguous(), frontier,
                V * S + 1, table_key=(plan, Bsz))[:n]
        return hits

    @staticmethod
    def _pad_width(S: int) -> int:
        """Bucket state width: next power of two (min 4), so mixed-size
        automata share launch shapes instead of one per m."""
        w = 4
        while w < S:
            w *= 2
        return w

    def _stack_tables(self, plans: Sequence[Optional[_DensePlan]],
                      S_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row tables [len(plans), L+1, W] and [len(plans), S_pad, W]
        on the device, W = ceil(S_pad / 32); a ``None`` row, padding
        states and the inert label row stay zero."""
        L = self.dg.num_labels
        W = (S_pad + 31) // 32
        Bstk = np.zeros((len(plans), L + 1, W), dtype=np.uint32)
        PREDstk = np.zeros((len(plans), S_pad, W), dtype=np.uint32)
        for r, plan in enumerate(plans):
            if plan is None:
                continue
            B_host, PRED_host = plan.host
            Bstk[r, :, :B_host.shape[1]] = B_host
            PREDstk[r, :PRED_host.shape[0], :PRED_host.shape[1]] = PRED_host
        return (ops.words_to_tensor(Bstk, self.device),
                ops.words_to_tensor(PREDstk, self.device))

    def _run_hetero_rows(
        self,
        rows: Sequence[Tuple[_DensePlan, int]],
        batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Heterogeneous multi-plan batched BFS: row i runs ``rows[i] =
        (plan, start node)`` with its own padded tables.  Returns
        bool[len(rows), V] hit planes (initial-state activations).

        Rows bucket by padded state width; each bucket stacks per-row
        tables and start words and dispatches one :func:`bfs_rows` per
        ``source_batch`` chunk, the tail chunk zero-padded to the batch
        size."""
        V = self.graph.num_nodes
        hits = np.zeros((len(rows), V), dtype=bool)
        if not rows:
            return hits
        Bsz = batch_size or self.source_batch
        buckets: Dict[int, List[int]] = {}
        for i, (plan, _start) in enumerate(rows):
            buckets.setdefault(self._pad_width(plan.g.m + 1), []).append(i)
        for S_pad, members in buckets.items():
            W = (S_pad + 31) // 32
            for c0 in range(0, len(members), Bsz):
                chunk = members[c0 : c0 + Bsz]
                R = len(chunk)
                plans: List[Optional[_DensePlan]] = [None] * Bsz
                live, nodes, words = [], [], []
                for r, i in enumerate(chunk):
                    plan, start = rows[i]
                    if plan.g.F & ~1 == 0:
                        continue  # no reachable final state: row stays empty
                    plans[r] = plan
                    live.append(r)
                    nodes.append(start)
                    srow = np.zeros(W, dtype=np.uint32)
                    srow[:plan.g.nwords] = _start_row(plan.g)
                    words.append(srow)
                Bstk, PREDstk = self._stack_tables(plans, S_pad)
                frontier = self._frontier(
                    Bsz, W, live, nodes,
                    np.array(words, dtype=np.uint32).reshape(-1, W))
                if self._use_sharded():
                    self.traces.record("sharded_rows", Bsz, S_pad)
                elif self._stepped():
                    self.traces.record("bfs_chunk_hetero", Bsz, S_pad)
                else:
                    self.traces.record("bfs_hetero", Bsz, S_pad)
                vis0 = self._bfs(Bstk, PREDstk, frontier, V * S_pad + 1)
                self.hetero_dispatches += 1
                for r, i in enumerate(chunk):
                    hits[i] = vis0[r]
        return hits

    # -- split / reverse plan execution ------------------------------------
    def _seed_subjects(self, plan: qp.Plan, obj: int,
                       stats: Optional[QueryStats]) -> np.ndarray:
        """Right half from the bound object, then the surviving seed
        edges' subjects (shared by the (x,E,o) and (s,E,o) split paths)."""
        sp = plan.split
        sarr, oarr = self._pred_edges(plan.split_pred)
        if sarr.size == 0:
            if stats is not None:
                stats.plan_actual_frontier = 0
            return sarr
        U = self._half_union(sp.right, [obj])
        keep = qp.isin_mask(oarr, U)
        if stats is not None:
            stats.plan_actual_frontier = int(keep.sum())
        return np.unique(sarr[keep])

    def _split_from_subj(self, plan: qp.Plan, subject: int,
                         stats: Optional[QueryStats]) -> set:
        """(s, E=A/p/B, y): objects reachable through any seed edge whose
        subject endpoint the left half validates from ``subject``."""
        sp = plan.split
        sarr, oarr = self._pred_edges(plan.split_pred)
        if sarr.size == 0:
            if stats is not None:
                stats.plan_actual_frontier = 0
            return set()
        Vs = self._half_union(sp.left, [subject], reverse=True)
        keep = qp.isin_mask(sarr, Vs)
        if stats is not None:
            stats.plan_actual_frontier = int(keep.sum())
        return self._half_union(sp.right, np.unique(oarr[keep]),
                                reverse=True)

    def _split_unanchored(self, plan: qp.Plan,
                          stats: Optional[QueryStats]) -> Set[Tuple[int, int]]:
        """(x, E=A/p/B, y): per-endpoint batched half-BFS rows joined
        through the seed edges (answer pairs need the SAME edge).  The
        join always completes — ``limit`` truncation is deterministic
        (the sorted prefix), so a partial join could return the wrong
        pairs."""
        sp = plan.split
        sarr, oarr = self._pred_edges(plan.split_pred)
        if stats is not None:
            stats.plan_actual_frontier = int(sarr.size)
        if sarr.size == 0:
            return set()
        lmap = self._grouped_half(sp.left, np.unique(sarr))
        rmap = self._grouped_half(sp.right, np.unique(oarr), reverse=True)
        out: Set[Tuple[int, int]] = set()
        for u, v in zip(sarr.tolist(), oarr.tolist()):
            for a in lmap[u]:
                for b in rmap[v]:
                    out.add((a, b))
        return out

    def eval(
        self,
        expr: str,
        subject: Optional[int] = None,
        obj: Optional[int] = None,
        limit: Optional[int] = None,
        stats: Optional[QueryStats] = None,
        deadline_s: Optional[float] = None,
    ) -> Set[Tuple[int, int]]:
        """Evaluate the 2RPQ (subject, expr, obj); ``None`` = variable.

        ``deadline_s``: per-query timeout — raises ``TimeoutError`` (the
        same signal :meth:`RingRPQ.eval` uses), checked between BFS
        superstep chunks."""
        prev_deadline = self._deadline
        if deadline_s:
            self._deadline = time.time() + deadline_s
        try:
            return self._eval_inner(expr, subject, obj, limit, stats)
        finally:
            self._deadline = prev_deadline

    def explain(self, query, analyze: bool = False,
                deadline_s: Optional[float] = None) -> Dict:
        """Structured plan report for ``query`` (see
        :mod:`repro_torch.obs.explain`).  ``analyze=False`` never
        executes a superstep; ``analyze=True`` runs the query under a
        private tracer and attaches the per-superstep timeline."""
        from ..obs import explain as oexplain
        return oexplain.explain_query(self, query, analyze=analyze,
                                      deadline_s=deadline_s)

    def _eval_inner(self, expr, subject, obj, limit, stats):
        ast = rx.parse(expr)
        V = self.graph.num_nodes
        null = rx.nullable(ast)
        out: Set[Tuple[int, int]] = set()
        acc0 = self._superstep_acc
        tr0 = self.traces.retraces
        plan = self._decide(ast, subject is not None, obj is not None, stats)

        if subject is None and obj is None:
            if null:
                out.update((v, v) for v in range(V))
            if plan.mode == "split":
                out.update(self._split_unanchored(plan, stats))
            elif plan.mode == "reverse":
                # objects-first: phase 1 over ^E finds the objects, then
                # one batched-BFS row per object completes its subjects
                objs = np.nonzero(self._run_from(
                    self._plan(rx.reverse(ast)), np.arange(V)))[0]
                if stats is not None:
                    stats.plan_actual_frontier = len(objs)
                hits = self._run_from_batched(self._plan(ast),
                                              [int(o) for o in objs])
                for bi, o in enumerate(objs):
                    for s in np.nonzero(hits[bi])[0]:
                        out.add((int(s), int(o)))
            else:
                sources = np.nonzero(
                    self._run_from(self._plan(ast), np.arange(V)))[0]
                if stats is not None:
                    stats.plan_actual_frontier = len(sources)
                # batched phase 2: source_batch sources at a time
                p_fwd = self._plan(rx.reverse(ast))
                hits = self._run_from_batched(p_fwd, [int(s) for s in sources])
                for bi, s in enumerate(sources):
                    for o in np.nonzero(hits[bi])[0]:
                        out.add((int(s), int(o)))
        elif subject is None:
            if null:
                out.add((obj, obj))
            if plan.mode == "split":
                seeds = self._seed_subjects(plan, obj, stats)
                out.update((s, obj) for s in
                           self._half_union(plan.split.left, seeds))
            else:
                for s in np.nonzero(self._run_from(self._plan(ast), [obj]))[0]:
                    out.add((int(s), obj))
        elif obj is None:
            if null:
                out.add((subject, subject))
            if plan.mode == "split":
                out.update((subject, o) for o in
                           self._split_from_subj(plan, subject, stats))
            else:
                p_fwd = self._plan(rx.reverse(ast))
                for o in np.nonzero(self._run_from(p_fwd, [subject]))[0]:
                    out.add((subject, int(o)))
        else:
            if null and subject == obj:
                out.add((subject, obj))
            elif plan.mode == "split":
                seeds = self._seed_subjects(plan, obj, stats)
                if subject in self._half_union(plan.split.left, seeds):
                    out.add((subject, obj))
            elif plan.mode == "reverse":
                if self._run_from(self._plan(rx.reverse(ast)),
                                  [subject])[obj]:
                    out.add((subject, obj))
            else:
                if self._run_from(self._plan(ast), [obj])[subject]:
                    out.add((subject, obj))
        if stats is not None:
            stats.results = len(out)
            stats.supersteps += self._superstep_acc - acc0
            stats.retraces += self.traces.retraces - tr0
            stats.epoch = self.epoch
            stats.result_cache_invalidations = self.results.invalidations
            stats.plan_cache_invalidations = self.decisions.invalidations
        return truncate_result(out, limit)

    def eval_many(
        self,
        queries: Sequence[QueryLike],
        batch_size: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> List[Set[Tuple[int, int]]]:
        """Answer a batch of queries; results match per-query :meth:`eval`.

        Every fixed-endpoint query becomes one row of a multi-source
        batched BFS — *including queries with different automata*: a
        single-plan batch shares one table (:meth:`_run_from_batched`), a
        mixed batch stacks per-row padded tables
        (:meth:`_run_hetero_rows`), so a 64-request batch over 16
        expressions costs 16 plan compilations and a handful of
        dispatches instead of 64 of each.  Finished answers land in the
        cross-request :class:`ResultCache`; replayed requests (and
        duplicates within the batch) skip evaluation entirely.

        ``deadline_s`` is a *batch-wide* budget, exactly like
        :meth:`RingRPQ.eval_many`: the coalesced rows and the delegated
        multi-stage queries share one absolute deadline, and exceeding
        it raises ``TimeoutError`` for the whole batch.
        """
        qs = [as_query(q) for q in queries]
        results: List[Optional[Set[Tuple[int, int]]]] = [None] * len(qs)
        deadline = (time.time() + deadline_s) if deadline_s else None
        prev_deadline = self._deadline
        self._deadline = deadline
        try:
            return self._eval_many_inner(qs, results, batch_size, deadline)
        finally:
            self._deadline = prev_deadline

    def _eval_many_inner(self, qs, results, batch_size, deadline):
        epoch = self.epoch

        # ANALYZE-tagged queries run individually under a private tracer
        # (the per-superstep timeline is per-query by construction) and
        # settle before the probe; they still share the batch deadline.
        if any(q.explain is not None for q in qs):
            from ..obs import explain as oexplain
            for i, q in enumerate(qs):
                if q.explain is None:
                    continue
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError("query deadline exceeded")
                report, res = oexplain.analyze_query(
                    self, q, deadline_s=remaining)
                oexplain.deliver(q.explain, report)
                results[i] = res
                # publish like any other settled query: the explain tag
                # is excluded from the cache key, so an untagged repeat
                # of the same query replays from the cache
                self.results.put(result_key(q), res,
                                 footprint=self._footprint(rx.parse(q.expr)),
                                 epoch=self.epoch)

        pending = probe_result_cache(self.results, qs, results)

        rows: List[Tuple[_DensePlan, int]] = []
        row_info: List[Tuple[Tuple, "rx.Node", str]] = []  # (key, ast, mode)
        for key, idxs in pending.items():
            q = qs[idxs[0]]
            ast = rx.parse(q.expr)
            qplan = self._decide(ast, q.subject is not None,
                                 q.obj is not None, None)
            if (q.subject is None and q.obj is None) \
                    or qplan.mode == "split":
                # multi-stage plans can't ride the single-BFS batch; the
                # result stays keyed on the ORIGINAL normalized AST +
                # endpoints, never the rewritten plan's expression.
                # They still draw on the shared batch deadline.
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError("query deadline exceeded")
                res = self._eval_inner(q.expr, q.subject, q.obj, q.limit,
                                       None)
                publish_result(self.results, key, res, idxs, results,
                               footprint=self._footprint(ast), epoch=epoch)
            elif q.obj is not None and q.subject is not None \
                    and qplan.mode == "reverse":
                # (s,E,o) from the subject side over ^E
                rows.append((self._plan(rx.reverse(ast)), q.subject))
                row_info.append((key, ast, "reverse"))
            elif q.obj is not None:
                # (x,E,o) and (s,E,o) both run backward from o
                rows.append((self._plan(ast), q.obj))
                row_info.append((key, ast, "forward"))
            else:                                          # (s, E, y)
                rows.append((self._plan(rx.reverse(ast)), q.subject))
                row_info.append((key, ast, "forward"))

        if rows:
            distinct = {id(plan) for plan, _ in rows}
            if len(distinct) == 1:
                hits = self._run_from_batched(rows[0][0],
                                              [start for _, start in rows],
                                              batch_size=batch_size)
            else:
                hits = self._run_hetero_rows(rows, batch_size=batch_size)
        for bi, (key, ast, mode) in enumerate(row_info):
            idxs = pending[key]
            q = qs[idxs[0]]
            null = rx.nullable(ast)
            out: Set[Tuple[int, int]] = set()
            if q.subject is None:                          # (x, E, o)
                if null:
                    out.add((q.obj, q.obj))
                out.update(zip(np.nonzero(hits[bi])[0].tolist(),
                               repeat(q.obj)))
            elif q.obj is None:                            # (s, E, y)
                if null:
                    out.add((q.subject, q.subject))
                out.update(zip(repeat(q.subject),
                               np.nonzero(hits[bi])[0].tolist()))
            else:                                          # (s, E, o)
                hit = hits[bi][q.obj] if mode == "reverse" \
                    else hits[bi][q.subject]
                if (null and q.subject == q.obj) or hit:
                    out.add((q.subject, q.obj))
            out = truncate_result(out, q.limit)
            publish_result(self.results, key, out, idxs, results,
                           footprint=self._footprint(ast), epoch=epoch)
        return results


class _DenseSlot:
    """One in-flight dense BFS under continuous batching: its own
    frontier/visited words on the engine's device between ticks, pinned
    to the :class:`Edges` epoch (arrays and grouped layout) of its
    admission and, on a sharded engine, to that epoch's shards (the
    executor's per-shard ``Edges`` rows)."""

    __slots__ = ("plan", "start", "edges", "shards", "S_pad", "frontier",
                 "visited", "active", "seen", "reported")

    def __init__(self, plan: _DensePlan, start: int, edges: Edges,
                 S_pad: int, num_nodes: int, device, shards=None):
        self.plan = plan
        self.start = start
        self.edges = edges
        self.shards = shards
        self.S_pad = S_pad
        words = torch.zeros((num_nodes, (S_pad + 31) // 32),
                            dtype=torch.int32, device=device)
        # no reachable non-eps final state: converged before the 1st step
        self.active = plan.g.F & ~1 != 0
        if self.active:
            words[start, :plan.g.nwords] = ops.words_to_tensor(
                _start_row(plan.g), device)
        self.frontier = words
        self.visited = words.clone()
        # the nodes reported so far, on the device and as a set
        self.seen = torch.zeros(num_nodes, dtype=torch.bool, device=device)
        self.reported: Set[int] = set()


class DenseStepper:
    """Externally-driven superstep executor over a dynamic slot set —
    the dense engine's half of the continuous-batching contract (the
    ring engine's is :class:`repro_torch.core.rpq.RingStepper`).

    Each :meth:`step` advances every active slot by up to
    ``steps_per_tick`` supersteps.  Slots are grouped by (edge-array
    snapshot, padded state width) and each group dispatches ONE
    :func:`bfs_rows` — on a sharded engine one
    ``ShardedDenseExec.step_rows`` over the mesh — with the group's row
    count padded to a power of two (min 4), so continuous
    admission/retirement reuses a bounded set of launch shapes.  The
    initial-state bit of ``visited`` only ever grows, which makes
    incremental result streaming sound.

    Version snapshots: ``add_job`` pins the :class:`Edges` epoch (the
    arrays and their grouped layout) the slot's BFS reads.
    ``submit_update`` builds the next epoch OFF TO THE SIDE
    (``_on_overlay_change`` constructs a fresh :class:`Edges`, never
    mutating old ones), so in-flight slots keep
    reading their admission epoch — at most two snapshots are live at
    once (draining + current), keeping the group count bounded.
    """

    def __init__(self, eng: DenseRPQ, steps_per_tick: int = 1):
        self.eng = eng
        self.steps_per_tick = max(1, int(steps_per_tick))
        self.slots: List[_DenseSlot] = []

    # -- admission / retirement --------------------------------------------
    def add_job(self, plan: _DensePlan, start: int,
                edges: Optional[Edges] = None) -> _DenseSlot:
        """Admit one backward BFS from ``start`` (before the next tick).
        ``edges`` pins the :class:`Edges` snapshot; default = the
        engine's current epoch."""
        eng = self.eng
        edges = edges if edges is not None else eng._edges()
        # the executor re-partitions on every mutation into new rows, so
        # the current ones are this epoch's for as long as the slot lives
        shards = eng.sharded._edges if eng.sharded is not None else None
        slot = _DenseSlot(plan, int(start), edges,
                          eng._pad_width(plan.g.m + 1),
                          eng.graph.num_nodes, eng.device, shards)
        self.slots.append(slot)
        return slot

    def finished(self, slot: _DenseSlot) -> bool:
        return not slot.active

    def remove_job(self, slot: _DenseSlot) -> None:
        slot.active = False
        try:
            self.slots.remove(slot)
        except ValueError:
            pass

    def reported(self, slot: _DenseSlot) -> Set[int]:
        """Nodes whose initial-state bit has activated so far —
        monotone, so callers stream the set difference per tick.  Only
        the nodes new since the last call cross to the host."""
        bit = (slot.visited[:, 0] & 1).bool()
        fresh = (bit & ~slot.seen).nonzero().reshape(-1)
        if fresh.numel():
            slot.seen |= bit
            slot.reported.update(fresh.cpu().tolist())
        return slot.reported

    # -- one tick -----------------------------------------------------------
    def step(self) -> bool:
        """Advance every active slot by up to ``steps_per_tick``
        supersteps (one dispatch per (snapshot, width) group).  Returns
        True while any slot still has a live frontier."""
        eng = self.eng
        groups: Dict[Tuple, List[_DenseSlot]] = {}
        for slot in self.slots:
            if slot.active:
                key = (id(slot.edges), slot.S_pad)
                groups.setdefault(key, []).append(slot)
        with otrace.span("dense.superstep", cat="engine",
                         slots=len(self.slots), groups=len(groups)):
            for (_ids, S_pad), members in groups.items():
                C = 4
                while C < len(members):
                    C *= 2
                plans = [s.plan for s in members] + \
                    [None] * (C - len(members))
                Bstk, PREDstk = eng._stack_tables(plans, S_pad)
                pad = [torch.zeros_like(members[0].frontier)] * \
                    (C - len(members))
                front = torch.stack([s.frontier for s in members] + pad)
                vis = torch.stack([s.visited for s in members] + pad)
                eng.traces.record("bfs_chunk_hetero", C, S_pad)
                if eng._use_sharded():
                    v, f, it = eng.sharded.step_rows(
                        Bstk, PREDstk, front, self.steps_per_tick, vis,
                        members[0].shards)
                else:
                    v, f, it = bfs_rows(
                        members[0].edges, Bstk, PREDstk, front,
                        self.steps_per_tick, visited=vis,
                        span={"rows": C, "width": S_pad,
                              "live": len(members)})
                eng.hetero_dispatches += 1
                eng._superstep_acc += it
                alive = f.reshape(C, -1).any(dim=1).tolist()
                for r, slot in enumerate(members):
                    slot.frontier = f[r]
                    slot.visited = v[r]
                    slot.active = alive[r]
        return any(s.active for s in self.slots)
