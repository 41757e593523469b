"""Paper-faithful 2RPQ evaluation on the ring (Sec. 4).

Backward traversal of the query-induced product subgraph G'_E, organized
as **frontier-synchronous wavefront supersteps**: each superstep takes the
whole current frontier of (L_p range, D) entries and runs

  part 1 (Sec. 4.1): enumerates the distinct predicates of every range via
     the L_p wavelet tree, pruning subtree v when D & B[v] == 0
     (Fact 1 confines the symbol filter to B).  This produces the
     superstep's *task list* — one (subject-range, D & B[p]) per
     (entry, predicate) pair;
  part 1.5: the bit-parallel transition D -> T'[D & B[p]] is applied to
     the entire task list at once — either through the ``nfa_step``
     kernel (one batched CUDA launch on packed uint32 words) or scalar
     byte-split tables for tiny wavefronts (``kernel_threshold``);
  part 2 (Sec. 4.2): for each task, the L_s wavelet tree enumerates
     distinct subjects, pruning with visited-state masks (D steps *once
     per predicate* — Fact 1 again: same D for every subject in a range);
  part 3 (Sec. 4.3): each new subject s maps back to the object range
     L_p[C_o[s] : C_o[s+1]) and joins the next wavefront.

Task order within a superstep equals the FIFO order of the original
per-entry deque, so visited-mask evolution — and therefore results and
``QueryStats.node_state_activations`` — are identical to the sequential
traversal (``wavefront=False`` processes one entry per superstep and is
the reference).  Only part 1.5 is batched; its inputs depend on nothing
mutable, which is what makes the phase split sound.

Heterogeneous batching (``eval_many``): several queries — with
*different* automata — run as one superstep stream.  Each frontier entry
carries its job (query), visited masks and wavelet-tree prunes stay
per-job, and part 1.5 steps the merged task list through ONE
``kernels/nfa_step`` call by lifting every task's mask into the
:class:`~repro_torch.core.engines.PlanBundle`'s block-diagonal state space
(plan i's states at bit offset_i; transitions never cross blocks).
Because jobs share no mutable state and per-job task order equals the
solo FIFO order, every job's results and traversal work counters
(activations, supersteps, enumerations) are identical to its solo
``eval``; only ``kernel_batches``/``kernel_tasks`` differ, since the
kernel-vs-scalar threshold is decided on the *merged* task list the jobs
actually share.

Above the traversal machinery sits the cost-based planner
(:mod:`repro_torch.core.planner`): per (expression, endpoint-binding) class it
chooses the ``forward`` native direction, a ``reverse`` plan seeded from
the other endpoint over the reversed automaton, or a ``split`` plan that
cuts ``E = A/p/B`` at a rare mandatory predicate, seeds from p's edge
occurrences, and joins two half-traversals (union halves run as ONE
multi-seed job with shared visited masks; the unanchored join keeps
per-endpoint jobs, all bundled into one lockstep wavefront).  Decisions
are memoized per canonical AST + binding in the ``decisions`` cache and
recorded in ``QueryStats.plan_*``; ``planner="naive"`` bypasses the
planner entirely and is the parity reference.

Live updates (:mod:`repro_torch.core.delta`): with a mutation overlay set,
every frontier entry keys both its base L_p range and the overlay's
delta adjacency for its object — the inserted edges become extra tasks
in the SAME part-1.5 ``nfa_step`` batch, and tombstoned base triples are
masked out during part-2 subject enumeration (per (s, p, obj) for
single-object ranges; for the full range a subject drops only when all
its base triples under the predicate are tombstoned, and covered-node
Dv caching is suppressed while a predicate has tombstones so the cached
intersections never claim a delivery a skipped leaf did not get).
Results at every epoch equal a from-scratch rebuild of the effective
triple set; see ``add_edges``/``remove_edges``/``compact``.

A subject is reported when the initial NFA state activates.  Visited-mask
soundness note: the paper stores at every internal L_s node v a mask D[v]
(the intersection of leaf masks below) and updates it with D[v] |= D on
every descent.  When the query interval covers v only *partially* that
update can inflate D[v] above the true intersection and over-prune a
later traversal, so we update internal masks only when the interval spans
the whole node (leaf masks, which carry the actual Theorem-4.1 work
bound, are always exact).  ``paper_dv=True`` restores the literal rule
for comparison.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import delta as dl
from . import planner as qp
from . import regex as rx
from ..kernels import ops
from ..obs import trace as otrace
from .engines import (PlanBundle, PlanCache, QueryLike, QueryStats,
                      ResultCache, TraceTracker, as_query, normalized_key,
                      probe_result_cache, publish_result, result_key,
                      truncate_result)
from .glushkov import Glushkov
from .ring import Ring
from .stats import GraphStats

__all__ = ["QueryStats", "RingRPQ"]  # QueryStats re-exported (engines.py)


_isin = qp.isin_mask


@dataclass
class _RingPlan:
    """Compiled ring-side query plan: automaton + lazy B[v] mask table."""

    g: Glushkov
    Bv: Dict[Tuple[int, int], int]


@dataclass
class _Task:
    """One wavefront-superstep transition task.

    A *base* task is an L_s subject range ``[sb, se)`` under completed
    predicate ``pred`` (``obj`` is the frontier entry's object, ``None``
    for the full range — tombstone masking needs it).  A *delta* task
    carries its ``subjects`` directly: the overlay's inserted adjacency
    for (pred, obj).  Both kinds share the same ``masked = D & B[p]``
    input and ride the same batched ``nfa_step`` dispatch — the delta
    pass is ORed into the superstep, not a separate traversal."""

    job: _Job
    masked: int
    pred: int
    obj: Optional[int]
    sb: int = 0
    se: int = 0
    subjects: Optional[List[int]] = None


@dataclass
class _Job:
    """One traversal of the multi-job wavefront (``_traverse_many``).

    ``start_obj`` seeds one object; ``start_objs`` seeds several with a
    shared visited mask (union semantics — a split plan's half-traversal
    from all surviving seed endpoints); both ``None`` = the full range.

    There is deliberately no ``limit`` early exit: a limited answer is
    the *sorted prefix* of the full set (:func:`truncate_result`), and
    the first k subjects in traversal order are not the k smallest —
    stopping early would make limited answers disagree across engines.
    Only the exact ``target`` membership exit remains.

    ``ring``/``ov`` are the job's *version snapshot*, pinned at
    admission by :meth:`RingStepper.add_job`: a continuously-batched
    job keeps reading the ring and overlay of its admission epoch even
    while ``submit_update`` swaps the engine's live overlay (or
    ``compact`` swaps the ring) for later admissions — multi-version
    serving with per-job snapshot isolation.
    """

    plan: _RingPlan
    start_obj: Optional[int]
    stats: QueryStats
    target: Optional[int] = None
    start_objs: Optional[Sequence[int]] = None
    offset: int = 0                     # block-diagonal bit offset
    done: bool = False
    Ds: Dict[int, int] = field(default_factory=dict)
    Dv: Dict[Tuple[int, int], int] = field(default_factory=dict)
    reported: Set[int] = field(default_factory=set)
    ring: Optional[Ring] = None         # version snapshot (see above)
    ov: Optional[dl.DeltaOverlay] = None


class RingRPQ(dl.LiveUpdateEngine):
    """2RPQ engine over a :class:`Ring` (the paper's algorithm).

    ``wavefront=True`` (default) runs the superstep-batched traversal;
    ``False`` processes one frontier entry at a time (the sequential
    reference — same visit order, same results, same work counters).
    ``kernel_threshold``: minimum wavefront task count that dispatches the
    NFA transition through the ``nfa_step`` kernel; ``None`` auto-resolves
    (64 on a CUDA device, scalar tables on the CPU, where the kernel's
    plain PyTorch version loses to them at any size).

    ``device``: where the kernel runs — ``"cuda"`` by default, and
    construction raises :class:`RuntimeError` when no CUDA device is
    present; ``"cpu"`` only when the caller asks for it (the plain
    PyTorch version of every kernel stands in).

    ``planner``: "cost" (default) consults the cost-based planner
    (:mod:`repro_torch.core.planner`) per query class and may run a
    ``reverse`` or ``split`` physical plan; "forward"/"reverse"/"split"
    force one shape (falling back to forward when inapplicable);
    "naive" opts out entirely — exactly the pre-planner behavior, kept
    as the parity reference.  ``stats``: injectable
    :class:`~repro_torch.core.stats.GraphStats` (e.g. restored from a
    checkpoint); harvested from the ring on first use otherwise.

    Sharding (``mesh=``/``shards=``) is not ported yet and raises
    :class:`NotImplementedError`.
    """

    def __init__(self, ring: Ring, paper_dv: bool = False,
                 wavefront: bool = True,
                 kernel_threshold: Optional[int] = None,
                 result_cache: Optional[ResultCache] = None,
                 planner: str = "cost",
                 stats: Optional[GraphStats] = None,
                 mesh=None, shards: Optional[int] = None,
                 compact_threshold: Optional[int] =
                 dl.DEFAULT_COMPACT_THRESHOLD,
                 device=None):
        if mesh is not None or shards is not None:
            raise NotImplementedError(
                "sharded ring execution is not ported yet "
                "(ROADMAP queue 1, item 8)")
        self.device = ops.resolve_device(device)
        if planner not in ("cost", "naive", "forward", "reverse", "split"):
            raise ValueError(f"unknown planner policy {planner!r}")
        self.ring = ring
        self.paper_dv = paper_dv
        self.wavefront = wavefront
        self.kernel_threshold = kernel_threshold
        self.planner = planner
        self.plans = PlanCache()
        self.decisions = PlanCache()
        self.results = result_cache if result_cache is not None else ResultCache()
        self.delta: Optional[dl.DeltaOverlay] = None   # live-update overlay
        self.compact_threshold = compact_threshold
        self.compactions = 0
        self.traces = TraceTracker()     # distinct kernel dispatch signatures
        self.bundle_kernel_batches = 0   # multi-plan nfa_step dispatches
        self._auto_threshold: Optional[float] = None
        self._stats = stats
        self._edge_s: Optional[np.ndarray] = None   # completed triples,
        self._edge_o: Optional[np.ndarray] = None   # predicate-major order
        self._edge_eff: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._bwd_dev: Dict[int, tuple] = {}  # id(table) -> (host, device)

    @property
    def graph_stats(self) -> GraphStats:
        """Selectivity statistics for the planner (lazy; injectable).
        With a live overlay, a fresh harvest reads the static ring, so
        every predicate the overlay ever touched is refreshed from the
        effective edges before first use."""
        if self._stats is None:
            self._stats = GraphStats.from_ring(self.ring)
            self._refresh_touched_stats()
        return self._stats

    # -- live updates (surface shared via delta.LiveUpdateEngine) ------------
    def _base_graph(self):
        return self.ring.graph

    def _on_overlay_change(self, mutated_raw) -> None:
        """Engine-side cache drops after a mutation batch: the
        predicate-major seed-edge memo is rebuilt lazily against the new
        overlay (the wavefront itself reads the overlay live)."""
        self._edge_eff = {}

    def compact(self) -> None:
        """Fold the overlay into a fresh :class:`Ring` + statistics.
        Logical no-op: results, the epoch counter, and surviving cache
        entries are unchanged — only the physical base moves."""
        if self.delta is None or self.delta.size == 0:
            return
        graph = self.effective_graph()
        self.ring = Ring(graph)
        s, p, o = graph.completed_triples()
        self.delta.reset_after_compaction(
            dl.pack_keys(s, p, o, graph.num_nodes, 2 * graph.num_preds))
        self._edge_s = self._edge_o = None
        self._edge_eff = {}
        if self._stats is not None:
            self._stats = GraphStats.from_ring(self.ring)
        self.compactions += 1

    # -- public API ----------------------------------------------------------
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

        Returns the set of (s, o) node-id pairs (Sec. 3.1 semantics; for
        fixed endpoints the pair is still reported if a path exists).
        ``deadline_s``: per-query timeout (the paper's experimental setup
        uses 60 s) — raises TimeoutError.
        """
        ast = rx.parse(expr)
        return self.eval_ast(ast, subject, obj, limit, stats, deadline_s)

    def explain(self, query, analyze: bool = False,
                deadline_s: Optional[float] = None) -> Dict:
        """Structured plan report for ``query`` (see
        :mod:`repro_torch.obs.explain`).  ``analyze=False`` never executes a
        superstep; ``analyze=True`` runs the query under a private
        tracer and attaches the per-superstep timeline."""
        from ..obs import explain as oexplain
        return oexplain.explain_query(self, query, analyze=analyze,
                                      deadline_s=deadline_s)

    def eval_many(
        self,
        queries: Sequence[QueryLike],
        deadline_s: Optional[float] = None,
        stats_out: Optional[List[QueryStats]] = None,
    ) -> List[Set[Tuple[int, int]]]:
        """Answer a batch of queries; results match per-query :meth:`eval`.

        Fixed-endpoint queries — even with *different* expressions — run
        as one multi-job wavefront (``_traverse_many``): their frontiers
        advance in lockstep supersteps and every superstep's merged task
        list takes the bit-parallel transition in a single batch through
        the block-diagonal plan bundle.  The batch shares the plan cache
        and consults the cross-request :class:`ResultCache` first;
        duplicate requests inside the batch collapse onto one job.

        ``deadline_s`` is a *batch-wide* budget (unlike :meth:`eval`,
        where it is per-query): the coalesced wavefront and the
        delegated (x,E,y) queries all share one absolute deadline, and
        exceeding it raises TimeoutError for the whole batch — the right
        unit for an admission bucket with one latency budget.
        """
        import time as _time
        qs = [as_query(q) for q in queries]
        results: List[Optional[Set[Tuple[int, int]]]] = [None] * len(qs)
        epoch = self.epoch
        stats_list = [QueryStats(
            epoch=epoch,
            result_cache_invalidations=self.results.invalidations,
            plan_cache_invalidations=self.decisions.invalidations,
        ) for _ in qs]
        tr0 = self.traces.retraces
        deadline = (_time.time() + deadline_s) if deadline_s else None

        def on_hit(idx, cached):
            stats_list[idx].result_cache_hits += 1
            stats_list[idx].results = len(cached)

        def on_miss(idx):
            stats_list[idx].result_cache_misses += 1

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
                    remaining = deadline - _time.time()
                    if remaining <= 0:
                        raise TimeoutError("query deadline exceeded")
                report, res = oexplain.analyze_query(
                    self, q, stats=stats_list[i], deadline_s=remaining)
                oexplain.deliver(q.explain, report)
                results[i] = res
                # publish like any other settled query: the explain tag
                # is excluded from the cache key, so an untagged repeat
                # of the same query replays from the cache
                self.results.put(result_key(q), res,
                                 footprint=self._footprint(rx.parse(q.expr)),
                                 epoch=self.epoch)

        pending = probe_result_cache(self.results, qs, results,
                                     on_hit=on_hit, on_miss=on_miss)

        jobs = []   # (cache key, query, ast, job)
        for key, idxs in pending.items():
            q = qs[idxs[0]]
            stats = stats_list[idxs[0]]
            ast = rx.parse(q.expr)
            qplan = self._decide(ast, q.subject is not None,
                                 q.obj is not None, stats)
            if (q.subject is None and q.obj is None) \
                    or qplan.mode == "split":
                # (x, E, y) two-phase and split plans have a second
                # stage that depends on the first stage's output, so
                # they cannot join the lockstep wavefront — but they
                # still draw on the shared batch deadline.  The result
                # is keyed on the ORIGINAL normalized AST + endpoints
                # (``key``), never the rewritten plan's expression.
                remaining = None
                if deadline is not None:
                    remaining = deadline - _time.time()
                    if remaining <= 0:
                        raise TimeoutError("query deadline exceeded")
                res = self.eval_ast(ast, q.subject, q.obj, q.limit, stats,
                                    remaining)
                publish_result(self.results, key, res, idxs, results,
                               footprint=self._footprint(ast), epoch=epoch)
                continue
            null = rx.nullable(ast)
            if q.subject is not None and q.obj is not None:
                if null and q.subject == q.obj:
                    res = {(q.subject, q.obj)}
                    stats.results = len(res)
                    res = truncate_result(res, q.limit)
                    publish_result(self.results, key, res, idxs, results,
                                   footprint=self._footprint(ast),
                                   epoch=epoch)
                    continue
                if qplan.mode == "reverse":
                    plan, start, tgt = (self._plan(rx.reverse(ast)),
                                        q.subject, q.obj)
                elif qplan.mode == "forward":
                    plan, start, tgt = self._plan(ast), q.obj, q.subject
                else:                                     # naive
                    p_bwd = self._plan(ast)
                    p_fwd = self._plan(rx.reverse(ast))
                    if self._start_cost(p_bwd.g) <= self._start_cost(p_fwd.g):
                        plan, start, tgt = p_bwd, q.obj, q.subject
                    else:
                        plan, start, tgt = p_fwd, q.subject, q.obj
                job = _Job(plan=plan, start_obj=start, stats=stats,
                           target=tgt)
            elif q.obj is not None:                       # (x, E, o)
                job = _Job(plan=self._plan(ast), start_obj=q.obj,
                           stats=stats)
            else:                                         # (s, E, y)
                job = _Job(plan=self._plan(rx.reverse(ast)),
                           start_obj=q.subject, stats=stats)
            stats.plan_actual_frontier = 1
            jobs.append((key, q, ast, job))

        if jobs:
            self._traverse_many([j for (_, _, _, j) in jobs],
                                deadline=deadline)
        for key, q, ast, job in jobs:
            null = rx.nullable(ast)
            out: Set[Tuple[int, int]] = set()
            if q.subject is not None and q.obj is not None:
                if job.target in job.reported:
                    out.add((q.subject, q.obj))
            elif q.obj is not None:
                if null:
                    out.add((q.obj, q.obj))
                out.update((s, q.obj) for s in job.reported)
            else:
                if null:
                    out.add((q.subject, q.subject))
                out.update((q.subject, o) for o in job.reported)
            job.stats.results = len(out)
            out = truncate_result(out, q.limit)
            publish_result(self.results, key, out, pending[key], results,
                           footprint=self._footprint(ast), epoch=epoch)

        # batch-wide attribution: the coalesced wavefront dispatches
        # jointly, so each row reports the batch's new-signature count
        retr = self.traces.retraces - tr0
        for st in stats_list:
            st.retraces = retr
        if stats_out is not None:
            stats_out.extend(stats_list)
        return results

    def eval_ast(self, ast, subject=None, obj=None, limit=None, stats=None,
                 deadline_s=None):
        import time as _time
        self._deadline = (_time.time() + deadline_s) if deadline_s else None
        if stats is None:
            stats = QueryStats()
        stats.epoch = self.epoch
        stats.result_cache_invalidations = self.results.invalidations
        stats.plan_cache_invalidations = self.decisions.invalidations
        tr0 = self.traces.retraces
        V = self.ring.num_nodes
        out: Set[Tuple[int, int]] = set()
        null = rx.nullable(ast)
        plan = self._decide(ast, subject is not None, obj is not None, stats)

        if subject is None and obj is None:
            # (x, E, y) — Sec. 4.4 two-phase strategy (or a planner
            # rewrite: objects-first two-phase, or the rare-predicate
            # split — both return the same pairs)
            if null:
                out.update((v, v) for v in range(V))
            if plan.mode == "split":
                out.update(self._split_unanchored(plan, stats))
            elif plan.mode == "reverse":
                out.update(self._unanchored_reverse(ast, stats))
            else:
                # phase 1: from the full L_p range, find subjects reaching
                # *some* object...
                p_bwd = self._plan(ast)
                sources = self._traverse(
                    p_bwd, start_obj=None, stats=stats
                )
                stats.plan_actual_frontier = len(sources)
                # phase 2: from each such subject, run (s, E, y)
                p_fwd = self._plan(rx.reverse(ast))
                for s in sorted(sources):
                    objs = self._traverse(
                        p_fwd, start_obj=s, stats=stats
                    )
                    out.update((s, o) for o in objs)
                    # exact early exit for the sorted-prefix limit rule:
                    # sources ascend and (non-null) every pair collected
                    # so far has first component <= s, so all remaining
                    # pairs sort strictly after the k we already hold
                    if limit is not None and not null and len(out) >= limit:
                        break
        elif subject is None:
            # (x, E, o): backward from o
            if null:
                out.add((obj, obj))
            if plan.mode == "split":
                out.update((s, obj) for s in
                           self._split_from_obj(plan, obj, stats))
            else:
                p_bwd = self._plan(ast)
                srcs = self._traverse(p_bwd, start_obj=obj, stats=stats)
                stats.plan_actual_frontier = 1
                out.update((s, obj) for s in srcs)
        elif obj is None:
            # (s, E, y) == (y, ^E, s) backward from s
            if null:
                out.add((subject, subject))
            if plan.mode == "split":
                out.update((subject, o) for o in
                           self._split_from_subj(plan, subject, stats))
            else:
                p_fwd = self._plan(rx.reverse(ast))
                objs = self._traverse(p_fwd, start_obj=subject, stats=stats)
                stats.plan_actual_frontier = 1
                out.update((subject, o) for o in objs)
        else:
            # (s, E, o) both fixed: the planner picks the start endpoint
            # ("naive" keeps the Sec.-5 heuristic: start from the end
            # whose adjacent predicates have the smallest cardinality,
            # O(1) C_p reads); early-exit on the target
            if null and subject == obj:
                out.add((subject, obj))
            elif plan.mode == "split":
                if self._split_both(plan, subject, obj, stats):
                    out.add((subject, obj))
            else:
                if plan.mode == "reverse":
                    p, start, tgt = self._plan(rx.reverse(ast)), subject, obj
                elif plan.mode == "forward":
                    p, start, tgt = self._plan(ast), obj, subject
                else:                                          # naive
                    p_bwd = self._plan(ast)
                    p_fwd = self._plan(rx.reverse(ast))
                    if self._start_cost(p_bwd.g) <= self._start_cost(p_fwd.g):
                        p, start, tgt = p_bwd, obj, subject
                    else:
                        p, start, tgt = p_fwd, subject, obj
                found = self._traverse(p, start_obj=start, stats=stats,
                                       target=tgt)
                stats.plan_actual_frontier = 1
                if tgt in found:
                    out.add((subject, obj))
        stats.results = len(out)
        stats.retraces += self.traces.retraces - tr0
        return truncate_result(out, limit)

    # -- internals -------------------------------------------------------------
    def _start_cost(self, g: Glushkov) -> int:
        """Sum of cardinalities of the predicates adjacent to the final
        states — the edges the *first* backward step can touch (Sec. 5
        planning heuristic; C_p lookups are O(1))."""
        total = 0
        for p in g.last_labels():
            if 0 <= p < self.ring.num_preds_completed:
                total += self.ring.pred_cardinality(p)
        return total

    def _resolve_lit(self, lit: rx.Lit) -> int:
        return self.ring.graph.resolve_lit(lit)

    def _automaton(self, ast) -> Glushkov:
        return Glushkov.from_ast(ast, self._resolve_lit)

    def _plan(self, ast) -> _RingPlan:
        """Automaton + B[v] table for ``ast``, shared via the plan cache
        (keyed by the canonical AST, so equivalent spellings share)."""

        def build():
            g = self._automaton(ast)
            return _RingPlan(g=g, Bv=self._build_Bv(g))

        return self.plans.get(normalized_key(ast), build)

    def _decide(self, ast, subject_bound: bool, obj_bound: bool,
                stats: QueryStats) -> qp.Plan:
        """Planner decision for this (expression, binding) class, memoized
        in the ``decisions`` PlanCache; records the choice in ``stats``."""
        return qp.decide(ast, subject_bound, obj_bound,
                         policy=self.planner, decisions=self.decisions,
                         stats_provider=lambda: self.graph_stats,
                         resolve=self._resolve_lit, record=stats,
                         footprint=self._footprint(ast))

    # -- split / reverse plan execution ----------------------------------------
    def _pred_edges_base(self, p: int) -> Tuple[np.ndarray, np.ndarray]:
        """(subjects, objects) of the *base* completed triples labeled
        ``p``.  Materialized predicate-major on first use; C_p gives the
        block offsets."""
        if self._edge_s is None:
            s, pa, o = self.ring.triples_completed()
            order = np.argsort(pa, kind="stable")
            self._edge_s, self._edge_o = s[order], o[order]
        if not (0 <= p < self.ring.num_preds_completed):
            z = np.zeros(0, dtype=np.int64)
            return z, z
        b, e = self.ring.pred_range(p)
        return self._edge_s[b:e], self._edge_o[b:e]

    def _half_union(self, side_ast, seeds, stats: QueryStats,
                    reverse: bool = False,
                    target: Optional[int] = None) -> Set[int]:
        """Union half-traversal of a split plan: nodes related to *some*
        seed through ``side_ast`` (reversed for the subject-side half),
        including the seeds themselves when the half matches the empty
        word.  One multi-seed job — shared visited masks, since only the
        union matters.  Always runs to completion: a limited answer is
        the sorted prefix of the full set (:func:`truncate_result`), so
        stopping at the first k reported nodes would be wrong."""
        seeds = [int(x) for x in seeds]
        if side_ast is None:
            return set(seeds)
        ast = rx.reverse(side_ast) if reverse else side_ast
        job = _Job(plan=self._plan(ast), start_obj=None, stats=stats,
                   target=target, start_objs=seeds)
        self._traverse_many([job], deadline=getattr(self, "_deadline", None))
        out = set(job.reported)
        if rx.nullable(side_ast):
            out.update(seeds)
        return out

    def _split_from_obj(self, plan: qp.Plan, obj: int,
                        stats: QueryStats) -> Set[int]:
        """(x, E=A/p/B, o): subjects s with s -A-> sp -p-> op -B-> o.
        Right half from o confines the seed edges; left half is one
        union traversal from the surviving subjects of p."""
        sp = plan.split
        sarr, oarr = self._pred_edges(plan.split_pred)
        if sarr.size == 0:
            stats.plan_actual_frontier = 0
            return set()
        U = self._half_union(sp.right, [obj], stats)
        keep = _isin(oarr, U)
        stats.plan_actual_frontier = int(keep.sum())
        seeds = np.unique(sarr[keep])
        if seeds.size == 0:
            return set()
        return self._half_union(sp.left, seeds, stats)

    def _split_from_subj(self, plan: qp.Plan, subject: int,
                         stats: QueryStats) -> Set[int]:
        """(s, E=A/p/B, y): objects o with s -A-> sp -p-> op -B-> o."""
        sp = plan.split
        sarr, oarr = self._pred_edges(plan.split_pred)
        if sarr.size == 0:
            stats.plan_actual_frontier = 0
            return set()
        Vs = self._half_union(sp.left, [subject], stats, reverse=True)
        keep = _isin(sarr, Vs)
        stats.plan_actual_frontier = int(keep.sum())
        ops = np.unique(oarr[keep])
        if ops.size == 0:
            return set()
        return self._half_union(sp.right, ops, stats, reverse=True)

    def _split_both(self, plan: qp.Plan, subject: int, obj: int,
                    stats: QueryStats) -> bool:
        """(s, E=A/p/B, o): does any seed edge connect the halves?"""
        sp = plan.split
        sarr, oarr = self._pred_edges(plan.split_pred)
        if sarr.size == 0:
            stats.plan_actual_frontier = 0
            return False
        U = self._half_union(sp.right, [obj], stats)
        keep = _isin(oarr, U)
        stats.plan_actual_frontier = int(keep.sum())
        seeds = np.unique(sarr[keep])
        if seeds.size == 0:
            return False
        return subject in self._half_union(sp.left, seeds, stats,
                                           target=subject)

    def _split_unanchored(self, plan: qp.Plan,
                          stats: QueryStats) -> Set[Tuple[int, int]]:
        """(x, E=A/p/B, y): meet in the middle at p's edge occurrences.
        Per-endpoint half-traversals (one lockstep wavefront for ALL of
        them, left and right plans bundled block-diagonally) joined
        through the seed edges — answer pairs need the SAME edge, so the
        halves stay grouped by endpoint, unlike the union case."""
        sp = plan.split
        sarr, oarr = self._pred_edges(plan.split_pred)
        stats.plan_actual_frontier = int(sarr.size)
        if sarr.size == 0:
            return set()
        jobs: List[_Job] = []
        left_jobs: Dict[int, _Job] = {}
        if sp.left is not None:
            lplan = self._plan(sp.left)
            for u in np.unique(sarr).tolist():
                left_jobs[u] = _Job(plan=lplan, start_obj=u, stats=stats)
                jobs.append(left_jobs[u])
        right_jobs: Dict[int, _Job] = {}
        if sp.right is not None:
            rplan = self._plan(rx.reverse(sp.right))
            for u in np.unique(oarr).tolist():
                right_jobs[u] = _Job(plan=rplan, start_obj=u, stats=stats)
                jobs.append(right_jobs[u])
        if jobs:
            self._traverse_many(jobs,
                                deadline=getattr(self, "_deadline", None))
        lnull = sp.left is not None and rx.nullable(sp.left)
        rnull = sp.right is not None and rx.nullable(sp.right)
        out: Set[Tuple[int, int]] = set()
        lmemo: Dict[int, Tuple[int, ...]] = {}
        rmemo: Dict[int, Tuple[int, ...]] = {}
        for u, v in zip(sarr.tolist(), oarr.tolist()):
            L = lmemo.get(u)
            if L is None:
                if sp.left is None:
                    L = (u,)
                else:
                    ls = set(left_jobs[u].reported)
                    if lnull:
                        ls.add(u)
                    L = tuple(ls)
                lmemo[u] = L
            R = rmemo.get(v)
            if R is None:
                if sp.right is None:
                    R = (v,)
                else:
                    rs = set(right_jobs[v].reported)
                    if rnull:
                        rs.add(v)
                    R = tuple(rs)
                rmemo[v] = R
            for a in L:
                for b in R:
                    out.add((a, b))
        return out

    def _unanchored_reverse(self, ast,
                            stats: QueryStats) -> Set[Tuple[int, int]]:
        """(x, E, y) objects-first: phase 1 enumerates the objects (the
        subjects of ^E), phase 2 completes every object from its own side
        — batched as one multi-job wavefront instead of a per-source
        loop.  Wins when distinct objects are the scarce side."""
        objs = sorted(self._traverse(self._plan(rx.reverse(ast)),
                                     start_obj=None, stats=stats))
        stats.plan_actual_frontier = len(objs)
        p_bwd = self._plan(ast)
        jobs = [_Job(plan=p_bwd, start_obj=o, stats=stats) for o in objs]
        if jobs:
            self._traverse_many(jobs,
                                deadline=getattr(self, "_deadline", None))
        out: Set[Tuple[int, int]] = set()
        for o, job in zip(objs, jobs):
            out.update((s, o) for s in job.reported)
        return out

    def _build_Bv(self, g: Glushkov) -> Dict[Tuple[int, int], int]:
        """Sparse B[v] masks for the L_p wavelet-tree nodes (Sec. 4.1):
        B[v] = OR of B[p] for query predicates p below v.  Lazy: only
        ancestors of the O(m) query predicates are materialized."""
        levels = self.ring.wt_p.levels
        Bv: Dict[Tuple[int, int], int] = {}
        for p, mask in g.B.items():
            if not (0 <= p < self.ring.num_preds_completed):
                continue
            for l in range(levels + 1):
                key = (l, p >> (levels - l))
                Bv[key] = Bv.get(key, 0) | mask
        return Bv

    # -- wavefront transition batching -----------------------------------------
    def _resolve_threshold(self) -> float:
        if self.kernel_threshold is not None:
            return self.kernel_threshold
        if self._auto_threshold is None:
            # the plain version on the host loses to the byte-split
            # tables at any size; on the card the kernel pays off quickly
            self._auto_threshold = 64.0 if self.device.type == "cuda" \
                else float("inf")
        return self._auto_threshold

    def _nfa_step_batch(self, X: np.ndarray, bwd: np.ndarray) -> np.ndarray:
        """Dispatch one packed task batch through ``kernels/nfa_step`` on
        ``self.device``: the uint32 words cross as int32 views, and the
        result comes back as uint32."""
        self.traces.record("nfa_step", X.shape[0], X.shape[1])
        with otrace.span("ring.nfa_step", cat="kernel",
                         tasks=int(X.shape[0]), words=int(X.shape[1])):
            # the packed table is identical across a traversal's
            # supersteps (memoized per plan/bundle) — ship it to the
            # device once, not per dispatch; key on id() while holding
            # the host array alive so the id cannot be reused
            cached = self._bwd_dev.get(id(bwd))
            if cached is None:
                cached = (bwd, ops.words_to_tensor(bwd, self.device))
                self._bwd_dev[id(bwd)] = cached
                while len(self._bwd_dev) > 64:   # bundles churn per batch
                    self._bwd_dev.pop(next(iter(self._bwd_dev)))
            Y = ops.nfa_step(ops.words_to_tensor(X, self.device), cached[1])
            return ops.tensor_to_words(Y)

    def _transition_many(self, tasks: List[_Task],
                         bundle: PlanBundle) -> List[int]:
        """T'[mask] for every wavefront task — one batched ``nfa_step``
        call for the whole (possibly multi-plan) task list, or scalar
        byte-split tables below threshold.  Base and delta tasks ride the
        same batch: the transition sees only ``masked``.

        Multi-plan batches go through the bundle: each task's mask is
        lifted by its job's block offset, the kernel steps through the
        block-diagonal combined table, and the result shifts back down —
        plan-exact because transitions never cross blocks.
        """
        if not tasks:
            return []
        masks = [t.masked for t in tasks]
        if len(masks) < self._resolve_threshold():
            return [t.job.plan.g.Tp(m) for t, m in zip(tasks, masks)]
        single_plan = all(t.job.plan is tasks[0].job.plan for t in tasks)
        if single_plan:
            g = tasks[0].job.plan.g
            W = g.nwords
            X = np.zeros((len(masks), W), dtype=np.uint32)
            for i, m in enumerate(masks):
                for w in range(W):
                    X[i, w] = (m >> (32 * w)) & 0xFFFFFFFF
            Y = self._nfa_step_batch(X, g.packed_bwd())
            shifts = None
        else:
            if "packed_bwd" not in bundle.extras:
                from ..kernels.nfa_step import pack_block_diagonal
                # dynamic bundles have freed-slot holes (plan is None) and
                # a pow2-padded packed width so slot churn keeps compiled
                # kernel signatures bounded; static bundles are unchanged
                # (live_plans == plans, padded_total == S_total)
                live = bundle.live_plans()
                bundle.extras["packed_bwd"] = pack_block_diagonal(
                    [p.g.pred_mask for p, _ in live],
                    [off for _, off in live], bundle.padded_total)
            W = (bundle.padded_total + 31) // 32
            X = np.zeros((len(masks), W), dtype=np.uint32)
            shifts = [t.job.offset for t in tasks]
            for i, (m, off) in enumerate(zip(masks, shifts)):
                lifted = m << off
                for w in range(W):
                    X[i, w] = (lifted >> (32 * w)) & 0xFFFFFFFF
            Y = self._nfa_step_batch(X, bundle.extras["packed_bwd"])
            self.bundle_kernel_batches += 1
        counted = set()
        for t in tasks:
            job = t.job
            if id(job) not in counted:
                counted.add(id(job))
                job.stats.kernel_batches += 1
            job.stats.kernel_tasks += 1
        out = []
        for i in range(len(masks)):
            acc = 0
            for w in range(W):
                acc |= int(Y[i, w]) << (32 * w)
            if shifts is not None:
                job = tasks[i].job
                acc = (acc >> shifts[i]) & ((1 << (job.plan.g.m + 1)) - 1)
            out.append(acc)
        return out

    def _traverse(
        self,
        plan: _RingPlan,
        start_obj: Optional[int],
        stats: QueryStats,
        target: Optional[int] = None,
    ) -> Set[int]:
        """Backward wavefront BFS (Secs. 4.1–4.3).  ``start_obj=None``
        starts from the full L_p range (Sec. 4.4).  Returns reported
        subjects.  One-job wrapper over :meth:`_traverse_many` — the
        multi-job stream with a single job is step-for-step identical."""
        job = _Job(plan=plan, start_obj=start_obj, stats=stats,
                   target=target)
        self._traverse_many([job], deadline=getattr(self, "_deadline", None))
        return job.reported

    def make_stepper(self) -> "RingStepper":
        """A continuously-batchable superstep executor over this engine
        — the slot scheduler's entry point (see
        :mod:`repro_torch.core.scheduler`)."""
        return RingStepper(self)

    def _traverse_many(self, jobs: List[_Job],
                       deadline: Optional[float] = None) -> None:
        """Multi-job backward wavefront BFS: every job's frontier advances
        in lockstep supersteps over one shared queue whose entries carry
        their job.  Visited masks (leaf ``Ds``, internal ``Dv``), pruning,
        and reporting are per-job, so each job's task subsequence — and
        therefore its results and traversal work counters — equals its
        solo traversal.  Only part 1.5 is shared: the merged task list
        takes the bit-parallel transition in ONE batch through the
        block-diagonal plan bundle (so the kernel-vs-scalar threshold,
        and with it ``kernel_batches``/``kernel_tasks``, is decided on
        the merged batch, not per job).

        A job that hits its ``target`` is marked done and contributes
        nothing further (the solo equivalent of returning mid-superstep).

        One-shot wrapper over :class:`RingStepper`: all jobs admitted
        before the first superstep, stepped to quiescence.  The stepper
        owns the superstep body, so the continuous-batching scheduler
        and this batch path execute identical traversal code."""
        stepper = RingStepper(self)
        for job in jobs:
            stepper.add_job(job)
        while stepper.queue:
            if all(job.done for job in jobs):
                break
            stepper.step(deadline=deadline)


class RingStepper:
    """Externally-driven superstep executor over a *dynamic* job set.

    Where :meth:`RingRPQ._traverse_many` runs a fixed batch to
    quiescence, the stepper exposes the superstep as a unit: jobs join
    between supersteps (:meth:`add_job` — allocating a block-diagonal
    slot in a dynamic :class:`PlanBundle`), :meth:`step` advances every
    in-flight frontier by exactly one superstep, and finished or
    preempted jobs release their slot (:meth:`remove_job`) without
    disturbing the others.  ``job.reported`` grows monotonically, which
    is what makes incremental result streaming sound.

    Version snapshots: ``add_job`` pins the ring and overlay the job
    reads (defaulting to the engine's current ones), so jobs admitted
    at different epochs traverse different graph versions while still
    sharing every part-1.5 transition batch — the merged task list only
    carries state masks, never graph data.
    """

    def __init__(self, rpq: RingRPQ):
        self.rpq = rpq
        self.bundle = PlanBundle.empty()
        self.jobs: List[_Job] = []
        # entries: (job, object id | None for the full range, D) — the
        # object id keys both the base L_p range and the overlay's delta
        # adjacency / tombstone lookups
        self.queue: deque = deque()
        self._pending: Dict[int, int] = {}   # id(job) -> queued entries
        self._last_tasks = 0                 # task count of the last superstep

    # -- admission / retirement --------------------------------------------
    def add_job(self, job: _Job, ring: Optional[Ring] = None,
                overlay: Optional[dl.DeltaOverlay] = None) -> None:
        """Admit ``job`` (before the next superstep).  ``ring``/
        ``overlay`` pin its version snapshot; default = the engine's
        current ones, which makes the one-shot ``_traverse_many`` path
        byte-identical to the pre-stepper behavior."""
        job.ring = ring if ring is not None else self.rpq.ring
        ov = overlay if overlay is not None else self.rpq.delta
        job.ov = ov if (ov is not None and ov.size) else None
        job.offset = self.bundle.add_slot(job.plan, job.plan.g.m + 1)
        self.jobs.append(job)
        D0 = job.plan.g.F & ~1  # state 0 has no incoming edges; strip eps
        if D0 == 0:
            job.done = True
            return
        if job.start_objs is not None:
            # multi-seed union job (split-plan half): every seed
            # starts with D0 under one shared visited mask
            for v in job.start_objs:
                job.Ds[v] = D0
                self._push(job, v, D0)
        elif job.start_obj is None:
            self._push(job, None, D0)
        else:
            job.Ds[job.start_obj] = D0
            self._push(job, job.start_obj, D0)

    def finished(self, job: _Job) -> bool:
        """Done flag (target hit / empty automaton) or a drained
        frontier — either way the job's ``reported`` set is final."""
        return job.done or self._pending.get(id(job), 0) == 0

    def remove_job(self, job: _Job) -> None:
        """Retire ``job`` (finished or preempted): free its bundle slot
        and neutralize any still-queued entries (marking it done makes
        the superstep body skip them)."""
        job.done = True
        self.bundle.free_slot(job.plan)
        self._pending.pop(id(job), None)
        try:
            self.jobs.remove(job)
        except ValueError:
            pass

    def _push(self, job: _Job, v: Optional[int], D: int) -> None:
        self.queue.append((job, v, D))
        self._pending[id(job)] = self._pending.get(id(job), 0) + 1

    def _pop_entry(self) -> Tuple[_Job, Optional[int], int]:
        entry = self.queue.popleft()
        k = id(entry[0])
        n = self._pending.get(k, 0) - 1
        if n > 0:
            self._pending[k] = n
        else:
            self._pending.pop(k, None)
        return entry

    # -- one superstep ------------------------------------------------------
    def step(self, deadline: Optional[float] = None) -> bool:
        """Advance the in-flight wavefront by ONE superstep (parts 1,
        1.5, 2+3 — see the module docstring).  ``wavefront=True`` steps
        every queued entry; ``False`` steps a single entry (the
        sequential reference).  Returns True while frontier entries
        remain queued."""
        if not self.queue:
            return False
        sp = otrace.span("ring.superstep", cat="engine",
                         entries=len(self.queue), jobs=len(self.jobs))
        if sp is otrace.NULL_SPAN:        # tracer off: keep the hot path bare
            return self._step_impl(deadline)
        with sp:
            # per-superstep deltas for ANALYZE timelines; distinct stats
            # objects (split plans share one across their jobs)
            st = {id(j.stats): j.stats for j in self.jobs}.values()
            act0 = sum(s.node_state_activations for s in st)
            rep0 = sum(len(j.reported) for j in self.jobs)
            more = self._step_impl(deadline)
            st = {id(j.stats): j.stats for j in self.jobs}.values()
            sp.set(activations=sum(s.node_state_activations for s in st) - act0,
                   reported=sum(len(j.reported) for j in self.jobs) - rep0,
                   tasks=self._last_tasks)
            return more

    def _step_impl(self, deadline: Optional[float] = None) -> bool:
        rpq = self.rpq
        if rpq.wavefront:
            chunk = list(self.queue)
            self.queue.clear()
            self._pending.clear()
        else:
            chunk = [self._pop_entry()]
        stepped = set()
        for job, _v, _D in chunk:
            if not job.done and id(job) not in stepped:
                stepped.add(id(job))
                job.stats.supersteps += 1

        import time as _time

        # ---- part 1: distinct predicates with D & B[p] != 0, over the
        # whole chunk — yields the superstep's task list.  With a live
        # overlay each entry also contributes its delta-adjacency
        # tasks (the inserted edges of its object), so base and delta
        # transitions share one part-1.5 batch.  Ranges and overlay
        # lookups go through the JOB's snapshot (job.ring / job.ov) —
        # mixed-epoch slots each read their own graph version ----
        tasks: List[_Task] = []
        for job, v, D in chunk:
            if job.done:
                continue
            ring = job.ring
            ov = job.ov
            b, e = ring.object_range(v) if v is not None \
                else ring.full_range()
            g, Bv, stats = job.plan.g, job.plan.Bv, job.stats
            delta_adj = ov.adds_for_obj(v) \
                if ov is not None and ov.has_adds else ()
            if e > b or delta_adj:
                # the deadline probe must tick for overlay-only
                # entries too (an insert-heavy graph can traverse
                # entirely through delta adjacency)
                stats.bfs_steps += 1
                if deadline is not None and stats.bfs_steps % 64 == 0 \
                        and _time.time() > deadline:
                    raise TimeoutError("query deadline exceeded")
            if e > b:

                def prune_p(l, prefix, covered, D=D, Bv=Bv, stats=stats):
                    stats.wt_nodes_visited += 1
                    return (D & Bv.get((l, prefix), 0)) == 0

                for p, rb, re_ in ring.wt_p.range_distinct(b, e,
                                                           prune=prune_p):
                    stats.predicates_enumerated += 1
                    masked = D & g.B.get(p, 0)
                    if masked == 0:
                        continue
                    sb = int(ring.C_p[p]) + rb
                    se = int(ring.C_p[p]) + re_
                    if se <= sb:
                        continue
                    tasks.append(_Task(job=job, masked=masked, pred=p,
                                       obj=v, sb=sb, se=se))
            for p, subs in delta_adj:
                masked = D & g.B.get(p, 0)
                if masked == 0:
                    continue
                stats.predicates_enumerated += 1
                tasks.append(_Task(job=job, masked=masked, pred=p,
                                   obj=v, subjects=subs))

        # ---- part 1.5: bit-parallel D-step for every task at once,
        # across ALL jobs/plans (and both task kinds) in one batch ----
        self._last_tasks = len(tasks)
        steps = rpq._transition_many(tasks, self.bundle)

        # ---- parts 2+3, in task order (== each job's sequential FIFO
        # order, so per-job visited-mask evolution is identical) ----
        next_front: List[Tuple[_Job, int, int]] = []

        def activate(job, s, Dstep):
            """Parts 2b+3 for one subject: merge into the visited
            mask, report on initial-state activation, requeue."""
            stats = job.stats
            old = job.Ds.get(s, 0)
            Dnew = Dstep & ~old
            if Dnew == 0:
                return False
            job.Ds[s] = old | Dnew
            stats.node_state_activations += bin(Dnew).count("1")
            if Dnew & job.plan.g.initial:
                job.reported.add(s)
                if job.target is not None and s == job.target:
                    job.done = True
                    return True
            next_front.append((job, s, Dnew))
            return False

        for task, Dstep in zip(tasks, steps):
            job = task.job
            if job.done or Dstep == 0:
                continue
            stats = job.stats
            if task.subjects is not None:
                # delta task: the overlay IS the subject list
                for s in task.subjects:
                    stats.subjects_enumerated += 1
                    if activate(job, s, Dstep):
                        break
                continue
            Dv = job.Dv
            ov = job.ov
            wt_s = job.ring.wt_s
            s_levels = wt_s.levels
            # tombstoned base transitions are masked out at subject
            # granularity: for a single-object task the (s, p, v)
            # triple is checked directly; a full-range task drops a
            # subject only when ALL its base triples under p are
            # tombstoned.  While tombstones exist for p, covered-node
            # Dv writes are suppressed (a skipped leaf would not have
            # received Dstep, so the cached intersection would lie).
            tomb = ov.tomb_pairs(task.pred) if ov is not None else None
            excl = None
            if tomb is not None and task.obj is None:
                # full-range entries only exist for start_obj=None jobs,
                # which never ride the continuous scheduler (multi-stage
                # plans are delegated at admission) — so reading the
                # ENGINE's base edge memo here always matches job.ring
                excl = ov.excluded_subjects_full(
                    task.pred, rpq._pred_edges_base(task.pred)[0])

            def prune_s(l, prefix, covered, Dstep=Dstep, Dv=Dv,
                        stats=stats, tomb=tomb, s_levels=s_levels):
                stats.wt_nodes_visited += 1
                if l == s_levels:
                    return False  # leaves handled on yield
                key = (l, prefix)
                dv = Dv.get(key, 0)
                if Dstep & ~dv == 0:
                    return True
                if (covered or rpq.paper_dv) and tomb is None:
                    # sound update: only when the interval spans the whole
                    # node does every present leaf below receive Dstep
                    Dv[key] = dv | Dstep
                return False

            for s, _srb, _sre in wt_s.range_distinct(task.sb, task.se,
                                                     prune=prune_s):
                stats.subjects_enumerated += 1
                if tomb is not None:
                    if task.obj is not None:
                        if (s, task.obj) in tomb:
                            continue
                    elif s in excl:
                        continue
                if activate(job, s, Dstep):
                    break
        for job, s, Dnew in next_front:
            if not job.done:
                self._push(job, s, Dnew)
        return bool(self.queue)
