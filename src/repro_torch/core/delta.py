"""Live-update subsystem: LSM-style delta overlay over the static index.

The ring (and the dense plane graph derived from the same
``completed_triples`` encoding) is a *static* succinct structure — this
module makes the triple set mutable without rebuilding it per write:

  * :class:`DeltaOverlay` — an append-only per-predicate **insert
    buffer** plus a **tombstone set** over the immutable base, both kept
    in *completed* space (every raw edge (s,p,o) materializes as the
    pair (s,p,o) / (o,p+P,s), exactly like the base completion, so the
    2RPQ machinery — inverses included — never special-cases deltas);
  * **epoch versioning** — every mutation batch bumps ``epoch`` and
    stamps ``pred_epoch[p]`` for each mutated raw predicate; caches tag
    entries with (predicate footprint, epoch) and an entry is valid iff
    no footprint predicate mutated after it was written — see
    ``ResultCache``/``PlanCache`` in :mod:`repro_torch.core.engines`;
  * **online compaction** — once the overlay outgrows a threshold the
    engine folds it back into a fresh base (:func:`maybe_compact` /
    the engines' ``compact()``), preserving epoch history so surviving
    cache entries stay valid;
  * **checkpointing** — :meth:`DeltaOverlay.to_state` /
    :meth:`DeltaOverlay.from_state` are flat array pytrees that ride
    :mod:`repro_torch.checkpoint` unchanged, so a restored engine resumes
    *mid-overlay* (same epoch, same pending deltas) without replaying
    the mutation log.

Exactness contract: at every epoch, the effective triple set is

    (base completed set  \\  tombstones)  ∪  insert buffer

with the invariants ``tombstones ⊆ base`` and ``inserts ∩ base-minus-
tombstones = ∅`` maintained by :meth:`DeltaOverlay.apply` (re-adding a
tombstoned base edge un-tombstones it; removing a buffered insert drops
it from the buffer).  Because a completed triple with p < P is produced
by exactly one raw triple (reverses only produce p >= P), set algebra in
completed space equals set algebra on the raw edges — queries answered
through the overlay are bit-identical to a from-scratch rebuild.

Scope note: the *node and predicate dictionaries are fixed* between
rebuilds — mutations reference existing ids (the usual KG serving
workload: edge churn among known entities).  Admitting new ids is a
rebuild, not an overlay op.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..obs import trace as otrace
from .stats import host_array

Triple = Tuple[int, int, int]


def pack_keys(s, p, o, num_nodes: int, num_preds_completed: int) -> np.ndarray:
    """Canonical (o, p, s) key packing of completed triples — the same
    encoding ``LabeledGraph.completed_triples`` dedups with, so base
    membership tests agree with the index build bit for bit."""
    s = np.asarray(s, dtype=np.int64)
    p = np.asarray(p, dtype=np.int64)
    o = np.asarray(o, dtype=np.int64)
    return (o * num_preds_completed + p) * num_nodes + s


class DeltaOverlay:
    """Mutable delta over an immutable completed triple set.

    Indexes kept per completed predicate (all small — the overlay is
    bounded by the compaction threshold):

      * ``_extra_by_obj[v][p]``   — inserted subjects per (object, pred):
        the wavefront's per-frontier-entry delta adjacency;
      * ``_extra_subj[p]``        — inserted subjects per pred (the
        full-range form of the same lookup);
      * ``_extra_pairs[p]``       — inserted (s, o) pairs per pred (seed
        edges for split plans; dense delta edge rows);
      * ``_tomb[p]``              — tombstoned base (s, o) pairs;
      * ``_tomb_subj[p]``         — tombstone count per subject, for the
        full-range exclusion test (a subject drops out of a predicate
        block only when *all* its base triples there are tombstoned).
    """

    def __init__(self, num_nodes: int, num_preds: int,
                 base_keys: np.ndarray):
        self.num_nodes = int(num_nodes)
        self.num_preds = int(num_preds)            # raw P; completed = 2P
        self._base_keys = np.sort(np.asarray(base_keys, dtype=np.int64))
        self.epoch = 0
        # raw pred -> epoch of its last mutation (0 = never mutated)
        self.pred_epoch = np.zeros(self.num_preds, dtype=np.int64)
        self.touched: Set[int] = set()             # raw preds ever mutated
        self._extra_by_obj: Dict[int, Dict[int, Set[int]]] = {}
        self._extra_subj: Dict[int, Set[int]] = {}
        self._extra_subj_count: Dict[int, Counter] = {}
        self._extra_pairs: Dict[int, Set[Tuple[int, int]]] = {}
        self._extra_count = 0                      # completed insert rows
        self._tomb: Dict[int, Set[Tuple[int, int]]] = {}
        self._tomb_subj: Dict[int, Counter] = {}
        self._tomb_count = 0                       # completed tombstones
        self._full_excl_cache: Dict[int, Tuple[int, Set[int]]] = {}
        self.adds_applied = 0                      # raw edges inserted
        self.removes_applied = 0                   # raw edges tombstoned

    @classmethod
    def from_graph(cls, graph) -> "DeltaOverlay":
        s, p, o = graph.completed_triples()
        keys = pack_keys(s, p, o, graph.num_nodes, 2 * graph.num_preds)
        return cls(graph.num_nodes, graph.num_preds, keys)

    # -- base membership -----------------------------------------------------
    def _in_base(self, s: int, p: int, o: int) -> bool:
        key = (o * 2 * self.num_preds + p) * self.num_nodes + s
        i = int(np.searchsorted(self._base_keys, key))
        return i < self._base_keys.size and int(self._base_keys[i]) == key

    # -- size / emptiness ----------------------------------------------------
    @property
    def size(self) -> int:
        """Completed overlay rows (inserts + tombstones) — the quantity
        the compaction threshold bounds."""
        return self._extra_count + self._tomb_count

    @property
    def has_adds(self) -> bool:
        return self._extra_count > 0

    @property
    def has_tombs(self) -> bool:
        return self._tomb_count > 0

    # -- mutation ------------------------------------------------------------
    def _check(self, triples: Iterable[Triple]) -> List[Triple]:
        out = []
        for s, p, o in triples:
            s, p, o = int(s), int(p), int(o)
            if not (0 <= p < self.num_preds):
                raise ValueError(
                    f"predicate {p} outside [0, {self.num_preds}): the "
                    "predicate dictionary is fixed between rebuilds")
            if not (0 <= s < self.num_nodes and 0 <= o < self.num_nodes):
                raise ValueError(
                    f"node id outside [0, {self.num_nodes}): the node "
                    "dictionary is fixed between rebuilds")
            out.append((s, p, o))
        return out

    def _insert_extra(self, s: int, p: int, o: int) -> None:
        pairs = self._extra_pairs.setdefault(p, set())
        if (s, o) in pairs:
            return
        pairs.add((s, o))
        self._extra_by_obj.setdefault(o, {}).setdefault(p, set()).add(s)
        cnt = self._extra_subj_count.setdefault(p, Counter())
        cnt[s] += 1
        if cnt[s] == 1:
            self._extra_subj.setdefault(p, set()).add(s)
        self._extra_count += 1

    def _drop_extra(self, s: int, p: int, o: int) -> bool:
        pairs = self._extra_pairs.get(p)
        if pairs is None or (s, o) not in pairs:
            return False
        pairs.discard((s, o))
        self._extra_by_obj[o][p].discard(s)
        cnt = self._extra_subj_count[p]
        cnt[s] -= 1
        if cnt[s] == 0:       # last buffered (s, p, ·) insert gone
            self._extra_subj[p].discard(s)
        self._extra_count -= 1
        return True

    def _insert_tomb(self, s: int, p: int, o: int) -> None:
        tomb = self._tomb.setdefault(p, set())
        if (s, o) in tomb:
            return
        tomb.add((s, o))
        self._tomb_subj.setdefault(p, Counter())[s] += 1
        self._tomb_count += 1

    def _drop_tomb(self, s: int, p: int, o: int) -> bool:
        tomb = self._tomb.get(p)
        if tomb is None or (s, o) not in tomb:
            return False
        tomb.discard((s, o))
        self._tomb_subj[p][s] -= 1
        self._tomb_count -= 1
        return True

    def _add_completed(self, s: int, p: int, o: int) -> None:
        if self._in_base(s, p, o):
            self._drop_tomb(s, p, o)       # un-tombstone; present -> no-op
        else:
            self._insert_extra(s, p, o)

    def _remove_completed(self, s: int, p: int, o: int) -> None:
        if self._in_base(s, p, o):
            self._insert_tomb(s, p, o)
        else:
            self._drop_extra(s, p, o)      # absent -> no-op

    def apply(self, add: Optional[Iterable[Triple]] = None,
              remove: Optional[Iterable[Triple]] = None) -> Set[int]:
        """Apply one mutation batch of raw (s, p, o) edges.  Each edge
        touches both completed directions.  Bumps ``epoch`` and stamps
        ``pred_epoch`` for every predicate named in the batch (even for
        no-op mutations — invalidation is conservative).  Returns the
        set of mutated raw predicate ids."""
        P = self.num_preds
        add = self._check(add or ())
        remove = self._check(remove or ())
        mutated: Set[int] = set()
        for s, p, o in add:
            self._add_completed(s, p, o)
            self._add_completed(o, p + P, s)
            mutated.add(p)
            self.adds_applied += 1
        for s, p, o in remove:
            self._remove_completed(s, p, o)
            self._remove_completed(o, p + P, s)
            mutated.add(p)
            self.removes_applied += 1
        if mutated:
            self.epoch += 1
            for p in mutated:
                self.pred_epoch[p] = self.epoch
            self.touched |= mutated
            self._full_excl_cache.clear()
        return mutated

    # -- staleness (the epoch-tag contract) ----------------------------------
    def entry_is_stale(self, footprint, epoch: int) -> bool:
        """An entry written at ``epoch`` with raw-predicate ``footprint``
        is stale iff some footprint predicate mutated later.  Wired into
        the caches as their ``stale_checker`` — eager invalidation keeps
        memory tidy, this check makes a stale hit impossible even if an
        invalidation were ever missed."""
        return any(int(self.pred_epoch[p]) > epoch for p in footprint)

    # -- query-side lookups --------------------------------------------------
    def adds_for_obj(self, v: Optional[int]) -> List[Tuple[int, List[int]]]:
        """Delta adjacency of one wavefront frontier entry: the inserted
        (completed predicate, subjects) lists for object ``v`` (``None``
        = the full range — all objects).  Sorted for deterministic
        traversal order."""
        if v is None:
            src = self._extra_subj
        else:
            src = self._extra_by_obj.get(v) or {}
        return [(p, sorted(src[p])) for p in sorted(src) if src[p]]

    def tomb_pairs(self, p: int) -> Optional[Set[Tuple[int, int]]]:
        """Tombstoned base (subject, object) pairs of completed predicate
        ``p`` — ``None`` when the predicate has no tombstones (the fast
        path: traversal behavior is exactly the static code)."""
        t = self._tomb.get(p)
        return t if t else None

    def excluded_subjects_full(self, p: int,
                               base_subjects: np.ndarray) -> Set[int]:
        """Subjects that must NOT be reported from a full-range task over
        completed predicate ``p``: those whose base triples under ``p``
        are *all* tombstoned.  ``base_subjects`` is the predicate's base
        L_s block (one entry per base triple).  Cached per epoch."""
        hit = self._full_excl_cache.get(p)
        if hit is not None and hit[0] == self.epoch:
            return hit[1]
        counts = self._tomb_subj.get(p) or {}
        out: Set[int] = set()
        if counts:
            uniq, cnt = np.unique(np.asarray(base_subjects, dtype=np.int64),
                                  return_counts=True)
            total = dict(zip(uniq.tolist(), cnt.tolist()))
            out = {s for s, c in counts.items()
                   if c > 0 and c >= total.get(s, 0)}
        self._full_excl_cache[p] = (self.epoch, out)
        return out

    def filter_pred_edges(self, p: int, sarr: np.ndarray,
                          oarr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Effective (subjects, objects) of completed predicate ``p``:
        the base label block minus tombstones plus the insert buffer —
        what split plans seed from and stats refresh against."""
        tomb = self._tomb.get(p)
        if tomb:
            V = self.num_nodes
            keys = sarr * V + oarr
            tkeys = np.fromiter((s * V + o for (s, o) in sorted(tomb)),
                                dtype=np.int64, count=len(tomb))
            keep = ~np.isin(keys, tkeys)
            sarr, oarr = sarr[keep], oarr[keep]
        pairs = self._extra_pairs.get(p)
        if pairs:
            es = np.fromiter((s for (s, _o) in sorted(pairs)),
                             dtype=np.int64, count=len(pairs))
            eo = np.fromiter((o for (_s, o) in sorted(pairs)),
                             dtype=np.int64, count=len(pairs))
            sarr = np.concatenate([sarr, es])
            oarr = np.concatenate([oarr, eo])
        return sarr, oarr

    def delta_edge_rows(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All inserted completed triples as (subj, pred, obj) arrays —
        the dense engine's delta edge rows, deterministic order."""
        rows = [(s, p, o) for p in sorted(self._extra_pairs)
                for (s, o) in sorted(self._extra_pairs[p])]
        if not rows:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        arr = np.asarray(rows, dtype=np.int64)
        return arr[:, 0], arr[:, 1], arr[:, 2]

    def tombstoned_keys(self) -> np.ndarray:
        """Packed canonical keys of every tombstoned completed triple —
        for masking the dense engine's base edge rows."""
        P2, V = 2 * self.num_preds, self.num_nodes
        keys = [(o * P2 + p) * V + s for p in sorted(self._tomb)
                for (s, o) in sorted(self._tomb[p])]
        return np.asarray(keys, dtype=np.int64)

    # -- compaction / rebuild ------------------------------------------------
    def effective_completed(self, base_s, base_p, base_o
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The effective completed triple set, given the base arrays."""
        base_s = np.asarray(base_s, dtype=np.int64)
        base_p = np.asarray(base_p, dtype=np.int64)
        base_o = np.asarray(base_o, dtype=np.int64)
        if self.has_tombs:
            keys = pack_keys(base_s, base_p, base_o, self.num_nodes,
                             2 * self.num_preds)
            keep = ~np.isin(keys, self.tombstoned_keys())
            base_s, base_p, base_o = base_s[keep], base_p[keep], base_o[keep]
        ds, dp, do = self.delta_edge_rows()
        return (np.concatenate([base_s, ds]),
                np.concatenate([base_p, dp]),
                np.concatenate([base_o, do]))

    def effective_graph(self, graph):
        """Fresh :class:`~repro_torch.core.ring.LabeledGraph` over the effective
        raw edges (the p < P half of the effective completion carries
        every raw triple exactly once) — what compaction re-indexes and
        what rebuild-oracle tests evaluate against."""
        from .ring import LabeledGraph
        s, p, o = self.effective_completed(*graph.completed_triples())
        raw = p < self.num_preds
        g = LabeledGraph(
            s=s[raw], p=p[raw], o=o[raw],
            num_nodes=graph.num_nodes, num_preds=graph.num_preds,
            node_names=graph.node_names, pred_names=graph.pred_names,
        )
        return g

    def reset_after_compaction(self, new_base_keys: np.ndarray) -> None:
        """Empty the overlay onto a freshly compacted base.  Epoch history
        (``epoch``/``pred_epoch``) is preserved: compaction changes the
        physical layout, never the logical triple set, so surviving
        cache entries remain valid."""
        self._base_keys = np.sort(np.asarray(new_base_keys, dtype=np.int64))
        self._extra_by_obj.clear()
        self._extra_subj.clear()
        self._extra_subj_count.clear()
        self._extra_pairs.clear()
        self._tomb.clear()
        self._tomb_subj.clear()
        self._extra_count = self._tomb_count = 0
        self._full_excl_cache.clear()

    def clone(self) -> "DeltaOverlay":
        """Deep copy for copy-on-write multi-version serving: the
        scheduler's ``submit_update`` swaps the engine's live overlay
        for a clone *before* applying the next mutation batch, so
        in-flight queries pinned to the old object keep reading epoch
        ``e`` while epoch ``e+1`` is built off to the side — writes
        never stall reads.  ``_base_keys`` is shared (read-only until a
        compaction replaces it wholesale); every mutable container is
        copied one level deep (their elements are ints/tuples)."""
        new = DeltaOverlay.__new__(DeltaOverlay)
        new.num_nodes = self.num_nodes
        new.num_preds = self.num_preds
        new._base_keys = self._base_keys
        new.epoch = self.epoch
        new.pred_epoch = self.pred_epoch.copy()
        new.touched = set(self.touched)
        new._extra_by_obj = {o: {p: set(s) for p, s in by_p.items()}
                             for o, by_p in self._extra_by_obj.items()}
        new._extra_subj = {p: set(s) for p, s in self._extra_subj.items()}
        new._extra_subj_count = {p: Counter(c) for p, c
                                 in self._extra_subj_count.items()}
        new._extra_pairs = {p: set(v) for p, v in self._extra_pairs.items()}
        new._extra_count = self._extra_count
        new._tomb = {p: set(v) for p, v in self._tomb.items()}
        new._tomb_subj = {p: Counter(c) for p, c in self._tomb_subj.items()}
        new._tomb_count = self._tomb_count
        new._full_excl_cache = {}
        new.adds_applied = self.adds_applied
        new.removes_applied = self.removes_applied
        return new

    # -- checkpoint serialization -------------------------------------------
    def to_state(self) -> Dict[str, np.ndarray]:
        """Flat array pytree for :mod:`repro_torch.checkpoint`.  Only the p < P
        halves are stored (the overlay is completion-symmetric by
        construction); ``from_state`` re-mirrors them."""
        ex = [(s, p, o) for p in sorted(self._extra_pairs)
              if p < self.num_preds
              for (s, o) in sorted(self._extra_pairs[p])]
        tb = [(s, p, o) for p in sorted(self._tomb)
              if p < self.num_preds
              for (s, o) in sorted(self._tomb[p])]
        exa = np.asarray(ex, dtype=np.int64).reshape(-1, 3)
        tba = np.asarray(tb, dtype=np.int64).reshape(-1, 3)
        return {
            "num_nodes": np.int64(self.num_nodes),
            "num_preds": np.int64(self.num_preds),
            "epoch": np.int64(self.epoch),
            "pred_epoch": self.pred_epoch.copy(),
            "touched": np.asarray(sorted(self.touched), dtype=np.int64),
            "extra": exa,
            "tomb": tba,
            "adds_applied": np.int64(self.adds_applied),
            "removes_applied": np.int64(self.removes_applied),
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any], graph) -> "DeltaOverlay":
        """Leaves may be numpy arrays or tensors on any device."""
        state = {k: host_array(v) for k, v in state.items()}
        ov = cls.from_graph(graph)
        if int(state["num_nodes"]) != ov.num_nodes or \
                int(state["num_preds"]) != ov.num_preds:
            raise ValueError("overlay state does not match the base graph")
        P = ov.num_preds
        for s, p, o in state["extra"].astype(np.int64).reshape(-1, 3):
            ov._add_completed(int(s), int(p), int(o))
            ov._add_completed(int(o), int(p) + P, int(s))
        for s, p, o in state["tomb"].astype(np.int64).reshape(-1, 3):
            ov._remove_completed(int(s), int(p), int(o))
            ov._remove_completed(int(o), int(p) + P, int(s))
        ov.epoch = int(state["epoch"])
        ov.pred_epoch = state["pred_epoch"].astype(np.int64)
        ov.touched = set(state["touched"].tolist())
        ov.adds_applied = int(state["adds_applied"])
        ov.removes_applied = int(state["removes_applied"])
        return ov


# -- engine-shared mutation path ---------------------------------------------
DEFAULT_COMPACT_THRESHOLD = 32768


def apply_engine_updates(engine, add=None, remove=None) -> int:
    """The mutation path both engines share: update the overlay, expire
    exactly the cache entries whose predicate footprint was touched,
    refresh the planner statistics for the mutated predicates, let the
    engine rewire its physical structures, and compact when the overlay
    outgrows the threshold.  Returns the new epoch."""
    ov = engine._ensure_overlay()
    with otrace.span("updates.apply", cat="updates") as sp:
        mutated = ov.apply(add, remove)
        if mutated:
            engine.results.invalidate_preds(mutated)
            engine.decisions.invalidate_preds(mutated)
            engine._on_overlay_change(mutated)
            if engine._stats is not None:
                completed = sorted({p for m in mutated
                                    for p in (m, m + ov.num_preds)})
                engine._stats.refresh_preds(completed, engine._pred_edges)
            if engine.compact_threshold is not None \
                    and ov.size >= engine.compact_threshold:
                engine.compact()
        sp.set(preds=len(mutated), epoch=ov.epoch)
    return ov.epoch


class LiveUpdateEngine:
    """The engine-shared live-update surface, mixed into both engines —
    ONE copy of the overlay lifecycle, so a fix lands on ring and dense
    alike.

    Subclass contract: attributes ``delta`` / ``results`` / ``decisions``
    / ``compact_threshold`` / ``_stats`` / ``_edge_eff``; methods
    ``_base_graph()`` (the immutable :class:`LabeledGraph`),
    ``_resolve_lit``, ``_pred_edges_base(p)``, ``_on_overlay_change
    (mutated_raw)`` (rewire physical structures), ``compact()``, and
    optionally ``_overlay_created()`` (engine-side setup the moment an
    overlay first exists).
    """

    @property
    def epoch(self) -> int:
        """Graph version: 0 for the pristine index, +1 per mutation batch."""
        return self.delta.epoch if self.delta is not None else 0

    def _ensure_overlay(self) -> DeltaOverlay:
        if self.delta is None:
            self.delta = DeltaOverlay.from_graph(self._base_graph())
            self.results.stale_checker = self.delta.entry_is_stale
            self._overlay_created()
        return self.delta

    def _overlay_created(self) -> None:
        pass

    def prepare_updates(self) -> None:
        """Build now what the first mutation batch would build first: the
        (empty) overlay over the base and the base's predicate-major
        edge arrays.  A server calls it at start-up, so that its first
        write does not stall every request in flight for the seconds
        this takes on millions of triples.  Changes no answer, cache or
        epoch."""
        self._ensure_overlay()
        self._pred_edges_base(0)

    def add_edges(self, triples) -> int:
        """Insert raw (s, p, o) edges (ids within the base dictionaries).
        Exact immediately: queries at the returned epoch see the new
        edges, caches over touched predicates are expired, and the
        overlay compacts back into a fresh base once it outgrows
        ``compact_threshold``.  Returns the new epoch."""
        return apply_engine_updates(self, add=triples)

    def remove_edges(self, triples) -> int:
        """Delete raw (s, p, o) edges (tombstoned until compaction).
        Returns the new epoch."""
        return apply_engine_updates(self, remove=triples)

    def effective_graph(self):
        """The current logical graph (base + overlay) as a fresh
        :class:`~repro_torch.core.ring.LabeledGraph`."""
        if self.delta is None:
            return self._base_graph()
        return self.delta.effective_graph(self._base_graph())

    def overlay_state(self):
        """Checkpointable overlay pytree (see ``repro_torch.checkpoint``);
        ``None`` when no mutation ever happened."""
        return self.delta.to_state() if self.delta is not None else None

    def load_overlay(self, state) -> None:
        """Adopt a checkpointed overlay (resume mid-overlay): deltas,
        epoch history, cache staleness wiring, and the engine's physical
        structures are restored.  Anything cached against a predicate
        the overlay ever touched — finished answers AND planner
        decisions priced on pre-overlay statistics — is invalidated, and
        result lookups keep re-validating epoch tags, so nothing stale
        can survive the restore."""
        self.delta = DeltaOverlay.from_state(state, self._base_graph())
        self.results.stale_checker = self.delta.entry_is_stale
        self._stats = None
        touched = set(self.delta.touched)
        self.results.invalidate_preds(touched)
        self.decisions.invalidate_preds(touched)
        self._overlay_created()
        self._on_overlay_change(touched)

    def _pred_edges(self, p: int):
        """*Effective* (subjects, objects) of completed predicate ``p`` —
        the seed edges of a split plan and the stats-refresh input: base
        minus tombstones plus the overlay's insert buffer, memoized per
        predicate until the next mutation batch."""
        if self.delta is None:
            return self._pred_edges_base(p)
        hit = self._edge_eff.get(p)
        if hit is not None:
            return hit
        sarr, oarr = self.delta.filter_pred_edges(p, *self._pred_edges_base(p))
        self._edge_eff[p] = (sarr, oarr)
        return sarr, oarr

    def _footprint(self, ast) -> frozenset:
        """Raw predicate ids the expression touches — the cache
        invalidation granularity of live updates."""
        from .engines import query_footprint
        return query_footprint(ast, self._resolve_lit,
                               self._base_graph().num_preds)

    def _refresh_touched_stats(self) -> None:
        """After a lazy :class:`GraphStats` harvest (which reads the
        static base), bring every predicate the overlay ever touched up
        to the effective edge set."""
        if self.delta is not None and self.delta.touched:
            completed = sorted({c for p in self.delta.touched
                                for c in (p, p + self.delta.num_preds)})
            self._stats.refresh_preds(completed, self._pred_edges)
