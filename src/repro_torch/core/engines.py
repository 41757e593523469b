"""Shared engine dispatch + the multi-query batch API.

The serving surface the engines plug into:

  * :class:`Query` — one 2RPQ request (expr + optional fixed endpoints);
  * :class:`PlanCache` — per-engine cache of *planner outputs* keyed by
    the normalized AST (:func:`normalized_key` canonicalizes
    concatenation associativity and alternation operand order, so every
    spelling of the same expression shares entries).  Engines keep two
    instances: ``plans`` memoizes compiled artifacts (Glushkov + B[v]
    mask tables on the ring, bool-plane tables on the dense engine) and
    ``decisions`` memoizes the cost-based planner's physical-plan choice
    per (expression, endpoint-binding) class — see :func:`decision_key`;
  * :class:`ResultCache` — cross-request memo of *finished answers*,
    keyed by normalized AST + endpoint binding, LRU with size/TTL bounds.
    A replayed request skips evaluation entirely;
  * :class:`PlanBundle` — the packing that lets ``eval_many`` batch
    queries with *different* automata: plans are laid out block-diagonally
    in one shared state space (distinct automata compose into one
    block-diagonal transition structure, so a single bit-parallel step —
    or one padded dense BFS — serves every plan at once);
  * :func:`make_engine` / :func:`eval_many` — engine-agnostic entry
    points: build either engine from a :class:`LabeledGraph` and answer a
    batch of queries through its ``eval_many``.

Both engines implement ``eval_many(queries) -> List[Set[(s, o)]]`` with
results identical to per-query ``eval``; both coalesce mixed-automaton
batches (dense: padded stacked plane tables, one vmapped BFS per state
bucket; ring: one wavefront superstep stream whose task list carries a
plan id, stepped through a single block-diagonal ``nfa_step`` batch).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple, Union)

from . import regex as rx
from ..obs import trace as otrace


@dataclass(frozen=True)
class Query:
    """One 2RPQ request; ``None`` endpoint = variable.

    ``explain`` opts the request into ANALYZE: the engine executes it
    under a private tracer and delivers a per-superstep report (see
    :mod:`repro_torch.obs.explain`) to the sink — an
    :class:`~repro_torch.obs.explain.ExplainSink`, any callable, or a dict.
    Excluded from equality/hashing so explain-tagged requests still
    share result-cache keys with their plain twins."""

    expr: str
    subject: Optional[int] = None
    obj: Optional[int] = None
    limit: Optional[int] = None
    explain: Optional[Any] = field(default=None, compare=False, repr=False)


QueryLike = Union[Query, str, Tuple]


def as_query(q: QueryLike) -> Query:
    """Accept Query | expr-string | (expr[, subject[, obj[, limit]]])."""
    if isinstance(q, Query):
        return q
    if isinstance(q, str):
        return Query(q)
    return Query(*q)


def normalized_key(expr: Union[str, rx.Node]) -> str:
    """Canonical plan-/result-cache key for an expression: parse, reduce
    to :func:`repro_torch.core.regex.canonical` form (concatenation chains
    right-associated, alternation operands flattened/deduped/sorted),
    and reprint.  Equivalent spellings — ``a/b*`` vs ``(a/(b)*)``,
    ``(a/b)/c`` vs ``a/(b/c)``, ``a|b`` vs ``b|a`` — share one entry."""
    ast = rx.parse(expr) if isinstance(expr, str) else expr
    return str(rx.canonical(ast))


def decision_key(expr: Union[str, rx.Node], subject_bound: bool,
                 obj_bound: bool, policy: str) -> Tuple:
    """PlanCache key for a *planner decision*.  A decision depends on the
    expression (canonicalized), which endpoints are bound (not their
    values), and the planner policy — so one cached decision serves every
    request of the same (expression, binding) class."""
    return ("decision", normalized_key(expr), subject_bound, obj_bound,
            policy)


def query_footprint(ast: Union[str, rx.Node], resolve,
                    num_preds: int) -> frozenset:
    """RAW predicate ids an expression's answer can depend on — the
    invalidation granularity of the live-update subsystem: a mutation to
    raw predicate p expires exactly the cache entries whose footprint
    contains p.  Completed ids fold onto their raw predicate (p and ^p
    are two views of the same mutable edge set); unresolvable literals
    contribute nothing (evaluation would raise before caching)."""
    node = rx.parse(ast) if isinstance(ast, str) else ast
    out = set()
    for lit in node.literals():
        try:
            c = resolve(lit)
        except Exception:
            continue
        if 0 <= c < 2 * num_preds:
            out.add(c % num_preds)
    return frozenset(out)


@dataclass
class QueryStats:
    """Per-query work counters + the planner's decision record.

    The traversal counters are the Theorem-4.1 accounting the ring
    engine fills (the dense engine reports only results/cache/plan
    fields).  ``plan_*`` fields surface what the cost-based planner
    chose and why: the physical plan (``forward``/``reverse``/``split``,
    or ``naive`` when planning is opted out), the split predicate (the
    completed-graph id of the cut literal, -1 when not split), the
    estimated cost of the chosen plan, and the estimated vs actual seed
    frontier (predicted seed count from the selectivity stats vs the
    seeds the executor really enqueued)."""

    node_state_activations: int = 0   # |new (v, q) pairs| == |G'_E| nodes touched
    bfs_steps: int = 0
    wt_nodes_visited: int = 0
    predicates_enumerated: int = 0
    subjects_enumerated: int = 0
    results: int = 0
    supersteps: int = 0
    kernel_batches: int = 0
    kernel_tasks: int = 0
    result_cache_hits: int = 0
    result_cache_misses: int = 0
    # live-update observability: the graph epoch the query evaluated at,
    # and the engine-cumulative footprint-invalidation counters at that
    # moment (how many ResultCache / decision-PlanCache entries mutations
    # have expired so far)
    epoch: int = 0
    result_cache_invalidations: int = 0
    plan_cache_invalidations: int = 0
    plan_mode: str = ""
    plan_split_pred: int = -1
    plan_est_cost: float = 0.0
    plan_est_frontier: float = 0.0
    plan_actual_frontier: int = 0
    # launch-signature churn: how many NEW kernel launch signatures this query
    # (batch-wide on ``eval_many`` — batches dispatch jointly) forced the
    # engine to trace.  A steady-state workload should sit at 0; growth
    # means the padding/bucketing scheme is leaking shapes (the runtime
    # view of the trace audit's retrace budget — repro.analysis).
    retraces: int = 0
    # latency attribution (scheduler-clock seconds, filled by
    # SlotScheduler): queue wait (submit -> slot admission), service
    # (admission -> settle), and the wall time the ticket's slot spent
    # inside superstep dispatch.  queue_wait_s + service_s equals the
    # end-to-end latency of a settled ticket.
    queue_wait_s: float = 0.0
    service_s: float = 0.0
    supersteps_s: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        """Field-name -> value dict (JSON-able) — the one formatting
        path for benchmark rows and serving summaries."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @staticmethod
    def merge(stats: Iterable["QueryStats"]) -> "QueryStats":
        """Aggregate many per-query stats into one workload-level record:
        numeric fields sum, ``epoch`` and the plan decision fields keep
        the maximum seen (sums of ids/modes are meaningless)."""
        out = QueryStats()
        keep_max = {"epoch", "plan_split_pred", "plan_est_cost",
                    "plan_est_frontier"}
        modes: Set[str] = set()
        for s in stats:
            for f in fields(QueryStats):
                if f.name == "plan_mode":
                    if s.plan_mode:
                        modes.add(s.plan_mode)
                    continue
                v = getattr(s, f.name)
                if f.name in keep_max:
                    setattr(out, f.name, max(getattr(out, f.name), v))
                else:
                    setattr(out, f.name, getattr(out, f.name) + v)
        out.plan_mode = "+".join(sorted(modes))
        return out


class TraceTracker:
    """Ledger of distinct compiled-dispatch signatures an engine has
    induced — the runtime side of the ``repro.analysis`` retrace audit.

    Engines :meth:`record` a key per device dispatch, built from the
    same quantities their launch signatures key on (shape dims + static
    args).  A key seen before is a cache hit (no trace); a new key is
    counted in ``retraces``.  Padding/bucketing schemes (pow2 state
    buckets, fixed source-batch chunks, pow2 task padding) exist exactly
    to keep this counter flat under mixed workloads.
    """

    def __init__(self):
        self.signatures = set()
        self.retraces = 0

    def record(self, *key) -> bool:
        """Record one dispatch signature; True when it forced a new trace."""
        if key in self.signatures:
            return False
        self.signatures.add(key)
        self.retraces += 1
        return True


def truncate_result(out: Sequence[Tuple[int, int]],
                    limit: Optional[int]) -> Set:
    """Deterministic ``limit`` truncation: the ``limit`` smallest answers
    in sorted (lexicographic) order.

    This is THE definition of a limited answer set, shared by every
    path — ring and dense engines, sharded and single-device execution,
    and :class:`ResultCache` replays — so a ``limit=k`` query returns
    the same pairs on every engine and on every run, and a cached
    superset entry can serve a smaller-limit probe by re-truncation
    (``sorted(full)[:j] == sorted(sorted(full)[:k])[:j]`` for j <= k).
    """
    if limit is None or len(out) <= limit:
        return set(out)
    return set(sorted(out)[:limit])


_MISSING = object()


class PlanCache:
    """Keyed memo of compiled query plans with hit/miss/eviction counters.

    Values are engine-specific (ring: Glushkov + B[v] table; dense:
    Glushkov + device plane tables) — the cache is just the sharing
    policy, which both engines need identically.

    Eviction accounting: a hit pops and re-inserts the entry *before*
    returning, so an about-to-evict entry that gets hit is refreshed to
    most-recently-used and a subsequent miss evicts the true LRU, never
    the just-hit plan.  ``build`` may itself consult the cache (e.g. a
    plan that compiles its reverse); the miss path re-checks for a
    reentrant insert of the same key and keeps the size bound with an
    eviction *loop*, so interleaved get/build sequences can never leave
    more than ``max_entries`` entries behind.
    """

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._entries: Dict[Any, Any] = {}
        self._foot: Dict[Any, frozenset] = {}   # key -> predicate footprint
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, key: Any, build: Callable[[], Any],
            footprint: Optional[frozenset] = None) -> Any:
        """``footprint``: raw predicate ids the cached value depends on —
        see :meth:`invalidate_preds`.  Entries cached without one are
        mutation-independent (e.g. compiled automata) and never expire."""
        plan = self._entries.pop(key, _MISSING)
        if plan is not _MISSING:
            self._entries[key] = plan  # re-insert: LRU recency refresh
            self.hits += 1
            return plan
        self.misses += 1
        plan = build()
        # build() may have inserted this very key reentrantly; drop the
        # stale copy so the re-insert below lands at MRU exactly once
        self._entries.pop(key, None)
        self._entries[key] = plan
        if footprint is not None:
            self._foot[key] = footprint
        while len(self._entries) > self.max_entries:
            # evict the least recently used (dict preserves order)
            evicted = next(iter(self._entries))
            self._entries.pop(evicted)
            self._foot.pop(evicted, None)
            self.evictions += 1
        return plan

    def invalidate_preds(self, preds) -> int:
        """Expire entries whose footprint intersects the mutated raw
        predicate set; untouched entries keep hitting.  Returns the
        number expired (also accumulated in ``invalidations``)."""
        preds = set(preds)
        stale = [k for k, fp in self._foot.items() if fp & preds]
        for k in stale:
            self._entries.pop(k, None)
            self._foot.pop(k, None)
        self.invalidations += len(stale)
        return len(stale)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._foot.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0


class ResultCache:
    """Cross-request LRU memo of finished query answers.

    Key: ``(normalized AST, subject, obj, limit)`` — see
    :func:`result_key`.  Values are stored as frozensets; callers get
    fresh mutable copies so a consumer mutating its answer cannot corrupt
    later replays.  ``ttl_s`` bounds staleness (``None`` = never expires);
    ``max_entries`` bounds size with LRU eviction.  ``clock`` is
    injectable for deterministic TTL tests.

    Live-update versioning: every entry carries the raw-predicate
    ``footprint`` of its expression and the graph ``epoch`` it was
    computed at.  A mutation expires exactly the entries whose footprint
    touches a mutated predicate (:meth:`invalidate_preds` — eager), and
    ``stale_checker`` (wired to
    :meth:`repro_torch.core.delta.DeltaOverlay.entry_is_stale` by mutable
    engines) re-validates on every lookup, so a pre-mutation answer for
    a query touching a mutated predicate is unservable *by construction*
    — even if an eager invalidation were ever missed.
    """

    def __init__(self, max_entries: int = 4096, ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self.clock = clock
        # key -> (value, stamp, footprint, epoch)
        self._entries: Dict[Any, Tuple[frozenset, float, frozenset, int]] = {}
        self._limited = 0  # entries whose result_key carries a limit
        self.stale_checker: Optional[Callable[[frozenset, int], bool]] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.invalidations = 0

    @staticmethod
    def _is_limited(key: Any) -> bool:
        return isinstance(key, tuple) and len(key) == 4 and key[3] is not None

    def _drop(self, key: Any) -> None:
        if self._is_limited(key):
            self._limited -= 1

    def _lookup(self, key: Any) -> Optional[frozenset]:
        """TTL- and epoch-checked fetch with LRU recency refresh; no
        hit/miss accounting (callers count exactly one hit or miss per
        probe)."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return None
        value, stamp, footprint, epoch = entry
        if self.ttl_s is not None and self.clock() - stamp > self.ttl_s:
            self.expirations += 1
            self._drop(key)
            return None
        if self.stale_checker is not None \
                and self.stale_checker(footprint, epoch):
            # the epoch-tag guarantee: an answer predating a mutation to
            # its footprint can never be served
            self.invalidations += 1
            self._drop(key)
            return None
        self._entries[key] = entry  # LRU recency refresh
        return value

    def invalidate_preds(self, preds) -> int:
        """Eagerly expire entries whose footprint intersects the mutated
        raw predicate set; entries over untouched predicates keep
        hitting.  Returns the number expired (also accumulated in
        ``invalidations``)."""
        preds = set(preds)
        stale = [k for k, e in self._entries.items() if e[2] & preds]
        for k in stale:
            self._entries.pop(k)
            self._drop(k)
        self.invalidations += len(stale)
        return len(stale)

    def get(self, key: Any) -> Optional[frozenset]:
        value = self._lookup(key)
        if value is None:
            self.misses += 1
            return None
        self.hits += 1
        return value

    def get_covering(self, key: Any) -> Optional[frozenset]:
        """Exact entry, else a *superset* entry that can answer a limited
        probe: for a :func:`result_key` ``(ast, subject, obj, limit=k)``
        miss, an unlimited entry — or any entry with limit >= k — for
        the same (ast, endpoints) is deterministically re-truncated
        (see :func:`truncate_result`) and counted as a hit.  The
        truncated answer is memoized under the probe key (inheriting the
        source entry's TTL stamp), so a hot limited probe pays the
        superset search once, not per request."""
        value = self._lookup(key)
        if value is not None:
            self.hits += 1
            return value
        limit = key[3] if isinstance(key, tuple) and len(key) == 4 else None
        if limit is not None:
            src = key[:3] + (None,)
            value = self._lookup(src)
            if value is None and self._limited > 0:
                # any larger-limit entry is a sorted prefix superset;
                # scan MRU-first (bounded by the cache size, and skipped
                # entirely when no limited entries are cached — the
                # common serving case)
                for k2 in reversed(list(self._entries.keys())):
                    if isinstance(k2, tuple) and len(k2) == 4 \
                            and k2[:3] == key[:3] \
                            and k2[3] is not None and k2[3] >= limit:
                        value = self._lookup(k2)
                        if value is not None:
                            src = k2
                            break
            if value is not None:
                self.hits += 1
                trunc = frozenset(truncate_result(value, limit))
                entry = self._entries.get(src)
                if entry is not None:   # inherit stamp/footprint/epoch
                    self._insert(key, trunc, entry[1], entry[2], entry[3])
                return trunc
        self.misses += 1
        return None

    def put(self, key: Any, value: Set[Tuple[int, int]],
            footprint: frozenset = frozenset(), epoch: int = 0) -> None:
        self._insert(key, frozenset(value), self.clock(), footprint, epoch)

    def _insert(self, key: Any, value: frozenset, stamp: float,
                footprint: frozenset = frozenset(), epoch: int = 0) -> None:
        if self.max_entries <= 0:
            return
        if self._entries.pop(key, None) is None and self._is_limited(key):
            self._limited += 1
        self._entries[key] = (value, stamp, footprint, epoch)
        while len(self._entries) > self.max_entries:
            evicted = next(iter(self._entries))
            self._entries.pop(evicted)
            if self._is_limited(evicted):
                self._limited -= 1
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._limited = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.invalidations = 0


def result_key(q: "Query") -> Tuple[str, Optional[int], Optional[int],
                                    Optional[int]]:
    """ResultCache key: normalized AST + the full endpoint binding.
    ``limit`` participates because it changes the answer set."""
    return (normalized_key(q.expr), q.subject, q.obj, q.limit)


def probe_result_cache(
    cache: ResultCache,
    queries: Sequence["Query"],
    results: List[Optional[Set[Tuple[int, int]]]],
    on_hit: Optional[Callable[[int, frozenset], None]] = None,
    on_miss: Optional[Callable[[int], None]] = None,
) -> Dict[Tuple, List[int]]:
    """Shared ``eval_many`` admission: fill ``results[i]`` (a fresh set
    copy) for every cached query, and return the misses grouped as
    ``{result key: [query indices]}`` — duplicates collapse onto one
    pending entry.  ``on_hit``/``on_miss`` let the ring engine surface
    per-query cache counters in its stats rows."""
    pending: Dict[Tuple, List[int]] = {}
    with otrace.span("cache.probe", cat="cache",
                     queries=len(queries)) as sp:
        for idx, q in enumerate(queries):
            if results[idx] is not None:
                continue   # already settled upstream (e.g. ANALYZE ran it)
            key = result_key(q)
            cached = cache.get_covering(key)
            if cached is not None:
                results[idx] = set(cached)
                if on_hit is not None:
                    on_hit(idx, cached)
            else:
                pending.setdefault(key, []).append(idx)
                if on_miss is not None:
                    on_miss(idx)
        sp.set(misses=len(pending))
    return pending


def publish_result(
    cache: ResultCache,
    key: Tuple,
    out: Set[Tuple[int, int]],
    idxs: Sequence[int],
    results: List[Optional[Set[Tuple[int, int]]]],
    footprint: frozenset = frozenset(),
    epoch: int = 0,
) -> None:
    """Shared ``eval_many`` completion: remember ``out`` in the result
    cache — tagged with the query's predicate footprint and the graph
    epoch it was computed at — and fan it out (as independent set
    copies) to every query index that collapsed onto this key."""
    cache.put(key, out, footprint=footprint, epoch=epoch)
    for i in idxs:
        results[i] = set(out)


@dataclass
class PlanBundle:
    """Several compiled plans packed into one shared state space.

    ``sizes[i]`` is plan i's state count (Glushkov m+1); ``offsets[i]``
    its bit offset in the block-diagonal layout.  A plan-local mask ``D``
    becomes ``D << offsets[i]`` in bundle space, and because transitions
    never cross blocks, one combined T' table (see
    :func:`repro_torch.kernels.nfa_step.pack_block_diagonal`) steps every
    plan's tasks in a single kernel batch.  ``S_max`` is the widest
    plan's state count (the dense engine buckets by its own
    pow2-quantized width, so padded stacks are at least this wide).

    ``extras`` holds engine-specific lazily-built artifacts (e.g. the
    packed block-diagonal table) so a bundle is built once per batch.

    Two lifetimes share this class.  :meth:`build` packs a *static*
    batch — offsets are dense cumulative sums and never change.  The
    continuous-batching scheduler instead starts from :meth:`empty` and
    grows/shrinks the bundle with :meth:`add_slot`/:meth:`free_slot`
    between supersteps: each admitted plan gets a *slot* — a bit block
    bucketed up to a power of two (min 4) — and freed slots go on a
    free list keyed by bucket size, so a retiring query's block is
    recycled by the next admission of any plan that fits.  Together
    with :attr:`padded_total` (pow2-rounded packed width in dynamic
    mode) this keeps the set of compiled kernel signatures bounded no
    matter how queries churn through the slots.
    """

    plans: List[Any]
    sizes: List[int]
    offsets: List[int]
    S_total: int
    S_max: int
    extras: Dict[str, Any] = field(default_factory=dict)
    dynamic: bool = False
    _refs: Dict[int, int] = field(default_factory=dict)    # id(plan) -> count
    _index: Dict[int, int] = field(default_factory=dict)   # id(plan) -> block
    _free: List[int] = field(default_factory=list)         # freed block idxs

    @classmethod
    def build(cls, plans: Sequence[Any], sizes: Sequence[int]) -> "PlanBundle":
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        return cls(plans=list(plans), sizes=list(sizes), offsets=offsets,
                   S_total=off, S_max=max(sizes) if sizes else 0)

    @classmethod
    def empty(cls) -> "PlanBundle":
        """A dynamic (slot-managed) bundle with no plans admitted yet."""
        return cls(plans=[], sizes=[], offsets=[], S_total=0, S_max=0,
                   dynamic=True)

    @staticmethod
    def slot_bucket(size: int) -> int:
        """Slot width for a plan of ``size`` states: next pow2, min 4."""
        w = 4
        while w < size:
            w *= 2
        return w

    @property
    def padded_total(self) -> int:
        """Packed-word width basis for kernel dispatch: the literal
        ``S_total`` for static bundles (existing compiled shapes), the
        next power of two (min 32 = one uint32 word) in dynamic mode so
        slot churn cannot generate unbounded launch signatures."""
        if not self.dynamic:
            return self.S_total
        w = 32
        while w < self.S_total:
            w *= 2
        return w

    def live_plans(self) -> List[Tuple[Any, int]]:
        """(plan, offset) pairs of the occupied blocks — freed slots are
        holes (``plans[i] is None``) and must not be packed."""
        return [(p, off) for p, off in zip(self.plans, self.offsets)
                if p is not None]

    def add_slot(self, plan: Any, size: int) -> int:
        """Admit ``plan`` into the dynamic bundle; returns its bit
        offset.  A plan already resident shares its block (refcounted);
        otherwise the smallest free block whose bucket fits is reused,
        and only when none fits does the bundle grow."""
        if not self.dynamic:
            raise ValueError("add_slot requires a dynamic bundle "
                             "(PlanBundle.empty())")
        key = id(plan)
        if key in self._index:
            self._refs[key] += 1
            return self.offsets[self._index[key]]
        bucket = self.slot_bucket(size)
        block = None
        best = None
        for fi, bi in enumerate(self._free):
            if self.sizes[bi] >= bucket and (
                    best is None or self.sizes[bi] < self.sizes[best[1]]):
                best = (fi, bi)
        if best is not None:
            self._free.pop(best[0])
            block = best[1]
            self.plans[block] = plan
        else:
            block = len(self.plans)
            self.plans.append(plan)
            self.sizes.append(bucket)
            self.offsets.append(self.S_total)
            self.S_total += bucket
        self._index[key] = block
        self._refs[key] = 1
        self.S_max = max(self.S_max, size)
        self.extras.pop("packed_bwd", None)   # membership changed
        return self.offsets[block]

    def free_slot(self, plan: Any) -> None:
        """Release one reference to ``plan``'s slot; the block joins the
        free list when the last job using the plan retires."""
        key = id(plan)
        if key not in self._refs:
            return
        self._refs[key] -= 1
        if self._refs[key] > 0:
            return
        block = self._index.pop(key)
        del self._refs[key]
        self.plans[block] = None
        self._free.append(block)
        self.extras.pop("packed_bwd", None)


def make_engine(graph, kind: str = "ring", device=None, **kwargs):
    """Build an RPQ engine over a :class:`LabeledGraph`.

    ``kind``: "ring" (succinct, paper-faithful).  The dense engine is not
    ported yet and raises :class:`NotImplementedError`.

    ``device``: where the engine's kernels run — ``"cuda"`` by default;
    without a CUDA device this raises :class:`RuntimeError` before the
    index is built.  ``"cpu"`` runs the kernels' plain PyTorch versions
    and is taken only when the caller asks for it.

    Live updates: the built engine exposes
    ``add_edges``/``remove_edges``/``epoch``/``compact()`` — exact
    delta-overlay mutations with epoch-versioned cache invalidation
    (see :mod:`repro_torch.core.delta`); ``compact_threshold=`` bounds the
    overlay before it is folded back into a fresh base.
    """
    if kind == "ring":
        from ..kernels.ops import resolve_device
        from .ring import Ring
        from .rpq import RingRPQ
        device = resolve_device(device)   # fail before the index build
        return RingRPQ(Ring(graph), device=device, **kwargs)
    if kind == "dense":
        raise NotImplementedError(
            "the dense engine is not ported yet (ROADMAP queue 1)")
    raise ValueError(f"unknown engine kind {kind!r}")


def eval_many(engine, queries: Sequence[QueryLike]) -> List[Set[Tuple[int, int]]]:
    """Answer a batch of queries on any engine exposing ``eval_many``."""
    return engine.eval_many(queries)
