"""Cost-based query planner: pick HOW to run a 2RPQ before traversing.

The paper's algorithm is not just the bit-parallel Glushkov simulation —
Sec. 5 chooses *how* to run it: start from the endpoint whose adjacent
predicates are rarest (cardinalities are O(1) reads off C_p), reverse
the automaton when only the subject is bound, and split an unanchored
query at a low-frequency predicate, meeting in the middle.  This module
is that decision layer, generalized into three physical plans both
engines execute:

  ``forward``  — the native direction: a backward traversal seeded at
      the bound object (or the full range when unbound) over the
      Glushkov automaton of E; a subject-bound query runs from the
      subject over ^E — exactly today's un-planned behavior.
  ``reverse``  — swap which endpoint seeds the traversal: a both-bound
      query starts from the subject over the reversed automaton; an
      unanchored query enumerates *objects* first (phase 1 over ^E) and
      completes each object from its side.  Wins when the object side
      of the query is the selective one.
  ``split``    — cut E = A / p / B at a mandatory literal of the
      top-level concatenation chain (the globally least-frequent one),
      seed from p's ``freq[p]`` edge occurrences, run two
      half-traversals (A leftward from p's subjects, B rightward from
      p's objects), and join the halves on the seed edges.  Wins when a
      rare predicate sits inside an otherwise unselective expression —
      the pathological unanchored case.

Cost model: coarse frontier-size estimates over
:class:`~repro_torch.core.stats.GraphStats`.  A backward traversal seeded at
``k`` endpoint nodes first touches, for each entry predicate p (the
last literals of the traversed expression), about
``freq[p] * min(1, k / distinct_obj[p])`` edges; monotone visited masks
then bound the whole traversal by the total frequency of the
expression's literals, so

    cost(expr, k) = start + min(avg_degree * start, sum_p freq[p]).

These are estimates, not bounds — the planner only needs the *ordering*
to be right on skewed workloads, and ``planner="naive"`` (today's
behavior) stays available as the parity reference and opt-out.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Set

import numpy as np

from . import regex as rx
from ..obs import trace as otrace
from .stats import GraphStats


def isin_mask(arr: "np.ndarray", members) -> "np.ndarray":
    """Boolean mask of ``arr`` entries contained in the ``members`` set —
    the seed-edge filter both engines' split executors apply."""
    if not members:
        return np.zeros(arr.size, dtype=bool)
    return np.isin(arr, np.fromiter(members, dtype=np.int64,
                                    count=len(members)))

# A bound-endpoint query abandons its native direction only for a clear
# estimated win: the estimates are coarse, and flapping between plans on
# noise costs plan-cache locality.  Unanchored queries take any winner —
# their naive evaluation is the pathological case the planner exists for.
ANCHORED_MARGIN = 2.0


@dataclass(frozen=True)
class SplitPoint:
    """E = left / lit / right (either side may be absent = empty word)."""

    lit: rx.Lit
    left: Optional[rx.Node]
    right: Optional[rx.Node]


@dataclass
class Plan:
    """A planner decision for one (expression, endpoint-binding) class."""

    mode: str                                   # forward | reverse | split
    split: Optional[SplitPoint] = None
    split_pred: int = -1                        # resolved completed id
    est: Dict[str, float] = field(default_factory=dict)
    est_frontier: float = 0.0                   # predicted seed frontier


# -- AST analyses ------------------------------------------------------------
def split_candidates(ast: rx.Node) -> List[SplitPoint]:
    """Mandatory cut points: bare literals of the top-level concatenation
    chain.  Every accepted path crosses each of them exactly once, so
    seeding from such a literal's edge occurrences is lossless."""
    chain = rx._cat_chain(ast)
    out = []
    for i, part in enumerate(chain):
        if isinstance(part, rx.Lit):
            left = rx.fold_cat(chain[:i]) if i else None
            right = rx.fold_cat(chain[i + 1:]) if i + 1 < len(chain) else None
            out.append(SplitPoint(lit=part, left=left, right=right))
    return out


def first_lits(node: rx.Node) -> Set[rx.Lit]:
    """Literals that can take the first step of a match."""
    if isinstance(node, rx.Eps):
        return set()
    if isinstance(node, rx.Lit):
        return {node}
    if isinstance(node, rx.Cat):
        f = first_lits(node.left)
        if rx.nullable(node.left):
            f = f | first_lits(node.right)
        return f
    if isinstance(node, rx.Alt):
        return first_lits(node.left) | first_lits(node.right)
    if isinstance(node, (rx.Star, rx.Plus, rx.Opt)):
        return first_lits(node.child)
    raise TypeError(node)


def last_lits(node: rx.Node) -> Set[rx.Lit]:
    """Literals that can take the last step of a match — the entry
    predicates of a backward traversal."""
    if isinstance(node, rx.Eps):
        return set()
    if isinstance(node, rx.Lit):
        return {node}
    if isinstance(node, rx.Cat):
        l = last_lits(node.right)
        if rx.nullable(node.right):
            l = l | last_lits(node.left)
        return l
    if isinstance(node, rx.Alt):
        return last_lits(node.left) | last_lits(node.right)
    if isinstance(node, (rx.Star, rx.Plus, rx.Opt)):
        return last_lits(node.child)
    raise TypeError(node)


# -- cost model --------------------------------------------------------------
def _resolved(stats: GraphStats, resolve: Callable[[rx.Lit], int],
              lits: Iterable[rx.Lit]) -> List[int]:
    """Resolve literals to in-range completed predicate ids.  An
    out-of-range id has no edges and drops out (frequency 0 — the
    traversal's ``B.get(p, 0)`` treats it the same way); an
    *unresolvable* name propagates, exactly as compiling the automaton
    would, so plan choice never changes whether a typo raises."""
    out = []
    for lit in lits:
        p = resolve(lit)
        if 0 <= p < stats.num_preds_completed:
            out.append(p)
    return out


_LEN_CAP = 8


def max_match_len(expr: rx.Node) -> int:
    """Maximum word length ``expr`` can match, capped at ``_LEN_CAP``
    (closures count as the cap).  A length-1 expression's traversal ends
    after its entry step — no growth term."""
    if isinstance(expr, rx.Eps):
        return 0
    if isinstance(expr, rx.Lit):
        return 1
    if isinstance(expr, rx.Cat):
        return min(_LEN_CAP,
                   max_match_len(expr.left) + max_match_len(expr.right))
    if isinstance(expr, rx.Alt):
        return max(max_match_len(expr.left), max_match_len(expr.right))
    if isinstance(expr, (rx.Star, rx.Plus)):
        return _LEN_CAP
    if isinstance(expr, rx.Opt):
        return max_match_len(expr.child)
    raise TypeError(expr)


def traversal_cost(stats: GraphStats, resolve: Callable[[rx.Lit], int],
                   expr: Optional[rx.Node],
                   seeds: Optional[float]) -> float:
    """Estimated edges touched by one backward traversal of ``expr``
    seeded at ``seeds`` endpoint nodes (``None`` = the full range).
    ``expr`` must be the automaton actually traversed (pass the reversed
    AST for a subject-side traversal).  The first step touches a
    seed-proportional share of each entry predicate's edges; deeper
    automata add a fan-out term saturating at the total literal
    frequency (monotone visited masks touch nothing twice per state)."""
    if expr is None:
        return 0.0
    all_ids = _resolved(stats, resolve, expr.literals())
    total = float(sum(stats.freq[p] for p in all_ids))
    entry = _resolved(stats, resolve, last_lits(expr))
    if seeds is None:
        start = float(sum(stats.freq[p] for p in entry))
    else:
        start = sum(
            float(stats.freq[p]) * min(1.0, seeds / max(1, stats.distinct_obj[p]))
            for p in entry)
    if max_match_len(expr) <= 1:
        return start
    return start + min(stats.avg_degree * start, total)


def _endpoint_estimate(stats, resolve, lits, counts) -> float:
    ids = _resolved(stats, resolve, lits)
    if not ids:
        return 0.0
    return float(min(stats.num_nodes, sum(counts[p] for p in ids)))


def choose_plan(ast: rx.Node, subject_bound: bool, obj_bound: bool,
                stats: GraphStats, resolve: Callable[[rx.Lit], int],
                policy: str = "cost",
                unanchored_margin: float = 1.0) -> Plan:
    """Pick a physical plan for ``ast`` under the given endpoint binding.

    ``policy``: "cost" picks by estimate; "forward"/"reverse"/"split"
    force that shape (falling back to forward when not applicable — a
    reverse plan needs both endpoints free-or-bound asymmetry, a split
    plan needs a mandatory cut literal).  ``unanchored_margin``: how
    clearly an unanchored rewrite must beat forward (1 = any winner; the
    dense engine passes a higher bar because its native unanchored
    evaluation is one batched all-nodes BFS, not the ring's per-subject
    loop, so the forward estimate overstates its real cost).
    """
    rast = rx.reverse(ast)
    est: Dict[str, float] = {}
    if subject_bound and obj_bound:
        est["forward"] = traversal_cost(stats, resolve, ast, 1)
        est["reverse"] = traversal_cost(stats, resolve, rast, 1)
    elif obj_bound:
        est["forward"] = traversal_cost(stats, resolve, ast, 1)
    elif subject_bound:
        est["forward"] = traversal_cost(stats, resolve, rast, 1)
    else:
        n_subj = _endpoint_estimate(stats, resolve, first_lits(ast),
                                    stats.distinct_subj)
        n_obj = _endpoint_estimate(stats, resolve, last_lits(ast),
                                   stats.distinct_obj)
        est["forward"] = traversal_cost(stats, resolve, ast, None) \
            + n_subj * traversal_cost(stats, resolve, rast, 1)
        est["reverse"] = traversal_cost(stats, resolve, rast, None) \
            + n_obj * traversal_cost(stats, resolve, ast, 1)

    best_split: Optional[SplitPoint] = None
    best_split_pred = -1
    for sp in split_candidates(ast):
        ids = _resolved(stats, resolve, [sp.lit])
        p = ids[0] if ids else -1
        fp = float(stats.freq[p]) if p >= 0 else 0.0
        dsub = float(stats.distinct_subj[p]) if p >= 0 else 0.0
        dobj = float(stats.distinct_obj[p]) if p >= 0 else 0.0
        if obj_bound:
            cost = traversal_cost(stats, resolve, sp.right, 1) + fp \
                + traversal_cost(stats, resolve, sp.left, dsub)
        elif subject_bound:
            cost = traversal_cost(
                stats, resolve,
                rx.reverse(sp.left) if sp.left is not None else None, 1) \
                + fp + traversal_cost(
                    stats, resolve,
                    rx.reverse(sp.right) if sp.right is not None else None,
                    dobj)
        else:
            # unanchored halves stay GROUPED per seed endpoint (the join
            # needs pairs through the same edge), so they cost one
            # single-seed traversal per distinct endpoint — which is what
            # steers the cut toward the least-frequent predicate
            cost = fp \
                + dsub * traversal_cost(stats, resolve, sp.left, 1) \
                + dobj * traversal_cost(
                    stats, resolve,
                    rx.reverse(sp.right) if sp.right is not None else None,
                    1)
        if "split" not in est or cost < est["split"]:
            est["split"] = cost
            best_split, best_split_pred = sp, p

    if policy == "forward" or (policy == "naive"):
        mode = "forward"
    elif policy == "reverse":
        mode = "reverse" if "reverse" in est else "forward"
    elif policy == "split":
        mode = "split" if best_split is not None else "forward"
    else:  # cost
        margin = unanchored_margin if not (subject_bound or obj_bound) \
            else ANCHORED_MARGIN
        mode = "forward"
        best = est["forward"]
        for alt in ("reverse", "split"):
            if alt == "split" and best_split is None:
                continue
            if alt in est and est[alt] * margin < best:
                mode, best = alt, est[alt]

    # est_frontier: predicted seed count of the plan's (second-phase)
    # traversal — split: the cut predicate's edges; unanchored: the
    # endpoint-count estimate phase 2 fans out from; anchored: the one
    # bound endpoint.  Engines report the realized count alongside it in
    # ``QueryStats.plan_actual_frontier``.
    plan = Plan(mode=mode, est=est)
    if mode == "split":
        plan.split = best_split
        plan.split_pred = best_split_pred
        plan.est_frontier = float(stats.freq[best_split_pred]) \
            if best_split_pred >= 0 else 0.0
    elif not (subject_bound or obj_bound):
        plan.est_frontier = n_obj if mode == "reverse" else n_subj
    else:
        plan.est_frontier = 1.0
    return plan


def decide(ast: rx.Node, subject_bound: bool, obj_bound: bool, *,
           policy: str, decisions, stats_provider: Callable[[], GraphStats],
           resolve: Callable[[rx.Lit], int], record=None,
           unanchored_margin: float = 1.0,
           footprint: Optional[frozenset] = None) -> Plan:
    """Engine-shared decision entry point: the ``planner="naive"``
    short-circuit, memoization in the engine's ``decisions`` PlanCache
    (keyed per (canonical expression, binding, policy) class), and the
    ``QueryStats.plan_*`` recording — one implementation for both
    engines.  ``stats_provider`` defers the :class:`GraphStats` harvest
    to the first non-naive decision.  ``footprint`` (the expression's
    raw predicate ids) registers the decision for live-update
    invalidation: a mutation to a footprint predicate shifts the
    selectivity statistics the decision was priced on, so the entry is
    expired and re-planned at the new epoch."""
    if policy == "naive":
        plan = Plan(mode="naive")
    else:
        from .engines import decision_key
        key = decision_key(ast, subject_bound, obj_bound, policy)
        with otrace.span("planner.decide", cat="planner",
                         policy=policy) as sp:
            plan = decisions.get(key, lambda: choose_plan(
                ast, subject_bound, obj_bound, stats_provider(), resolve,
                policy, unanchored_margin=unanchored_margin),
                footprint=footprint)
            sp.set(mode=plan.mode)
    if record is not None:
        record.plan_mode = plan.mode
        record.plan_split_pred = plan.split_pred
        record.plan_est_cost = plan.est.get(plan.mode, 0.0)
        record.plan_est_frontier = plan.est_frontier
    return plan
