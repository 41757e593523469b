"""Brute-force product-graph oracle (Sec. 3.2) — ground truth for tests.

Materializes the classical evaluation: build the Glushkov NFA of E, form
the product graph of the *completed* graph G∪Ĝ with the NFA, and BFS from
(s, q0).  No ring, no wavelet trees, no bit-parallel batching — this is
the reference semantics everything else is validated against.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from . import regex as rx
from .glushkov import Glushkov
from .ring import LabeledGraph


def _completed_adj(graph: LabeledGraph) -> Dict[int, List[Tuple[int, int]]]:
    """label -> list of (source, target) over G ∪ Ĝ."""
    P = graph.num_preds
    adj: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for s, p, o in zip(graph.s, graph.p, graph.o):
        adj[int(p)].append((int(s), int(o)))
        adj[int(p) + P].append((int(o), int(s)))
    return adj


def _resolve(graph: LabeledGraph):
    return graph.resolve_lit


def eval_oracle(
    graph: LabeledGraph,
    expr: str,
    subject: Optional[int] = None,
    obj: Optional[int] = None,
) -> Set[Tuple[int, int]]:
    """Evaluate the 2RPQ (subject, expr, obj) with (None = variable).
    Returns all (s, o) pairs, including zero-length eps matches."""
    ast = rx.parse(expr)
    g = Glushkov.from_ast(ast, _resolve(graph))
    adj = _completed_adj(graph)
    V = graph.num_nodes

    # forward adjacency per (node) with labels, for product BFS
    out_edges: Dict[int, List[Tuple[int, int]]] = defaultdict(list)  # u -> [(p, v)]
    for p, edges in adj.items():
        for u, v in edges:
            out_edges[u].append((p, v))

    # NFA transitions: from state i (bit i), by label c, to states
    # follow_mask[i] & B[c]
    def nfa_step(state: int, label: int) -> int:
        return g.follow_mask[state] & g.B.get(label, 0)

    final_states = [i for i in range(g.m + 1) if (g.F >> i) & 1 and i != 0]

    results: Set[Tuple[int, int]] = set()
    sources = range(V) if subject is None else [subject]
    for s in sources:
        # BFS over (node, nfa_state) pairs
        seen = set()
        start = (s, 0)
        dq = deque([start])
        seen.add(start)
        while dq:
            v, q = dq.popleft()
            for p, w in out_edges.get(v, ()):  # graph step
                targets = nfa_step(q, p)
                for qq in range(1, g.m + 1):
                    if (targets >> qq) & 1:
                        nxt = (w, qq)
                        if nxt not in seen:
                            seen.add(nxt)
                            dq.append(nxt)
        for (v, q) in seen:
            if q in final_states:
                results.add((s, v))
        if g.nullable:
            results.add((s, s))
    if obj is not None:
        results = {(a, b) for (a, b) in results if b == obj}
    if subject is not None:
        results = {(a, b) for (a, b) in results if a == subject}
    return results


def eval_oracle_by_label(
    graph: LabeledGraph,
    expr: str,
    subject: Optional[int] = None,
    obj: Optional[int] = None,
    limit: Optional[int] = None,
) -> Set[Tuple[int, int]]:
    """:func:`eval_oracle`'s answers by a product BFS that follows, from
    each NFA position, only the edges of the labels it can read: from
    the subject when it is bound; backwards from the object when only
    the object is (each position entered through its own label, its
    predecessors from ``follow_mask``; no reversed expression); from
    every node in increasing order when neither is.  With ``limit``, the
    first ``limit`` pairs in sorted order (an unbound search stops at
    the first source after which ``limit`` pairs are known)."""
    g = Glushkov.from_ast(rx.parse(expr), _resolve(graph))
    finals = [q for q in range(1, g.m + 1) if (g.F >> q) & 1]
    # moves[q]: (label, positions entered) for each label q can read
    moves = [[(p, [qq for qq in range(1, g.m + 1)
                   if (g.follow_mask[q] & b) >> qq & 1])
              for p, b in g.B.items() if g.follow_mask[q] & b]
             for q in range(g.m + 1)]
    backward = subject is None and obj is not None
    by_label: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for p, edges in _completed_adj(graph).items():
        for u, v in edges:
            if backward:
                by_label[(v, p)].append(u)
            else:
                by_label[(u, p)].append(v)

    def search(start):
        seen = set(start)
        dq = deque(start)
        while dq:
            v, q = dq.popleft()
            for p, qs in moves[q]:
                for w in by_label.get((v, p), ()):
                    for qq in qs:
                        if (w, qq) not in seen:
                            seen.add((w, qq))
                            dq.append((w, qq))
        return seen

    results: Set[Tuple[int, int]] = set()
    if backward:
        # reverse moves: (label, positions left) for each position entered
        into: Dict[int, List[Tuple[int, List[int]]]] = defaultdict(list)
        for q in range(g.m + 1):
            for p, qs in moves[q]:
                for qq in qs:
                    into[qq].append((p, [q]))
        moves = [into[q] for q in range(g.m + 1)]
        results = {(u, obj) for u, q in search([(obj, f) for f in finals])
                   if q == 0}
        if g.nullable:
            results.add((obj, obj))
    else:
        for s in (range(graph.num_nodes) if subject is None else [subject]):
            results.update((s, v) for v, q in search([(s, 0)])
                           if q in finals and (obj is None or v == obj))
            if g.nullable and obj in (None, s):
                results.add((s, s))
            if limit is not None and len(results) >= limit:
                break
    if limit is not None and len(results) > limit:
        results = set(sorted(results)[:limit])
    return results


def product_subgraph_size(
    graph: LabeledGraph, expr: str, subject=None, obj=None
) -> Tuple[int, int]:
    """|nodes|, |edges| of the query-induced product subgraph G'_E —
    the quantity Theorem 4.1 charges work to.  Induced by paths from
    (s_mu, init) to (o_mu, final): we compute forward-reachable from
    starts intersected with backward-reachable from finals."""
    ast = rx.parse(expr)
    g = Glushkov.from_ast(ast, _resolve(graph))
    adj = _completed_adj(graph)
    V = graph.num_nodes
    out_edges: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    in_edges: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for p, edges in adj.items():
        for u, v in edges:
            out_edges[u].append((p, v))
            in_edges[v].append((p, u))

    # forward reach from (s, 0)
    fwd = set()
    dq = deque()
    sources = range(V) if subject is None else [subject]
    for s in sources:
        if (s, 0) not in fwd:
            fwd.add((s, 0))
            dq.append((s, 0))
    while dq:
        v, q = dq.popleft()
        for p, w in out_edges.get(v, ()):
            t = g.follow_mask[q] & g.B.get(p, 0)
            for qq in range(1, g.m + 1):
                if (t >> qq) & 1 and (w, qq) not in fwd:
                    fwd.add((w, qq))
                    dq.append((w, qq))

    # backward reach from (o, f)
    bwd = set()
    dq = deque()
    finals = [i for i in range(1, g.m + 1) if (g.F >> i) & 1]
    objs = range(V) if obj is None else [obj]
    for o in objs:
        for f in finals:
            if (o, f) not in bwd:
                bwd.add((o, f))
                dq.append((o, f))
    # also initial states of answer sources count as G'_E nodes
    while dq:
        v, q = dq.popleft()
        for p, u in in_edges.get(v, ()):
            if not (g.B.get(p, 0) >> q) & 1:
                continue  # q must be entered via label p
            preds = g.pred_mask[q]
            for qq in range(0, g.m + 1):
                if (preds >> qq) & 1 and (u, qq) not in bwd:
                    bwd.add((u, qq))
                    dq.append((u, qq))

    nodes = fwd & bwd
    nedges = 0
    for (v, q) in nodes:
        for p, w in out_edges.get(v, ()):
            t = g.follow_mask[q] & g.B.get(p, 0)
            for qq in range(1, g.m + 1):
                if (t >> qq) & 1 and (w, qq) in nodes:
                    nedges += 1
    return len(nodes), nedges
