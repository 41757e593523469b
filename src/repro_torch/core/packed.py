"""Bit-packed BFS: the paper's word-level representation on the card.

Frontier and visited sets are packed state words ([V, W] uint32 bit
patterns in int32 tensors, W = ceil(S/32)), and each superstep expands
the edges of the live objects of a :class:`DenseGraph` (its edges
grouped by object) in one kernel call (``kernels/packed_superstep.py``):

    X = frontier[obj] & B[pred]       (gather + Fact-1 mask)
    Y = T'[X]                         (the transition, as nfa_step)
    new = OR of Y by subj & ~visited  (as segment_or, and the and-not)

The loop is the dense engine's, :func:`repro_torch.core.dense.bfs_rows`
with one row, on ``dg``'s device: the kernel on a CUDA device, its plain
version on the CPU.  It queues growing chunks of supersteps (1, 2, 4,
... up to 16) between two 4-byte reads of the kernel's flag (a host
sync each), one superstep a chunk when an ``on_step`` hook is given.
:func:`packed_eval` answers a query with it, by the dense engine's rule
for unsplit plans; :func:`one_endpoint_bfs` is that rule's automaton and
start for a request with one endpoint bound.
"""
from __future__ import annotations

from itertools import repeat
from typing import Callable, List, Optional, Set, Tuple

import numpy as np

from ..kernels import ops
from . import regex as rx
from .dense import DenseGraph, bfs_rows
from .glushkov import Glushkov
from .ring import LabeledGraph


def packed_tables(g: Glushkov, num_labels: int, device=None):
    """B_packed [L, W] and BWD (pred-mask matrix) [S, W], F_packed [W] and
    init_packed [W], as int32 words on ``device`` (``None`` means
    ``"cuda"``, see :func:`repro_torch.kernels.ops.resolve_device`)."""
    dev = ops.resolve_device(device)
    Bp, bwd, _fwd, Fp, ip = g.packed_tables(num_labels, lambda l: l)
    return tuple(ops.words_to_tensor(a, dev) for a in (Bp, bwd, Fp, ip))


def packed_bfs(
    dg: DenseGraph,
    g: Glushkov,
    start_objs,
    max_steps: Optional[int] = None,
    on_step: Optional[Callable] = None,
) -> Tuple[np.ndarray, int]:
    """Returns (visited [V, W] uint32, iterations).  ``on_step``, if
    given, is called before each superstep with ``(frontier, visited,
    Bp, bwd)``, the [V, W], [L, W] and [S, W] tensors that superstep
    reads: ``visited`` does not hold the frontier's bits yet (the
    superstep ORs them in), and the superstep's transition inputs are
    ``frontier[dg.edges.obj] & Bp[dg.edges.pred]``.  The hook must not write them."""
    V = dg.num_nodes
    W = g.nwords
    dev = dg.device
    Bp, bwd, Fp, _ip = packed_tables(g, dg.num_labels, dev)
    D0 = ops.tensor_to_words(Fp).copy()
    D0[0] &= ~np.uint32(1)  # strip eps/initial acceptance bit
    planes = np.zeros((V, W), dtype=np.uint32)
    planes[np.asarray(start_objs)] = D0
    steps = max_steps if max_steps is not None else V * (g.m + 1) + 1
    hook = None
    if on_step is not None:
        def hook(f, v, _Bp, _bwd):
            on_step(f[0], v[0], Bp, bwd)
    visited, _frontier, it = bfs_rows(
        dg.edges, Bp[None], bwd[None],
        ops.words_to_tensor(planes, dev)[None], steps, on_step=hook)
    return ops.tensor_to_words(visited[0]), it


def answers_from_visited(visited_packed: np.ndarray) -> np.ndarray:
    """Nodes whose initial-state bit (bit 0 of word 0) is set."""
    return (visited_packed[:, 0] & 1).astype(bool)


def one_endpoint_bfs(graph: LabeledGraph, ast, subject: Optional[int],
                     obj: Optional[int]) -> Tuple[Glushkov, List[int]]:
    """The automaton and start of the BFS that answers (subject, E, obj),
    ``ast`` the parsed E, with exactly one endpoint bound: ``(?, E, o)``
    runs E's automaton from o and finds the subjects; ``(s, E, ?)`` runs
    the reversed expression's from s and finds the objects."""
    if subject is None:
        return Glushkov.from_ast(ast, graph.resolve_lit), [obj]
    return Glushkov.from_ast(rx.reverse(ast), graph.resolve_lit), [subject]


def packed_eval(dg: DenseGraph, graph: LabeledGraph, expr: str,
                subject: Optional[int] = None, obj: Optional[int] = None,
                on_step: Optional[Callable] = None,
                ) -> Tuple[Set[Tuple[int, int]], int]:
    """The 2RPQ (subject, expr, obj), ``None`` a variable, through
    :func:`packed_bfs` on ``dg`` (built from ``graph``): the JAX dense
    engine's rule for a plan that is not split.  One endpoint bound: see
    :func:`one_endpoint_bfs`; ``(?, E, ?)`` finds the subjects from every
    object, then the objects of each; the eps pairs join when E is
    nullable.  ``on_step`` goes to every :func:`packed_bfs`.  Returns
    (pairs, supersteps)."""
    ast = rx.parse(expr)
    null = rx.nullable(ast)
    steps = 0

    def reach(g: Glushkov, starts) -> List[int]:
        nonlocal steps
        visited, it = packed_bfs(dg, g, starts, on_step=on_step)
        steps += it
        return np.nonzero(answers_from_visited(visited))[0].tolist()

    out: Set[Tuple[int, int]] = set()
    if subject is None and obj is None:
        if null:
            out.update((v, v) for v in range(graph.num_nodes))
        fwd = Glushkov.from_ast(ast, graph.resolve_lit)
        rev = Glushkov.from_ast(rx.reverse(ast), graph.resolve_lit)
        for s in reach(fwd, np.arange(graph.num_nodes)):
            out.update(zip(repeat(s), reach(rev, [s])))
    elif subject is None or obj is None:
        end = obj if subject is None else subject
        if null:
            out.add((end, end))
        found = reach(*one_endpoint_bfs(graph, ast, subject, obj))
        out.update(zip(found, repeat(obj)) if subject is None
                   else zip(repeat(subject), found))
    elif null and subject == obj:
        out.add((subject, obj))
    elif subject in reach(Glushkov.from_ast(ast, graph.resolve_lit), [obj]):
        out.add((subject, obj))
    return out, steps
