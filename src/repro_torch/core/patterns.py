"""Query-pattern classification + Wikidata-log-style workload generation.

Table 1 of the paper classifies RPQs into patterns by mapping endpoint
nodes to c(onstant)/v(ariable) and erasing predicate names, keeping only
the operators (e.g. ``(x, p1/p2*, y)`` -> ``v /* c|v``).  We reproduce
that classification and generate synthetic workloads that follow the
paper's observed pattern mix, so the Table-2/Fig-8 benchmark mirrors the
real query-log composition.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import regex as rx

# (pattern, count) — the 20 most popular patterns in the paper's log (Table 1)
TABLE1 = [
    ("v /* c", 537), ("v * c", 433), ("v + c", 109), ("c * v", 99),
    ("c /* v", 95), ("v / c", 54), ("v */* c", 44), ("v / v", 41),
    ("v * c2", 36), ("v | v", 31), ("v */*/*/* c", 28), ("v ^ v", 26),
    ("v /* v", 25), ("v * v", 25), ("v /? c", 22), ("v + v", 17),
    ("v /+ c", 12), ("v || v", 10), ("v c", 10), ("v /^ v", 7),
]


def _op_signature(node: rx.Node) -> str:
    """Erase predicates, keep operator shape (close to the paper's scheme)."""
    if isinstance(node, rx.Eps):
        return "e"
    if isinstance(node, rx.Lit):
        return "^" if node.inverse else ""
    if isinstance(node, rx.Cat):
        return _op_signature(node.left) + "/" + _op_signature(node.right)
    if isinstance(node, rx.Alt):
        return _op_signature(node.left) + "|" + _op_signature(node.right)
    if isinstance(node, rx.Star):
        return _op_signature(node.child) + "*"
    if isinstance(node, rx.Plus):
        return _op_signature(node.child) + "+"
    if isinstance(node, rx.Opt):
        return _op_signature(node.child) + "?"
    raise TypeError(node)


def classify(expr: str, subject_fixed: bool, object_fixed: bool) -> str:
    sig = _op_signature(rx.parse(expr))
    lhs = "c" if subject_fixed else "v"
    rhs = "c" if object_fixed else "v"
    return f"{lhs} {sig} {rhs}"


@dataclass
class Workload:
    """A list of (expr, subject, obj, pattern) queries."""

    queries: List[Tuple[str, Optional[int], Optional[int], str]]


# template -> make_expr(preds) -> expr string; mirrors Table 1 shapes
_TEMPLATES = [
    ("v /* c", lambda ps: f"{ps[0]}/{ps[1]}*", False, True, 537),
    ("v * c", lambda ps: f"{ps[0]}*", False, True, 433),
    ("v + c", lambda ps: f"{ps[0]}+", False, True, 109),
    ("c * v", lambda ps: f"{ps[0]}*", True, False, 99),
    ("c /* v", lambda ps: f"{ps[0]}/{ps[1]}*", True, False, 95),
    ("v / c", lambda ps: f"{ps[0]}/{ps[1]}", False, True, 54),
    ("v */* c", lambda ps: f"{ps[0]}*/{ps[1]}*", False, True, 44),
    ("v / v", lambda ps: f"{ps[0]}/{ps[1]}", False, False, 41),
    ("v | v", lambda ps: f"{ps[0]}|{ps[1]}", False, False, 31),
    ("v */*/*/* c", lambda ps: f"{ps[0]}*/{ps[1]}*/{ps[2]}*/{ps[3]}*", False, True, 28),
    ("v ^ v", lambda ps: f"^{ps[0]}", False, False, 26),
    ("v /* v", lambda ps: f"{ps[0]}/{ps[1]}*", False, False, 25),
    ("v * v", lambda ps: f"{ps[0]}*", False, False, 25),
    ("v /? c", lambda ps: f"{ps[0]}/{ps[1]}?", False, True, 22),
    ("v + v", lambda ps: f"{ps[0]}+", False, False, 17),
    ("v /+ c", lambda ps: f"{ps[0]}/{ps[1]}+", False, True, 12),
    ("v || v", lambda ps: f"{ps[0]}|{ps[1]}|{ps[2]}", False, False, 10),
    ("v c", lambda ps: f"{ps[0]}", False, True, 10),
    ("v /^ v", lambda ps: f"{ps[0]}/^{ps[1]}", False, False, 7),
]


def generate_workload(
    num_queries: int,
    num_preds: int,
    num_nodes: int,
    seed: int = 0,
    pred_weights: Optional[np.ndarray] = None,
) -> Workload:
    """Sample queries following the Table-1 pattern mix.  Predicates are
    drawn Zipf-like (real predicate usage is heavily skewed)."""
    rnd = random.Random(seed)
    weights = [t[-1] for t in _TEMPLATES]
    total = sum(weights)
    if pred_weights is None:
        ranks = np.arange(1, num_preds + 1, dtype=np.float64)
        pred_weights = 1.0 / ranks
    pred_weights = np.asarray(pred_weights, dtype=np.float64)
    pred_weights = pred_weights / pred_weights.sum()

    queries = []
    for _ in range(num_queries):
        r = rnd.random() * total
        acc = 0.0
        chosen = _TEMPLATES[-1]
        for t in _TEMPLATES:
            acc += t[-1]
            if r <= acc:
                chosen = t
                break
        pattern, make_expr, s_fixed, o_fixed, _w = chosen
        ps = [
            int(np.searchsorted(np.cumsum(pred_weights), rnd.random()))
            for _ in range(4)
        ]
        ps = [min(p, num_preds - 1) for p in ps]
        expr = make_expr([str(p) for p in ps])
        subject = rnd.randrange(num_nodes) if s_fixed else None
        obj = rnd.randrange(num_nodes) if o_fixed else None
        queries.append((expr, subject, obj, pattern))
    return Workload(queries)
