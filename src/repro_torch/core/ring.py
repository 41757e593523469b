"""The ring (Arroyuelo et al., SIGMOD'21) — BWT of the triple set.

Sec. 3.4: the n triples (s,p,o) are length-3 circular strings.  Sorting
the rotations gives three column arrays; the RPQ algorithm (Sec. 4) only
needs two of them plus two count arrays:

  * ``L_p`` — predicates, triples sorted by (o,s,p)  ("osp" order)
  * ``L_s`` — subjects,   triples sorted by (p,o,s)  ("pos" order)
  * ``C_o[v]`` — # triples with object  < v  (aligns object ranges in L_p)
  * ``C_p[p]`` — # triples with predicate < p (aligns predicate blocks in L_s)

Backward search (Eqs. 4–5), 0-indexed and half-open: an object range
``L_p[b:e)`` maps by predicate p to the subject range

    L_s[ C_p[p] + rank_p(L_p, b) :  C_p[p] + rank_p(L_p, e) )

The graph is *completed* (Sec. 3.1): every edge (s,p,o) also appears
reversed as (o, p+P, s), so 2RPQ inverses ``^p`` are ordinary predicates
p+P.  This doubles edges — the paper's measured ~2x-of-raw-data space.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .wavelet import WaveletTree


@dataclass
class LabeledGraph:
    """Dictionary-encoded labeled graph (pre-completion)."""

    s: np.ndarray
    p: np.ndarray
    o: np.ndarray
    num_nodes: int
    num_preds: int
    node_names: Optional[List[str]] = None
    pred_names: Optional[List[str]] = None

    @classmethod
    def from_string_triples(
        cls, triples: Iterable[Tuple[str, str, str]]
    ) -> "LabeledGraph":
        node_id: Dict[str, int] = {}
        pred_id: Dict[str, int] = {}
        ss, pp, oo = [], [], []
        for s, p, o in triples:
            for name in (s, o):
                if name not in node_id:
                    node_id[name] = len(node_id)
            if p not in pred_id:
                pred_id[p] = len(pred_id)
            ss.append(node_id[s])
            pp.append(pred_id[p])
            oo.append(node_id[o])
        node_names = [None] * len(node_id)
        for k, v in node_id.items():
            node_names[v] = k
        pred_names = [None] * len(pred_id)
        for k, v in pred_id.items():
            pred_names[v] = k
        return cls(
            s=np.asarray(ss, dtype=np.int64),
            p=np.asarray(pp, dtype=np.int64),
            o=np.asarray(oo, dtype=np.int64),
            num_nodes=len(node_id),
            num_preds=len(pred_id),
            node_names=node_names,
            pred_names=pred_names,
        )

    @classmethod
    def from_arrays(cls, s, p, o, num_nodes=None, num_preds=None) -> "LabeledGraph":
        s = np.asarray(s, dtype=np.int64)
        p = np.asarray(p, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        if num_nodes is None:
            num_nodes = int(max(s.max(initial=-1), o.max(initial=-1)) + 1)
        if num_preds is None:
            num_preds = int(p.max(initial=-1) + 1)
        return cls(s=s, p=p, o=o, num_nodes=num_nodes, num_preds=num_preds)

    def pred_of(self, name: str, inverse: bool = False) -> int:
        """Resolve a predicate literal to a completed-graph id."""
        if self.pred_names is not None:
            if not hasattr(self, "_pred_idx"):
                object.__setattr__(
                    self, "_pred_idx", {n: i for i, n in enumerate(self.pred_names)}
                )
            base = self._pred_idx[name]
        else:
            base = int(name)
        return base + self.num_preds if inverse else base

    def completed_triples(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(s, p, o) of the completion G ∪ Ĝ — every edge also reversed
        with predicate p+P — deduplicated via the canonical (o, p, s)
        key packing.  THE one encoding of the completion: the ring, the
        dense graph, and the planner statistics all build from it."""
        P, V = self.num_preds, self.num_nodes
        s = np.concatenate([self.s, self.o])
        p = np.concatenate([self.p, self.p + P])
        o = np.concatenate([self.o, self.s])
        key = (o * (2 * P) + p) * V + s
        uniq = np.unique(key)
        o = (uniq // (2 * P * V)).astype(np.int64)
        rem = uniq % (2 * P * V)
        p = (rem // V).astype(np.int64)
        s = (rem % V).astype(np.int64)
        return s, p, o

    def resolve_lit(self, lit) -> int:
        """Regex literal (:class:`repro_torch.core.regex.Lit`) -> completed id;
        ``^p`` flips across the completion boundary.  The single
        resolution rule every engine, oracle, and the planner share."""
        if self.pred_names is not None and not lit.name.isdigit():
            base = self.pred_of(lit.name, False)
        else:
            base = int(lit.name)
        if lit.inverse:
            base = base + self.num_preds if base < self.num_preds \
                else base - self.num_preds
        return base


class Ring:
    """The ring index over the completed graph G ∪ Ĝ."""

    def __init__(self, graph: LabeledGraph):
        self.graph = graph
        V, P = graph.num_nodes, graph.num_preds
        self.num_nodes = V
        self.num_preds = P
        self.num_preds_completed = 2 * P

        # completion: add (o, p+P, s) for every (s,p,o); the ring is a
        # *set* of triples — completed_triples dedupes (relevant for
        # tests with random multigraphs; real dict-encoded data is
        # already a set)
        s, p, o = graph.completed_triples()
        self.n = int(s.size)

        # L_p: triples sorted by (o, s, p) — np.lexsort: last key is primary
        order_osp = np.lexsort((p, s, o))
        self.L_p = p[order_osp]
        # L_s: triples sorted by (p, o, s)
        order_pos = np.lexsort((s, o, p))
        self.L_s = s[order_pos]

        self.C_o = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(np.bincount(o, minlength=V), out=self.C_o[1:])
        self.C_p = np.zeros(2 * P + 1, dtype=np.int64)
        np.cumsum(np.bincount(p, minlength=2 * P), out=self.C_p[1:])

        self.wt_p = WaveletTree(self.L_p, 2 * P)
        self.wt_s = WaveletTree(self.L_s, V)

    # -- navigation primitives (Sec. 3.4) -----------------------------------
    def object_range(self, v: int) -> Tuple[int, int]:
        """L_p interval of triples whose object is v (half-open)."""
        return int(self.C_o[v]), int(self.C_o[v + 1])

    def full_range(self) -> Tuple[int, int]:
        return 0, self.n

    def pred_range(self, p: int) -> Tuple[int, int]:
        """L_s interval of triples with predicate p."""
        return int(self.C_p[p]), int(self.C_p[p + 1])

    def backward_search(self, b: int, e: int, p: int) -> Tuple[int, int]:
        """Object range L_p[b:e) --p--> subject range in L_s (Eqs. 4–5)."""
        rb = int(self.wt_p.rank(p, b))
        re = int(self.wt_p.rank(p, e))
        return int(self.C_p[p]) + rb, int(self.C_p[p]) + re

    def pred_cardinality(self, p: int) -> int:
        return int(self.C_p[p + 1] - self.C_p[p])

    # -- bookkeeping ---------------------------------------------------------
    def size_bytes(self, include_L_o: bool = False) -> Dict[str, int]:
        sizes = {
            "wt_Lp": self.wt_p.size_bytes(),
            "wt_Ls": self.wt_s.size_bytes(),
            "C_o": self.C_o.nbytes,
            "C_p": self.C_p.nbytes,
        }
        sizes["total"] = sum(sizes.values())
        return sizes

    def triples_completed(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Reconstruct the completed triple set (for tests/oracle)."""
        return self.graph.completed_triples()
