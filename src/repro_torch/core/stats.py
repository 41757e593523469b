"""Selectivity statistics for the query planner.

Per-predicate frequency and endpoint-cardinality statistics over the
*completed* graph G ∪ Ĝ (Sec. 3.1), harvested from the ring's structure
at index build:

  * ``freq[p]``          — number of completed triples labeled p: on the
    ring this is just ``C_p[p+1] - C_p[p]`` (the L_s block width — the
    same O(1) cardinality the Sec.-5 planning heuristic reads);
  * ``distinct_subj[p]`` — distinct subjects among p's triples, counted
    on the materialized L_s blocks (the leaves of the L_s wavelet tree);
  * ``distinct_obj[p]``  — distinct objects of p.  Completion makes the
    triples of the inverse predicate exact mirrors, so this is
    ``distinct_subj`` of ``p ± P`` — no extra pass.

The whole object is a handful of ``int64`` arrays (O(P) space), cheap
enough to compute eagerly at index build and small enough to serialize
with checkpoints: :meth:`GraphStats.to_state` returns a flat dict of
numpy arrays that rides :mod:`repro_torch.checkpoint` ``save``/``restore``
unchanged, and :meth:`GraphStats.from_state` rebuilds the object on the
other side (so a restored server never rescans the graph to plan).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np


def _inverse_perm(num_preds_completed: int) -> np.ndarray:
    """p -> id of ^p in the completed alphabet (p+P for p<P, p-P else)."""
    P = num_preds_completed // 2
    return np.concatenate([np.arange(P) + P, np.arange(P)])


@dataclass
class GraphStats:
    """Per-predicate selectivity statistics over the completed graph."""

    num_nodes: int
    num_edges: int                 # completed, deduplicated triple count
    num_preds_completed: int       # 2P
    freq: np.ndarray               # [2P] int64, triples per predicate
    distinct_subj: np.ndarray      # [2P] int64
    distinct_obj: np.ndarray       # [2P] int64

    @property
    def avg_degree(self) -> float:
        """Average completed out-degree — the coarse per-step fan-out the
        cost model multiplies frontier estimates by."""
        return self.num_edges / max(1, self.num_nodes)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_ring(cls, ring) -> "GraphStats":
        """Harvest from a built :class:`~repro_torch.core.ring.Ring`: C_p gives
        frequencies directly; distinct subjects are counted per L_s
        predicate block (the blocks are materialized — no tree descent)."""
        P2 = ring.num_preds_completed
        freq = np.diff(ring.C_p).astype(np.int64)
        ds = np.zeros(P2, dtype=np.int64)
        for p in range(P2):
            b, e = int(ring.C_p[p]), int(ring.C_p[p + 1])
            if e > b:
                ds[p] = np.unique(ring.L_s[b:e]).size
        do = ds[_inverse_perm(P2)]
        return cls(num_nodes=ring.num_nodes, num_edges=int(ring.n),
                   num_preds_completed=P2, freq=freq,
                   distinct_subj=ds, distinct_obj=do)

    @classmethod
    def from_graph(cls, graph) -> "GraphStats":
        """Build from raw triple arrays (the dense engine has no ring);
        the completion/dedup encoding is the graph's own
        ``completed_triples`` — the same one the ring indexes."""
        P = graph.num_preds
        V = graph.num_nodes
        s, p, _o = graph.completed_triples()
        freq = np.bincount(p, minlength=2 * P).astype(np.int64)
        # distinct (p, subject) pairs, counted per predicate
        ps = np.unique(p * V + s)
        ds = np.bincount((ps // V).astype(np.int64),
                         minlength=2 * P).astype(np.int64)
        do = ds[_inverse_perm(2 * P)]
        return cls(num_nodes=V, num_edges=int(s.size),
                   num_preds_completed=2 * P, freq=freq,
                   distinct_subj=ds, distinct_obj=do)

    # -- live updates --------------------------------------------------------
    def refresh_preds(self, preds_completed, pred_edges) -> None:
        """Incremental update after a mutation batch: recompute frequency
        and distinct-endpoint counts for exactly the mutated completed
        predicates (``pred_edges(p)`` returns the *effective* (subjects,
        objects) arrays — base minus tombstones plus the insert buffer),
        leaving every untouched predicate's statistics in place.  Cost is
        O(freq[p]) per mutated predicate, so the planner's forward /
        reverse / split choices stay sound between compactions without a
        full graph rescan."""
        for p in preds_completed:
            if not (0 <= p < self.num_preds_completed):
                continue
            sarr, oarr = pred_edges(p)
            self.freq[p] = sarr.size
            # node ids are small non-negative ints: counting them is
            # linear, where np.unique sorts (a live write waits on this)
            self.distinct_subj[p] = np.count_nonzero(np.bincount(sarr))
            self.distinct_obj[p] = np.count_nonzero(np.bincount(oarr))
        self.num_edges = int(self.freq.sum())

    # -- checkpoint serialization -------------------------------------------
    def to_state(self) -> Dict[str, np.ndarray]:
        """Flat array pytree for :mod:`repro_torch.checkpoint` (scalars as 0-d
        int64 arrays so every leaf is an array)."""
        return {
            "num_nodes": np.int64(self.num_nodes),
            "num_edges": np.int64(self.num_edges),
            "num_preds_completed": np.int64(self.num_preds_completed),
            "freq": self.freq,
            "distinct_subj": self.distinct_subj,
            "distinct_obj": self.distinct_obj,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "GraphStats":
        """Leaves may be numpy arrays or tensors on any device (what
        :func:`repro_torch.checkpoint.restore` returns)."""
        return cls(
            num_nodes=int(host_array(state["num_nodes"])),
            num_edges=int(host_array(state["num_edges"])),
            num_preds_completed=int(host_array(state["num_preds_completed"])),
            freq=host_array(state["freq"], np.int64),
            distinct_subj=host_array(state["distinct_subj"], np.int64),
            distinct_obj=host_array(state["distinct_obj"], np.int64),
        )


def host_array(x: Any, dtype=None) -> np.ndarray:
    """A state leaf as a numpy array: numpy and scalars as they are, a
    tensor on any device copied to the host."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)
