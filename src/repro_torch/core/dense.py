"""The dense engine's device-resident graph.

Only :class:`DenseGraph` is ported so far: the completed graph's edges,
sorted by subject, as tensors on one device, which the packed BFS
(:mod:`.packed`) sweeps every superstep.  The dense engine itself
(``DenseRPQ``) is not ported yet, and ``make_engine(kind="dense")``
raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from .ring import LabeledGraph


@dataclass
class DenseGraph:
    """Device-resident completed graph, edges sorted by backward-push
    destination (= subject) for the segment-OR."""

    subj: torch.Tensor  # [E] int32, sorted ascending
    pred: torch.Tensor  # [E] int32 in [0, 2P)
    obj: torch.Tensor   # [E] int32
    num_nodes: int
    num_labels: int     # 2P

    @property
    def device(self) -> torch.device:
        return self.subj.device

    @classmethod
    def from_graph(cls, g: LabeledGraph, device=None) -> "DenseGraph":
        """``device``: ``None`` means ``"cuda"`` (see
        :func:`repro_torch.kernels.ops.resolve_device`)."""
        dev = ops.resolve_device(device)
        P = g.num_preds
        s, p, o = g.completed_triples()
        order = np.argsort(s, kind="stable")

        def put(a):
            return torch.from_numpy(a[order].astype(np.int32)).to(dev)

        return cls(subj=put(s), pred=put(p), obj=put(o),
                   num_nodes=g.num_nodes, num_labels=2 * P)
