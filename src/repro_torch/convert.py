"""Carry the JAX package's state into the port.

Duck-typed on purpose: the port never imports the JAX package, so these
take any object (or state dict) of the right shape.  Engine state
(statistics, live-update overlays) also travels between the packages
through checkpoints: :mod:`repro_torch.checkpoint` reads and writes the
JAX package's format, so nothing here converts it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .core.ring import LabeledGraph
from .core.stats import GraphStats


def graph_from_reference(g: Any) -> LabeledGraph:
    """A port :class:`LabeledGraph` from any object with numpy ``s, p, o,
    num_nodes, num_preds, node_names, pred_names`` (the JAX package's
    ``LabeledGraph`` among them).  Arrays are copied."""
    names = getattr(g, "node_names", None)
    preds = getattr(g, "pred_names", None)
    return LabeledGraph(
        s=np.array(g.s, dtype=np.int64),
        p=np.array(g.p, dtype=np.int64),
        o=np.array(g.o, dtype=np.int64),
        num_nodes=int(g.num_nodes),
        num_preds=int(g.num_preds),
        node_names=list(names) if names is not None else None,
        pred_names=list(preds) if preds is not None else None,
    )


def stats_from_reference(state: Dict[str, Any]) -> GraphStats:
    """A port :class:`GraphStats` from ``GraphStats.to_state()`` of either
    package (a flat dict of numpy arrays)."""
    return GraphStats.from_state(state)
