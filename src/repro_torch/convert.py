"""Carry the JAX package's state into the port, and LM parameters back.

Duck-typed on purpose: the port never imports the JAX package, so these
take any object (or state dict) of the right shape.  Engine state
(statistics, live-update overlays) also travels between the packages
through checkpoints: :mod:`repro_torch.checkpoint` reads and writes the
JAX package's format, so nothing here converts it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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


# -- LM parameters: the module's flat names <-> the reference's stacked tree --

def _stack(items, like):
    if isinstance(like, torch.Tensor):
        return torch.stack(items)
    return np.stack([np.asarray(a) for a in items])


def lm_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's parameter tree from a model's flat parameters
    (``Transformer.named_parameters()`` names such as ``layers.3.attn.wq``
    -> ``tree["layers"]["attn"]["wq"][3]``): the layers stacked on a
    leading L axis, tensors or numpy arrays as given."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for name, value in flat.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(".".join(parts[2:]), []).append(
                (int(parts[1]), value))
        else:
            tree[name] = value
    layers: Dict[str, Any] = {}
    for key, items in per_layer.items():
        items.sort(key=lambda iv: iv[0])
        node = layers
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _stack([v for _, v in items], items[0][1])
    if layers:
        tree["layers"] = layers
    return tree


def lm_flat(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`lm_tree`: unstack ``tree["layers"]`` into
    ``layers.<i>.<path>`` entries."""
    flat: Dict[str, Any] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                for i in range(v.shape[0]):
                    flat[".".join(("layers", str(i)) + prefix + (k,))] = v[i]

    for k, v in tree.items():
        if k == "layers":
            walk(v, ())
        else:
            flat[k] = v
    return flat


def lm_params_to_reference(model) -> Dict[str, Any]:
    """A port model (or its ``state_dict()``) as the reference's parameter
    pytree of f32 numpy arrays, layers stacked."""
    state = model.state_dict() if hasattr(model, "state_dict") else model
    return lm_tree({n: t.detach().cpu().numpy() for n, t in state.items()})


def lm_params_from_reference(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy arrays, stacked layers) as a
    port ``state_dict`` on the CPU, for ``model.load_state_dict``."""
    return {n: torch.from_numpy(np.array(a, dtype=np.float32))
            for n, a in lm_flat(tree).items()}
