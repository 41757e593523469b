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
from .sharding import Placement, Sharded, shard, unshard


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
    if isinstance(like, Placement):
        # one layout for every layer, behind the stacked layer axis
        return Placement(like.mesh, (None,) + tuple(like.spec))
    return np.stack([np.asarray(a) for a in items])


# the reference's groups of layers, stacked on a leading axis
STACKED = ("layers", "enc_layers", "dec_layers")


def lm_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's parameter tree from a model's flat parameters, any
    family: a layer's entries (``layers.3.attn.wq``,
    ``dec_layers.0.cross.wk``, ``layers.1.moe.shared.wg``) stacked on a
    leading axis of their group (``tree["layers"]["attn"]["wq"][3]``),
    the rest nested by name (``shared_attn.attn.wq`` ->
    ``tree["shared_attn"]["attn"]["wq"]``); tensors or numpy arrays as
    given."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[tuple, list] = {}
    for name, value in flat.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            per_layer.setdefault((parts[0],) + tuple(parts[2:]), []).append(
                (int(parts[1]), value))
        else:
            _put(tree, parts, value)
    for path, items in per_layer.items():
        items.sort(key=lambda iv: iv[0])
        _put(tree, path, _stack([v for _, v in items], items[0][1]))
    return tree


def _put(tree: Dict[str, Any], path, value) -> None:
    *inner, leaf = path
    for p in inner:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def lm_flat(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`lm_tree`: unstack each group of layers into
    ``<group>.<i>.<path>`` entries, join the other paths with dots."""
    flat: Dict[str, Any] = {}

    def walk(node, prefix, group):
        for k, v in node.items():
            path = prefix + (k,)
            if isinstance(v, dict):
                walk(v, path, group)
            elif group:
                for i in range(v.shape[0]):
                    flat[".".join((path[0], str(i)) + path[1:])] = v[i]
            else:
                flat[".".join(path)] = v

    for k, v in tree.items():
        if isinstance(v, dict):
            walk(v, (k,), k in STACKED)
        else:
            flat[k] = v
    return flat


def lm_params_to_reference(model) -> Dict[str, Any]:
    """A port model (or its ``state_dict()``, or a mesh's dict of
    :class:`~repro_torch.sharding.Sharded`, unsharded) as the reference's
    parameter pytree of f32 numpy arrays, layers stacked."""
    state = model.state_dict() if hasattr(model, "state_dict") else model
    return lm_tree({n: (unshard(t) if isinstance(t, Sharded) else t)
                    .detach().cpu().numpy() for n, t in state.items()})


def lm_params_from_reference(tree: Dict[str, Any], mesh=None,
                             specs=None) -> Dict[str, Any]:
    """The reference's parameter pytree (numpy arrays, stacked layers) as a
    port ``state_dict`` on the CPU, for ``model.load_state_dict``; with
    a ``mesh`` and ``specs`` (name -> spec dividing the leaf, e.g. the
    sanitized ``api.param_specs``), each leaf sharded onto the mesh."""
    out = {n: torch.from_numpy(np.array(a, dtype=np.float32))
           for n, a in lm_flat(tree).items()}
    if mesh is None:
        return out
    return {n: shard(t, mesh, specs[n]) for n, t in out.items()}
