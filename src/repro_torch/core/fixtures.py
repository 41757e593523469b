"""Shared graph fixtures: the paper's Fig.-1 metro graph + random generators."""
from __future__ import annotations

import numpy as np

from .ring import LabeledGraph


def metro_graph() -> LabeledGraph:
    """The Santiago metro example of Fig. 1 (subset consistent with the
    worked example of Figs. 5–7): metro lines are bidirectional in the raw
    data, bus edges are one-way (their inverses come from the completion)."""
    T = []

    def bi(a, l, b):
        T.append((a, l, b))
        T.append((b, l, a))

    bi("SA", "l5", "BA")
    bi("Baq", "l5", "BA")
    bi("UCh", "l1", "LH")
    bi("Baq", "l1", "UCh")
    bi("LH", "l2", "SA")
    T.append(("BA", "bus", "SA"))
    T.append(("SA", "bus", "UCh"))
    return LabeledGraph.from_string_triples(T)


def random_graph(
    num_nodes: int,
    num_preds: int,
    num_edges: int,
    seed: int = 0,
    pred_zipf: bool = True,
) -> LabeledGraph:
    """Random labeled multigraph; predicate frequencies Zipf-skewed to
    resemble real KGs (Wikidata predicate usage is heavy-tailed)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, num_nodes, num_edges)
    o = rng.integers(0, num_nodes, num_edges)
    if pred_zipf and num_preds > 1:
        w = 1.0 / np.arange(1, num_preds + 1)
        w /= w.sum()
        p = rng.choice(num_preds, size=num_edges, p=w)
    else:
        p = rng.integers(0, num_preds, num_edges)
    return LabeledGraph.from_arrays(s, p, o, num_nodes, num_preds)


def scale_free_graph(
    num_nodes: int, num_preds: int, num_edges: int, seed: int = 0
) -> LabeledGraph:
    """Preferential-attachment-ish labeled graph: node popularity follows a
    power law like real KG entities (hubs make RPQs hard — good stressor)."""
    rng = np.random.default_rng(seed)
    # power-law node sampling
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    wn = 1.0 / ranks ** 0.8
    wn /= wn.sum()
    s = rng.choice(num_nodes, size=num_edges, p=wn)
    o = rng.choice(num_nodes, size=num_edges, p=wn)
    wp = 1.0 / np.arange(1, num_preds + 1)
    wp /= wp.sum()
    p = rng.choice(num_preds, size=num_edges, p=wp)
    return LabeledGraph.from_arrays(s, p, o, num_nodes, num_preds)
