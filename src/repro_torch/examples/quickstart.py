"""Quickstart: the paper's Fig.-1 metro graph end to end, on the port.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu   # on the host

Builds the ring over the Santiago metro graph, runs the paper's worked
2RPQ (Baq, l5+/bus, y) (Secs. 4.1-4.3, Figs. 5-7) on the ring and dense
engines, and shows a few more query forms.  Prints what the JAX
package's ``examples/quickstart.py`` prints, line for line.  Without a
card the default device raises.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from ..core.dense import DenseRPQ
from ..core.fixtures import metro_graph
from ..core.ring import Ring
from ..core.rpq import QueryStats, RingRPQ

# (expression, subject name, object name, what it asks)
QUERIES = [
    ("(l1|l2|l5)+", None, None, "all metro-connected pairs (x, E, y)"),
    ("(l1|l2|l5)+", None, "SA", "who reaches SA by metro (x, E, SA)"),
    ("bus/^bus", None, None, "same bus stop neighbours"),
    ("l1/l2?/bus", "Baq", None, "metro then optional l2 then bus"),
]


def main(argv=None, record: Optional[dict] = None) -> int:
    """Run the quickstart on ``--device``.  ``record``, when given,
    receives each query's ``(expr, subject, obj)`` and both engines'
    answers under ``"answers"``, and the graph under ``"graph"``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    g = metro_graph()
    ring = Ring(g)
    names = g.node_names
    n2i = {n: i for i, n in enumerate(names)}
    answers = []

    def fmt(res):
        return sorted((names[s], names[o]) for s, o in res)

    print("=== the ring over the metro graph ===")
    print(f"nodes: {names}")
    print(f"predicates: {g.pred_names} (+ inverses in the completion)")
    sizes = ring.size_bytes()
    print(f"ring size: {sizes['total']} bytes for {ring.n} completed triples "
          f"({sizes['total']/ring.n:.1f} B/edge)\n")

    eng = RingRPQ(ring, device=args.device)
    dense = DenseRPQ(g, device=args.device)

    print("=== paper worked example: (Baq, l5+/bus, y) ===")
    stats = QueryStats()
    res = eng.eval("l5+/bus", subject=n2i["Baq"], stats=stats)
    print(f"ring engine:  {fmt(res)}   (expected: SA and UCh reachable)")
    print(f"  bfs_steps={stats.bfs_steps} wt_nodes={stats.wt_nodes_visited} "
          f"activations={stats.node_state_activations}")
    dres = dense.eval("l5+/bus", subject=n2i["Baq"])
    print(f"dense engine: {fmt(dres)}\n")
    answers.append((("l5+/bus", n2i["Baq"], None), res, dres))

    for expr, sname, oname, desc in QUERIES:
        s = None if sname is None else n2i[sname]
        o = None if oname is None else n2i[oname]
        res = eng.eval(expr, subject=s, obj=o)
        dres = dense.eval(expr, subject=s, obj=o)
        answers.append(((expr, s, o), res, dres))
        print(f"{desc}\n  {expr!r}: {len(res)} results, engines agree: "
              f"{res == dres}")
        if len(res) <= 12:
            print(f"  {fmt(res)}")
    print("\nok.")
    if record is not None:
        record.update(graph=g, answers=answers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
