"""Wikidata-log-style RPQ workload on a scale-free graph (Table 1/2 mini),
on the port.

    python -m repro_torch.examples.wikidata_style_queries               # card
    python -m repro_torch.examples.wikidata_style_queries --device cpu \\
        --nodes 500 --edges 4000 --queries 10                            # host

Generates a hub-heavy labeled graph and a query mix following the
paper's observed pattern distribution, evaluates it with the ring engine
and the dense engine, and prints per-pattern timings, as the JAX
package's ``examples/wikidata_style_queries.py`` does.  Without a card
the default device raises.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from ..core.dense import DenseRPQ
from ..core.fixtures import scale_free_graph
from ..core.patterns import generate_workload
from ..core.ring import Ring
from ..core.rpq import RingRPQ

LIMIT = 100_000
# the JAX package's defaults and seeds: the graph, then the workload
DEFAULTS = {"nodes": 5000, "edges": 40000, "preds": 16, "queries": 25}
GRAPH_SEED, WORKLOAD_SEED = 3, 5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, record: Optional[dict] = None) -> int:
    """Run the workload on ``--device``.  ``record``, when given,
    receives the graph (``"graph"``), the engines by name
    (``"engines"``), each query's ``(expr, subject, obj, pattern)`` with
    both engines' answers (``"answers"``), and per pattern its queries
    (``"counts"``) and each engine's mean ms (``"ms"``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, default in DEFAULTS.items():
        ap.add_argument(f"--{name}", type=int, default=default)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    g = scale_free_graph(args.nodes, args.preds, args.edges,
                         seed=GRAPH_SEED)
    print(f"graph: |V|={g.num_nodes} |E|={g.s.size} |P|={g.num_preds}")
    t0 = time.perf_counter()
    ring = Ring(g)
    print(f"ring built in {time.perf_counter()-t0:.2f}s "
          f"({ring.size_bytes()['total']/g.s.size:.1f} B/raw-edge)")

    engines = {"ring": RingRPQ(ring, device=args.device),
               "dense": DenseRPQ(g, source_batch=8, device=args.device)}
    device = engines["ring"].device
    if device.type == "cuda":
        # build the kernels before the first timed query
        from ..kernels import build_all
        build_all()
    wl = generate_workload(args.queries, args.preds, args.nodes,
                           seed=WORKLOAD_SEED)
    per = defaultdict(lambda: defaultdict(list))
    answers = []
    for expr, s, o, pat in wl.queries:
        res = {}
        for name, eng in engines.items():
            _sync(device)
            t0 = time.perf_counter()
            res[name] = eng.eval(expr, subject=s, obj=o, limit=LIMIT)
            _sync(device)
            per[pat][name].append(time.perf_counter() - t0)
        nres = {name: len(r) for name, r in res.items()}
        assert len(set(nres.values())) == 1, (expr, nres)
        answers.append(((expr, s, o, pat), res["ring"], res["dense"]))

    print(f"\n{'pattern':>14} {'n':>3} {'ring ms':>9} {'dense ms':>9}")
    ms = {}
    for pat, d in sorted(per.items()):
        ms[pat] = {k: float(np.mean(d[k])) * 1e3 for k in ("ring", "dense")}
        print(f"{pat:>14} {len(d['ring']):>3} {ms[pat]['ring']:>9.2f} "
              f"{ms[pat]['dense']:>9.2f}")
    tot = {k: sum(sum(d[k]) for d in per.values()) for k in ("ring", "dense")}
    print(f"\ntotals: ring {tot['ring']:.2f}s  dense {tot['dense']:.2f}s  "
          f"(engines agreed on every query)")
    if record is not None:
        record.update(graph=g, engines=engines, answers=answers, ms=ms,
                      counts={p: len(d["ring"]) for p, d in per.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
