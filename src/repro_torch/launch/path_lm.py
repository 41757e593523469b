"""Train an LM on RPQ-sampled path corpora: the port's counterpart of the
JAX package's ``examples/train_path_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.path_lm          # ~1M params
    PYTHONPATH=src python -m repro_torch.launch.path_lm --full   # smollm-135m

Training sequences are edge-label paths sampled from a scale-free graph
and filtered by the RPQ's Glushkov automaton, so every sequence matches
the RPQ: the LM learns the regular language of graph paths.  Same graph,
expression, corpus and optimiser as the example.  Checkpoint/resume is
on: re-running the same command continues from the last checkpoint
(``--ckpt ""`` turns it off).  Without ``--device`` it runs on the card
and fails without one.  The last line printed is a JSON report.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np

from ..configs import get_config, smoke_variant
from ..core.fixtures import scale_free_graph
from ..data.pipeline import PathCorpus
from ..train import loop, optim


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the real smollm-135m widths")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--expr", type=str, default="(0|1)/2*/(3|4)+")
    ap.add_argument("--ckpt", type=str, default="artifacts/path_lm_ckpt",
                    help='checkpoint directory ("" for none)')
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap


def run(argv: Optional[Sequence[str]] = None, log_fn=print):
    """Parse ``argv`` and train.  Returns (report dict, cfg, TrainReport)."""
    args = parser().parse_args(argv)
    t0 = time.perf_counter()
    g = scale_free_graph(2000, 8, 16000, seed=11)
    data = PathCorpus(g, seq_len=128, global_batch=8, expr=args.expr, seed=0)
    corpus_s = time.perf_counter() - t0
    log_fn(f"path corpus over |V|={g.num_nodes} |E|={g.s.size}, "
           f"RPQ={args.expr!r}, vocab={data.vocab_size}")

    base = get_config("smollm-135m")
    if args.full:
        cfg = replace(base, vocab_size=data.vocab_size, tp_divisor=1)
    else:
        cfg = replace(smoke_variant(base), vocab_size=data.vocab_size,
                      num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=512)
    log_fn(f"model: {cfg.num_layers}L d={cfg.d_model} "
           f"(~{cfg.param_count()/1e6:.1f}M params)")

    rep = loop.train(
        cfg, data, num_steps=args.steps,
        opt_cfg=optim.AdamWConfig(lr=1e-3, warmup_steps=20,
                                  total_steps=args.steps),
        ckpt_dir=args.ckpt or None, save_every=100, log_every=20,
        log_fn=log_fn, device=args.device)
    first = float(np.mean(rep.losses[:5])) if rep.losses else float("nan")
    last = float(np.mean(rep.losses[-5:])) if rep.losses else float("nan")
    uniform = float(np.log(data.vocab_size))
    report = {
        "full": args.full, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": data.vocab_size, "params": cfg.param_count(),
        "steps_run": rep.steps_run, "resumed_from": rep.resumed_from,
        "first5": first, "last5": last, "uniform": uniform,
        "learned": last < uniform - 1.0,
        "corpus_s": corpus_s + rep.data_seconds,
        "steps_s": float(sum(rep.step_seconds))}
    return report, cfg, rep


def main(argv: Optional[Sequence[str]] = None) -> int:
    report, _, _ = run(argv)
    print(f"\nsteps run: {report['steps_run']} "
          f"(resumed from: {report['resumed_from']})")
    print(f"loss: first5={report['first5']:.3f} last5={report['last5']:.3f}")
    print(f"uniform baseline: {report['uniform']:.3f} — the LM learned the "
          f"RPQ structure: {report['learned']}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
