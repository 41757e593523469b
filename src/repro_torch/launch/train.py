"""Training launcher, the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --seq 256 --batch 8 [--ckpt artifacts/run1] [--smoke] \\
        [--model-axis 2] [--shards 4]

With ``--model-axis`` or ``--shards`` it trains on a ``("data",
"model")`` mesh from ``launch.mesh.make_host_mesh``: over every visible
card, or ``--shards`` repeats of the one device (any family);
with neither, on one device.

Trains on ``SyntheticLM`` from a random init: any decoder-only family
(dense, moe, ssm, hybrid); a vlm or encdec batch needs patches or
frames that ``SyntheticLM`` does not make, so those two are refused.
Without ``--device`` it runs on the card and fails without one;
``--device cpu`` runs on the host.  The last line printed is a JSON
report.
"""
from __future__ import annotations

import argparse
import json
import statistics
from dataclasses import replace
from typing import Optional, Sequence

from ..configs import get_config, smoke_variant
from ..data.pipeline import SyntheticLM
from ..train import loop, optim
from .mesh import add_mesh_args, mesh_from_args


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    add_mesh_args(ap)
    return ap


def run(argv: Optional[Sequence[str]] = None, log_fn=print):
    """Parse ``argv`` and train.  Returns (cfg, TrainReport)."""
    ap = parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.family in ("vlm", "encdec"):
        ap.error(f"{args.arch}: SyntheticLM has no {cfg.family} batches "
                 "(patch embeddings or frames)")
    if args.smoke:
        cfg = smoke_variant(cfg)
        cfg = replace(cfg, name=cfg.name.replace("-smoke", ""))
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    rep = loop.train(
        cfg, data, num_steps=args.steps,
        opt_cfg=optim.AdamWConfig(lr=args.lr,
                                  warmup_steps=max(1, args.steps // 20),
                                  total_steps=args.steps),
        ckpt_dir=args.ckpt, save_every=args.save_every, log_every=10,
        log_fn=log_fn, device=args.device, mesh=mesh_from_args(args))
    return cfg, rep


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg, rep = run(argv)
    print(f"done: {rep.steps_run} steps, final loss {rep.final_loss:.4f}"
          + (f" (resumed from {rep.resumed_from})" if rep.resumed_from
             else ""))
    print(json.dumps({
        "arch": cfg.name, "steps_run": rep.steps_run,
        "resumed_from": rep.resumed_from, "losses": rep.losses,
        "median_step_s": (statistics.median(rep.step_seconds)
                          if rep.step_seconds else None),
        "data_s": rep.data_seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
