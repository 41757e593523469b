"""Serving launcher, the JAX package's ``launch/serve.py``: prefill a
batch of prompts, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --batch 4 --prompt-len 2048 --gen 32 [--smoke] [--device cpu] \\
        [--model-axis 2] [--shards 4]

With ``--model-axis`` or ``--shards`` it serves on a ``("data",
"model")`` mesh (``launch.mesh.make_host_mesh``, any family)
under the serving rules: bf16 weights split over the model axis,
replicated over the data axes; a batch smaller than the data axes
serves under ``small_batch`` (the KV cache's sequence on the data
axes).

Random weights from a seed and random prompts: a vlm's prompt also has
``num_prefix_embeds`` random patch embeddings before its tokens, an
encdec's ``--frames`` random frame embeddings for its encoder.  Without
``--device`` it runs on the card and fails without one.  The last line
printed is a JSON report.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import sharding as shd
from ..configs import get_config, smoke_variant
from ..kernels.ops import resolve_device
from ..models import api
from ..train.step import make_prefill_step, make_serve_step
from .mesh import add_mesh_args, mesh_from_args


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--frames", type=int, default=16,
                    help="encoder frames of an encdec prompt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    add_mesh_args(ap)
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prompt_batch(cfg, batch: int, prompt_len: int, frames: int,
                 rng: np.random.Generator, device) -> dict:
    """Random prompts: ``tokens`` [B, prompt_len], and a vlm's
    ``patch_embeds`` [B, Np, d] or an encdec's ``frames`` [B, frames, d]
    (bf16, standard normal)."""
    out = {"tokens": torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (batch, prompt_len)).astype(np.int64))}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(rng.normal(size=(
            batch, cfg.num_prefix_embeds, cfg.d_model))).to(torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.normal(size=(
            batch, frames, cfg.d_model))).to(torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}


def run(argv: Optional[Sequence[str]] = None):
    """Parse ``argv``, prefill and decode.  Returns (report, model,
    prompt): the report has ``init_s`` (the random weights), ``prefill_s``
    (the first prefill, cold, and a second one, warm),
    ``decode_ms_per_token`` and the greedy tokens; the prompt is
    :func:`prompt_batch`'s.  On a mesh the model returned is the sharded
    serving parameters."""
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = resolve_device(args.device)
    mesh = mesh_from_args(args)
    small = mesh is not None and args.batch < shd.axes_size(
        mesh, shd.data_axes(mesh))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    model = api.init_params(cfg, 0, dev)
    max_len = args.prompt_len + cfg.num_prefix_embeds + args.gen + 4
    prefill = make_prefill_step(cfg, max_len, mesh=mesh, small_batch=small)
    decode = make_serve_step(cfg, mesh=mesh, small_batch=small)
    if mesh is not None:
        model = api.shard_params(model, cfg, prefill.ctx,
                                 dtype=torch.bfloat16)
    _sync(dev)
    init_s = time.perf_counter() - t0
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.frames, rng,
                         dev)

    prefill_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch)
        _sync(dev)
        prefill_s.append(time.perf_counter() - t0)

    def greedy(logits):
        if isinstance(logits, shd.Sharded):
            logits = shd.unshard(logits)
        return torch.argmax(logits, dim=-1)[:, None]

    out = []
    cur = greedy(logits)
    t0 = time.perf_counter()
    for _ in range(args.gen):
        logits, cache = decode(model, cache, cur)
        cur = greedy(logits)
        out.append(cur)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu().numpy()
    report = {
        "arch": cfg.name, "batch": args.batch, "prompt_len": args.prompt_len,
        "gen": args.gen, "init_s": init_s, "prefill_s": prefill_s,
        "decode_ms_per_token": t_dec / args.gen * 1e3,
        "decode_tokens_per_s": args.batch * args.gen / t_dec,
        "sample": gen[0][:12].tolist(), "finite": bool(all(
            torch.isfinite(t.float()).all() for t in (
                logits.parts.values() if mesh is not None else [logits]))),
        "mesh": None if mesh is None else mesh.shape, "small_batch": small}
    return report, model, batch


def main(argv: Optional[Sequence[str]] = None) -> int:
    rep, _, _ = run(argv)
    cold, warm = rep["prefill_s"]
    print(f"prefill {rep['batch']}x{rep['prompt_len']}: {warm*1e3:.1f} ms "
          f"(cold {cold*1e3:.1f})")
    print(f"decode {rep['gen']} steps: {rep['decode_ms_per_token']:.1f} "
          f"ms/step ({rep['decode_tokens_per_s']:.1f} tok/s)")
    print("sample:", rep["sample"])
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
