"""AdamW + global-norm clip, the JAX package's ``train/optim.py``.

fp32 master params + fp32 moments; the model casts to bf16 for compute.
Trees are dicts of parameter name -> tensor.  Weight decay applies to
every leaf, and the clip comes before the moments, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 (``step``: an integer tensor)."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Tree) -> Dict:
    """Zero moments and ``step`` 0 (an int32 scalar on the params' device)."""
    dev = next(iter(params.values())).device
    return {"mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm over every leaf (f32 leaves)."""
    return torch.stack(torch._foreach_norm(list(tree.values()))) \
        .square().sum().sqrt()


@torch.no_grad()
def update(grads: Tree, state: Dict, params: Tree, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics).  ``step`` counts from 1
    inside.  Every tree holds f32 tensors (the master weights and their
    gradients)."""
    names = list(params)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    g = torch._foreach_mul([grads[n] for n in names], scale)
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    p = [params[n] for n in names]
    m = [state["mu"][n] for n in names]
    v = [state["nu"][n] for n in names]

    m2 = torch._foreach_add(torch._foreach_mul(m, cfg.b1),
                            torch._foreach_mul(g, 1 - cfg.b1))
    v2 = torch._foreach_add(torch._foreach_mul(v, cfg.b2),
                            torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - cfg.b2))
    mh = torch._foreach_div(m2, b1c)
    vh = torch._foreach_div(v2, b2c)
    delta = torch._foreach_add(
        torch._foreach_div(mh, torch._foreach_add(torch._foreach_sqrt(vh),
                                                  cfg.eps)),
        torch._foreach_mul(p, cfg.weight_decay))
    new_p = torch._foreach_sub(p, torch._foreach_mul(delta, lr))
    new_state = {"mu": dict(zip(names, m2)), "nu": dict(zip(names, v2)),
                 "step": step}
    return dict(zip(names, new_p)), new_state, {"grad_norm": gnorm, "lr": lr}
