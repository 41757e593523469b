"""AdamW + global-norm clip, the JAX package's ``train/optim.py``.

fp32 master params + fp32 moments; the model casts to bf16 for compute.
Trees are dicts of parameter name -> tensor, or (on a mesh) -> a
:class:`~repro_torch.sharding.Sharded` whose parts update elementwise,
each on its device.  Weight decay applies to every leaf, and the clip
comes before the moments, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Union

import torch

from ..sharding import Sharded

Tree = Dict[str, Union[torch.Tensor, Sharded]]


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


def _zeros(p):
    if isinstance(p, Sharded):
        return p.map(torch.zeros_like)
    return torch.zeros_like(p)


def _first(tree: Tree) -> torch.Tensor:
    p = next(iter(tree.values()))
    return next(iter(p.parts.values())) if isinstance(p, Sharded) else p


def init(params: Tree) -> Dict:
    """Zero moments and ``step`` 0 (an int32 scalar on the params' (first
    coordinate's) device)."""
    dev = _first(params).device
    return {"mu": {n: _zeros(p) for n, p in params.items()},
            "nu": {n: _zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def local_parts(tree: Tree) -> Dict:
    """Every local tensor: name -> tensor, and (name, coordinate) -> part
    for a sharded leaf."""
    out = {}
    for n, v in tree.items():
        if isinstance(v, Sharded):
            out.update({(n, c): t for c, t in v.parts.items()})
        else:
            out[n] = v
    return out


def _rebuild(like: Tree, flat: Dict) -> Tree:
    return {n: (Sharded({c: flat[(n, c)] for c in v.parts}, v.shape, v.spec,
                        v.mesh) if isinstance(v, Sharded) else flat[n])
            for n, v in like.items()}


def _by_device(keys, flat: Dict) -> Dict[torch.device, list]:
    out: Dict[torch.device, list] = {}
    for k in keys:
        out.setdefault(flat[k].device, []).append(k)
    return out


def global_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm over every leaf (f32 leaves), each element counted
    once: a sharded leaf contributes one part of each slice (its
    replicas are equal)."""
    leaves = []
    for v in tree.values():
        leaves += v.unique_parts() if isinstance(v, Sharded) else [v]
    dev = leaves[0].device
    groups: Dict[torch.device, list] = {}
    for t in leaves:
        groups.setdefault(t.device, []).append(t)
    sq = [torch.stack(torch._foreach_norm(ts)).square().sum().to(dev)
          for ts in groups.values()]
    return torch.stack(sq).sum().sqrt() if len(sq) > 1 else sq[0].sqrt()


@torch.no_grad()
def update(grads: Tree, state: Dict, params: Tree, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics).  ``step`` counts from 1
    inside.  Every tree holds f32 tensors (the master weights and their
    gradients), or sharded ones alike: the update runs on each part,
    the scalars copied to its device."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    fp, fg = local_parts(params), local_parts(grads)
    fm, fv = local_parts(state["mu"]), local_parts(state["nu"])
    out_p, out_m, out_v = {}, {}, {}
    for dev, keys in _by_device(list(fp), fp).items():
        sc, lr_d, b1d, b2d = (t.to(dev) for t in (scale, lr, b1c, b2c))
        g = torch._foreach_mul([fg[k] for k in keys], sc)
        p = [fp[k] for k in keys]
        m = [fm[k] for k in keys]
        v = [fv[k] for k in keys]
        m2 = torch._foreach_add(torch._foreach_mul(m, cfg.b1),
                                torch._foreach_mul(g, 1 - cfg.b1))
        v2 = torch._foreach_add(torch._foreach_mul(v, cfg.b2),
                                torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - cfg.b2))
        mh = torch._foreach_div(m2, b1d)
        vh = torch._foreach_div(v2, b2d)
        delta = torch._foreach_add(
            torch._foreach_div(mh, torch._foreach_add(
                torch._foreach_sqrt(vh), cfg.eps)),
            torch._foreach_mul(p, cfg.weight_decay))
        new_p = torch._foreach_sub(p, torch._foreach_mul(delta, lr_d))
        out_p.update(zip(keys, new_p))
        out_m.update(zip(keys, m2))
        out_v.update(zip(keys, v2))
    new_state = {"mu": _rebuild(state["mu"], out_m),
                 "nu": _rebuild(state["nu"], out_v), "step": step}
    return _rebuild(params, out_p), new_state, {"grad_norm": gnorm,
                                                 "lr": lr}
