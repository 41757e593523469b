"""Train / serve steps, the JAX package's ``train/step.py`` on one device.

The state is ``{"params": model, "opt": {"mu", "nu", "step"}}``: the
model (``api.init_params``'s, any family) has its parameters replaced
in place by a train step, the moments are dicts of
parameter name -> f32 tensor, and ``step`` an int32 scalar.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import api
from . import optim


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        loss, metrics = api.loss_fn(model, batch, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        new_params, new_opt, om = optim.update(
            dict(zip(params, grads)), state["opt"], params, opt_cfg)
        with torch.no_grad():
            torch._foreach_copy_(list(params.values()),
                                 [new_params[n] for n in params])
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss.detach()
        return {"params": model, "opt": new_opt}, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """Returns decode_step(model, cache, tokens) -> (logits, cache)."""

    def serve_step(model, cache, tokens):
        return api.decode_fn(model, cache, tokens, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """Returns prefill(model, batch) -> (logits_last, cache)."""

    def prefill(model, batch):
        return api.prefill_fn(model, batch, cfg, max_len)

    return prefill


def init_state(cfg: ModelConfig, seed: int = 0, device=None):
    model = api.init_params(cfg, seed, device)
    return {"params": model,
            "opt": optim.init(dict(model.named_parameters()))}
