"""Train / serve steps, the JAX package's ``train/step.py``: on one device,
or on a mesh (``mesh=``) by the logical rules.

The state is ``{"params": model, "opt": {"mu", "nu", "step"}}``: the
model (``api.init_params``'s, any family) has its parameters replaced
in place by a train step, the moments are dicts of
parameter name -> f32 tensor, and ``step`` an int32 scalar.  On a mesh
(every family) the params are ``api.shard_params``'s dict of
:class:`~repro_torch.sharding.Sharded` f32 parts (leaves of autograd)
and the moments are sharded alike.
"""
from __future__ import annotations

import torch

from .. import sharding as shd
from ..configs.base import ModelConfig
from ..models import api
from ..models.common import NO_SHARD, ShardCtx
from . import optim


def _ctx(cfg, mesh, small_batch=False, serving=False) -> ShardCtx:
    if mesh is None:
        return NO_SHARD
    return ShardCtx(mesh, shd.make_rules(mesh, cfg, small_batch, serving))


def mesh_grads(params, loss: torch.Tensor):
    """The gradient of ``loss`` for every sharded leaf: autograd gives
    each part its own coordinate's share (the all-gathers' transposes
    reduce-scatter fsdp shards), and the shares of parts that hold the
    same slice are all-reduced over the leaf's replica axes, so every
    replica receives the whole gradient."""
    leaves = [(n, c, t) for n, sh in params.items()
              for c, t in sh.parts.items()]
    got = torch.autograd.grad(loss, [t for _, _, t in leaves],
                              allow_unused=True)
    grads = {n: {} for n in params}
    for (n, c, t), g in zip(leaves, got):
        grads[n][c] = torch.zeros_like(t) if g is None else g
    return {n: shd.Sharded(shd.all_reduce(g, sh.mesh, sh.replica_axes()),
                           sh.shape, sh.spec, sh.mesh)
            for (n, sh), g in zip(params.items(), grads.values())}


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                    mesh=None, small_batch: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).  With a mesh,
    the state is :func:`init_state`'s on that mesh and a batch holds
    global tensors (or tensors laid out by ``api.batch_specs``)."""
    ctx = _ctx(cfg, mesh, small_batch)

    def train_step(state, batch):
        model = state["params"]
        loss, metrics = api.loss_fn(model, batch, cfg, ctx)
        if ctx.mesh is not None:
            params, grads = model, mesh_grads(model, loss)
        else:
            params = dict(model.named_parameters())
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        new_params, new_opt, om = optim.update(grads, state["opt"], params,
                                               opt_cfg)
        with torch.no_grad():
            old = optim.local_parts(params)
            new = optim.local_parts(new_params)
            torch._foreach_copy_(list(old.values()),
                                 [new[k] for k in old])
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss.detach()
        return {"params": model, "opt": new_opt}, metrics

    train_step.ctx = ctx
    return train_step


def make_serve_step(cfg: ModelConfig, mesh=None, small_batch: bool = False,
                    serving: bool = True):
    """Returns decode_step(model, cache, tokens) -> (logits, cache)."""
    ctx = _ctx(cfg, mesh, small_batch, serving)

    def serve_step(model, cache, tokens):
        return api.decode_fn(model, cache, tokens, cfg, ctx)

    serve_step.ctx = ctx
    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int, mesh=None,
                      small_batch: bool = False, serving: bool = True):
    """Returns prefill(model, batch) -> (logits_last, cache)."""
    ctx = _ctx(cfg, mesh, small_batch, serving)

    def prefill(model, batch):
        return api.prefill_fn(model, batch, cfg, max_len, ctx)

    prefill.ctx = ctx
    return prefill


def init_state(cfg: ModelConfig, seed: int = 0, device=None, mesh=None):
    """A fresh trainer state.  On a mesh, the model is drawn on the mesh's
    first device (the same weights as a one-device run of ``seed``),
    then laid out by the training rules and freed."""
    if mesh is None:
        model = api.init_params(cfg, seed, device)
        return {"params": model,
                "opt": optim.init(dict(model.named_parameters()))}
    model = api.init_params(cfg, seed, shd.device(mesh, shd.coords(mesh)[0]))
    params = api.shard_params(model, cfg, _ctx(cfg, mesh),
                              requires_grad=True)
    del model
    return {"params": params, "opt": optim.init(params)}


def state_struct(cfg: ModelConfig):
    """The trainer state as meta tensors (``init_state``'s shapes and
    dtypes, the reference's ``jax.eval_shape(init_state)``): f32 params
    and moments keyed by name, ``step`` an int32 scalar."""
    params = api.param_struct(cfg)
    return {"params": params, "opt": optim.init(params)}


def state_specs(cfg: ModelConfig, rules):
    ps = api.param_specs(cfg, rules)
    return {"params": ps, "opt": {"mu": ps, "nu": ps,
                                  "step": shd.spec(rules)}}

