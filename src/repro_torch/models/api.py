"""Family-dispatch model API, the JAX package's ``models/api.py``: one
surface for the launchers, the trainer and the server, for every family
(dense, moe, vlm, ssm, hybrid, encdec).

  init_params / param_specs / shard_params / loss_fn / prefill_fn /
  decode_fn / init_cache / cache_specs / batch_specs, and the dry run's
  shape-only stand-ins param_struct / batch_struct / cache_struct

Parameters are a :class:`~repro_torch.models.transformer.Transformer`
module, or an :class:`~repro_torch.models.encdec.EncDec` for the encdec
family (the reference's are a pytree: ``repro_torch.convert`` maps one
to the other).  ``device=None`` means ``"cuda"`` and raises without a
card; the CPU runs only when the caller asks for it.

Batches: ``tokens`` and ``labels`` [B, T]; a vlm batch adds
``patch_embeds`` [B, Np, d] and ``mask`` [B, Np + T] (labels cover the
prefix too, masked out), an encdec batch ``frames`` [B, S, d].

On a mesh (``ctx=ShardCtx(mesh, rules)``, every family) the parameters
are :func:`shard_params`'s dict of
:class:`~repro_torch.sharding.Sharded`, a batch's tensors are global
(each is laid out by :func:`batch_specs`) or already laid out so, and
the logits come back sharded ``("batch", "vocab")``.
"""
from __future__ import annotations

import functools
import logging
from typing import Dict, Optional, Union

import torch
from torch import nn

from .. import sharding as shd
from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from . import encdec as ed
from . import transformer as tf
from .common import NO_SHARD, ShardCtx
from .losses import softmax_xent, softmax_xent_sharded

log = logging.getLogger(__name__)

MOE_AUX_WEIGHT = 0.01

Model = Union[tf.Transformer, ed.EncDec]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> nn.Module:
    """A randomly initialised model of any family, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ed.EncDec(cfg, seed=seed, device=dev)
    return tf.Transformer(cfg, seed=seed, device=dev)


def param_specs(cfg: ModelConfig, rules) -> Dict[str, shd.Spec]:
    """Specs keyed by parameter name."""
    if cfg.family == "encdec":
        return ed.param_specs(cfg, rules)
    return tf.param_specs(cfg, rules)


def cache_specs(cfg: ModelConfig, rules):
    if cfg.family == "encdec":
        return ed.cache_specs(cfg, rules)
    return tf.cache_specs(cfg, rules)


def batch_specs(cfg: ModelConfig, rules):
    s = functools.partial(shd.spec, rules)
    if cfg.family == "encdec":
        return {"frames": s("batch", None, None), "tokens": s("batch", None),
                "labels": s("batch", None)}
    if cfg.family == "vlm":
        return {"patch_embeds": s("batch", None, None),
                "tokens": s("batch", None), "labels": s("batch", None),
                "mask": s("batch", None)}
    return {"tokens": s("batch", None), "labels": s("batch", None)}


# -- shape-only stand-ins (the dry run's, on the meta device) ------------------

def param_struct(cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Every parameter as a meta tensor, keyed by name: the reference's
    ``jax.eval_shape(init_params)``, f32 (or ``dtype``: serving casts
    to bf16), nothing drawn and nothing allocated."""
    model = init_params(cfg, 0, "meta")
    return {n: (t.detach() if dtype is None else t.detach().to(dtype))
            for n, t in model.named_parameters()}


def batch_struct(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    """Meta tensors of one training or prefill batch of ``shape`` (a
    ``configs.ShapeSpec``): the reference's ``batch_struct``, its shapes
    and dtypes (a vlm's text fills what the patches leave of the
    sequence, at least one token)."""
    B, T, d = shape.global_batch, shape.seq_len, cfg.d_model

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.family == "encdec":
        return {"frames": meta((B, T, d), torch.bfloat16),
                "tokens": meta((B, T)), "labels": meta((B, T))}
    if cfg.family == "vlm":
        Np = cfg.num_prefix_embeds
        Tt = max(1, T - Np)
        return {"patch_embeds": meta((B, Np, d), torch.bfloat16),
                "tokens": meta((B, Tt)), "labels": meta((B, Np + Tt)),
                "mask": meta((B, Np + Tt))}
    return {"tokens": meta((B, T)), "labels": meta((B, T))}


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int = 1024):
    """The decode cache of :func:`init_cache` as meta tensors (``len`` a
    host int, 0): no allocation."""
    return init_cache(cfg, batch, max_len, "meta", enc_len=enc_len)


_LOGGED = set()


def shard_params(model, cfg: ModelConfig, ctx: ShardCtx,
                 dtype: Optional[torch.dtype] = None,
                 requires_grad: bool = False) -> Dict[str, shd.Sharded]:
    """``model``'s parameters (a module, or a dict of name -> tensor)
    laid out on ``ctx.mesh`` by :func:`param_specs`, sanitized: a dim
    whose axes do not divide it is replicated (logged once a config and
    mesh).  Each coordinate receives a copy of its slice only, in
    ``dtype`` if given (serving: bf16)."""
    flat = dict(model.named_parameters()) if isinstance(model, nn.Module) \
        else model
    specs = param_specs(cfg, ctx.rules)
    out = {}
    for name, t in flat.items():
        sp = shd.sanitize_spec(specs[name], t.shape, ctx.mesh)
        out[name] = shd.shard(t.detach(), ctx.mesh, sp, dtype)
        if requires_grad:
            for part in out[name].parts.values():
                part.requires_grad_(True)
    key = (cfg.name, tuple(ctx.mesh.shape.items()))
    if key not in _LOGGED:
        _LOGGED.add(key)
        dropped = replicated_dims(cfg, ctx, {n: t.shape
                                             for n, t in flat.items()})
        if dropped:
            log.info("%s on mesh %s: replicated dims (name, dim, size, "
                     "axes) %s", cfg.name, ctx.mesh.shape, dropped)
    return out


def replicated_dims(cfg: ModelConfig, ctx: ShardCtx, shapes) -> list:
    """(name, dim, size, axes) of each parameter dim the rules split but
    the mesh's axes do not divide (replicated instead); ``shapes``: name
    -> shape."""
    specs = param_specs(cfg, ctx.rules)
    return [(n, i, shp[i], specs[n][i]) for n, shp in shapes.items()
            for i in shd.replicated_dims(specs[n], shp, ctx.mesh)]


def loss_fn(model: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: ShardCtx = NO_SHARD):
    """Returns (loss, metrics); a moe loss adds ``MOE_AUX_WEIGHT`` times
    the load-balance loss, reported as ``moe_aux``.  On a mesh the loss
    is the vocab-parallel cross-entropy over every coordinate's rows."""
    aux = None
    if cfg.family == "encdec":
        enc_out = ed.encode(model, batch["frames"], cfg, ctx)
        logits, _ = ed.decode(model, batch["tokens"], enc_out, cfg, ctx=ctx)
    else:
        logits, _, aux = tf.forward(model, cfg, batch["tokens"],
                                    prefix_embeds=batch.get("patch_embeds"),
                                    ctx=ctx)
    mask = batch.get("mask") if cfg.family == "vlm" else None
    if ctx.mesh is None:
        loss, n = softmax_xent(logits, batch["labels"], mask)
    else:
        args = [ctx.local(batch["labels"], "batch", None)]
        if mask is not None:
            args.append(ctx.local(mask, "batch", None))
        loss, n = softmax_xent_sharded(logits, *args)
    if cfg.family != "moe":
        return loss, {"xent": loss.detach(), "tokens": n}
    return loss + MOE_AUX_WEIGHT * aux, {"xent": loss.detach(), "tokens": n,
                                         "moe_aux": aux.detach()}


def _last(logits):
    if not isinstance(logits, shd.Sharded):
        return logits[:, -1]
    return shd.Sharded({c: t[:, -1] for c, t in logits.parts.items()},
                       (logits.shape[0], logits.shape[2]),
                       (logits.spec[0], logits.spec[2]), logits.mesh)


def _device(ctx: ShardCtx, t):
    if ctx.mesh is None:
        return t.device
    return shd.device(ctx.mesh, shd.coords(ctx.mesh)[0])


@torch.no_grad()
def prefill_fn(model: Model, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, max_len: int, ctx: ShardCtx = NO_SHARD):
    """Run the full prompt (and a vlm's patches, an encdec's frames),
    build the decode cache.  Returns (logits_last, cache); on a mesh the
    cache rests as :func:`cache_specs` lays it out."""
    tokens = batch.get("tokens")
    if cfg.family == "encdec":
        frames = batch["frames"]
        enc_out = ed.encode(model, frames, cfg, ctx)
        cache = ed.init_cache(cfg, tokens.shape[0], max_len, frames.shape[1],
                              _device(ctx, tokens), ctx=ctx)
        cache["enc_kv"] = ed.enc_kv(model, enc_out, cfg, ctx)
        logits, cache = ed.decode(model, tokens, None, cfg, cache=cache,
                                  ctx=ctx)
        return _last(logits), cache
    first = tokens if tokens is not None else batch["patch_embeds"]
    cache = tf.init_cache(cfg, first.shape[0], max_len, _device(ctx, first),
                          ctx=ctx)
    logits, cache, _ = tf.forward(model, cfg, tokens, cache=cache,
                                  prefix_embeds=batch.get("patch_embeds"),
                                  ctx=ctx)
    return _last(logits), cache


@torch.no_grad()
def decode_fn(model: Model, cache, tokens: torch.Tensor, cfg: ModelConfig,
              ctx: ShardCtx = NO_SHARD):
    """One decode step: tokens [B, 1].  Returns (logits [B, V], cache)."""
    if cfg.family == "encdec":
        logits, cache = ed.decode(model, tokens, None, cfg, cache=cache,
                                  ctx=ctx)
    else:
        logits, cache, _ = tf.forward(model, cfg, tokens, cache=cache,
                                      ctx=ctx)
    return _last(logits), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               enc_len: int = 1024, ctx: ShardCtx = NO_SHARD):
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ed.init_cache(cfg, batch, max_len, enc_len, dev, ctx=ctx)
    return tf.init_cache(cfg, batch, max_len, dev, ctx=ctx)
