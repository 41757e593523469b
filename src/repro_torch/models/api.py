"""Family-dispatch model API, the JAX package's ``models/api.py``: one
surface for the launchers, the trainer and the server, for every family
(dense, moe, vlm, ssm, hybrid, encdec).

  init_params / loss_fn / prefill_fn / decode_fn / init_cache

Parameters are a :class:`~repro_torch.models.transformer.Transformer`
module, or an :class:`~repro_torch.models.encdec.EncDec` for the encdec
family (the reference's are a pytree: ``repro_torch.convert`` maps one
to the other).  ``device=None`` means ``"cuda"`` and raises without a
card; the CPU runs only when the caller asks for it.

Batches: ``tokens`` and ``labels`` [B, T]; a vlm batch adds
``patch_embeds`` [B, Np, d] and ``mask`` [B, Np + T] (labels cover the
prefix too, masked out), an encdec batch ``frames`` [B, S, d].
"""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from . import encdec as ed
from . import transformer as tf
from .losses import softmax_xent

MOE_AUX_WEIGHT = 0.01

Model = Union[tf.Transformer, ed.EncDec]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> nn.Module:
    """A randomly initialised model of any family, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ed.EncDec(cfg, seed=seed, device=dev)
    return tf.Transformer(cfg, seed=seed, device=dev)


def loss_fn(model: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Returns (loss, metrics); a moe loss adds ``MOE_AUX_WEIGHT`` times
    the load-balance loss, reported as ``moe_aux``."""
    if cfg.family == "encdec":
        enc_out = ed.encode(model, batch["frames"], cfg)
        logits, _ = ed.decode(model, batch["tokens"], enc_out, cfg)
        loss, n = softmax_xent(logits, batch["labels"])
        return loss, {"xent": loss.detach(), "tokens": n}
    if cfg.family == "vlm":
        logits, _, _ = tf.forward(model, cfg, batch["tokens"],
                                  prefix_embeds=batch["patch_embeds"])
        loss, n = softmax_xent(logits, batch["labels"], batch["mask"])
        return loss, {"xent": loss.detach(), "tokens": n}
    logits, _, aux = tf.forward(model, cfg, batch["tokens"])
    loss, n = softmax_xent(logits, batch["labels"])
    if cfg.family != "moe":
        return loss, {"xent": loss.detach(), "tokens": n}
    return loss + MOE_AUX_WEIGHT * aux, {"xent": loss.detach(), "tokens": n,
                                         "moe_aux": aux.detach()}


@torch.no_grad()
def prefill_fn(model: Model, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, max_len: int):
    """Run the full prompt (and a vlm's patches, an encdec's frames),
    build the decode cache.  Returns (logits_last, cache)."""
    tokens = batch.get("tokens")
    if cfg.family == "encdec":
        enc_out = ed.encode(model, batch["frames"], cfg)
        cache = ed.init_cache(cfg, tokens.shape[0], max_len,
                              enc_out.shape[1], tokens.device)
        cache["enc_kv"] = ed.enc_kv(model, enc_out, cfg)
        logits, cache = ed.decode(model, tokens, None, cfg, cache=cache)
        return logits[:, -1], cache
    first = tokens if tokens is not None else batch["patch_embeds"]
    cache = tf.init_cache(cfg, first.shape[0], max_len, first.device)
    logits, cache, _ = tf.forward(model, cfg, tokens, cache=cache,
                                  prefix_embeds=batch.get("patch_embeds"))
    return logits[:, -1], cache


@torch.no_grad()
def decode_fn(model: Model, cache, tokens: torch.Tensor, cfg: ModelConfig):
    """One decode step: tokens [B, 1].  Returns (logits [B, V], cache)."""
    if cfg.family == "encdec":
        logits, cache = ed.decode(model, tokens, None, cfg, cache=cache)
    else:
        logits, cache, _ = tf.forward(model, cfg, tokens, cache=cache)
    return logits[:, -1], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               enc_len: int = 1024):
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ed.init_cache(cfg, batch, max_len, enc_len, dev)
    return tf.init_cache(cfg, batch, max_len, dev)
