"""Family-dispatch model API, the dense family of the JAX package's
``models/api.py``: one surface for the launchers, the trainer and the
server.

  init_params / loss_fn / prefill_fn / decode_fn / init_cache

Parameters are a :class:`~repro_torch.models.transformer.Transformer`
module (the reference's are a pytree: ``repro_torch.convert`` maps one
to the other).  ``device=None`` means ``"cuda"`` and raises without a
card; the CPU runs only when the caller asks for it.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from . import transformer as tf
from .losses import softmax_xent


def init_params(cfg: ModelConfig, seed: int = 0,
                device=None) -> tf.Transformer:
    """A randomly initialised model, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``.  A family other than ``dense``
    raises ``NotImplementedError``."""
    return tf.Transformer(cfg, seed=seed, device=resolve_device(device))


def loss_fn(model: tf.Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig):
    """Returns (loss, metrics)."""
    logits, _, _ = tf.forward(model, cfg, batch["tokens"])
    loss, n = softmax_xent(logits, batch["labels"])
    return loss, {"xent": loss.detach(), "tokens": n}


@torch.no_grad()
def prefill_fn(model: tf.Transformer, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, max_len: int):
    """Run the full prompt, build the decode cache.  Returns (logits_last,
    cache)."""
    tokens = batch["tokens"]
    cache = tf.init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    logits, cache, _ = tf.forward(model, cfg, tokens, cache=cache)
    return logits[:, -1], cache


@torch.no_grad()
def decode_fn(model: tf.Transformer, cache, tokens: torch.Tensor,
              cfg: ModelConfig):
    """One decode step: tokens [B, 1].  Returns (logits [B, V], cache)."""
    logits, cache, _ = tf.forward(model, cfg, tokens, cache=cache)
    return logits[:, -1], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return tf.init_cache(cfg, batch, max_len, resolve_device(device))
