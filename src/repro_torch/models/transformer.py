"""Decoder-only LM, the dense family of the JAX package's
``models/transformer.py`` (GQA attention + SwiGLU: smollm, llama3.2,
qwen3, yi).  The moe, ssm, hybrid and vlm branches are not ported yet
(ROADMAP queue 1).

The reference stacks its layers on a leading L axis and runs them with
``lax.scan`` under ``jax.checkpoint(nothing_saveable)``; here the layers
are an ``nn.ModuleList`` run in a loop, each under
``torch.utils.checkpoint`` (``use_reentrant=False``) when ``cfg.remat``
is set and gradients are on, so the residual stream between layers is
the only saved activation.  ``repro_torch.convert`` maps the module's
parameters to and from the reference's stacked tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import init_dense, rms_norm, rope_tables
from .layers import attention_block, mlp_block


PORTED_FAMILIES = ("dense",)


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet: see ROADMAP queue 1 (ported: "
            f"{', '.join(PORTED_FAMILIES)})")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
class Attention(nn.Module):
    """``wq [d,H,Dh]``, ``wk``/``wv [d,K,Dh]``, ``wo [H,Dh,d]`` (+ qk
    norms), f32 master weights."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        d, H, K, Dh = (cfg.d_model, cfg.eff_num_heads, cfg.eff_num_kv_heads,
                       cfg.head_dim)
        def dense(shape, fan_in):
            return nn.Parameter(init_dense(gen, shape, fan_in, device))

        self.wq = dense((d, H, Dh), d)
        self.wk = dense((d, K, Dh), d)
        self.wv = dense((d, K, Dh), d)
        self.wo = dense((H, Dh, d), H * Dh)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(Dh, device=device))
            self.k_norm = nn.Parameter(torch.zeros(Dh, device=device))


class MLP(nn.Module):
    """SwiGLU: ``wg``/``wu [d,f]``, ``wd [f,d]``."""

    def __init__(self, d: int, f: int, gen: torch.Generator, device):
        super().__init__()
        self.wg = nn.Parameter(init_dense(gen, (d, f), d, device))
        self.wu = nn.Parameter(init_dense(gen, (d, f), d, device))
        self.wd = nn.Parameter(init_dense(gen, (f, d), f, device))


class Layer(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.attn = Attention(cfg, gen, device)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, device)

    def bf16_weights(self) -> Dict[str, Any]:
        """Every weight of the layer in bf16, as the reference casts the
        stacked layers before its scan."""
        bf = torch.bfloat16
        return {"ln1": self.ln1.to(bf), "ln2": self.ln2.to(bf),
                "attn": {n: t.to(bf) for n, t in
                         self.attn.named_parameters()},
                "mlp": {n: t.to(bf) for n, t in self.mlp.named_parameters()}}


class Transformer(nn.Module):
    """The dense decoder: ``embed [Vp, d]``, ``layers``, ``final_norm``
    and, untied, ``lm_head [d, Vp]``."""

    def __init__(self, cfg, seed: int = 0, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.embed = nn.Parameter(init_dense(
            gen, (cfg.vocab_padded, cfg.d_model), cfg.d_model, device))
        self.layers = nn.ModuleList(
            [Layer(cfg, gen, device) for _ in range(cfg.num_layers)])
        self.final_norm = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(init_dense(
                gen, (cfg.d_model, cfg.vocab_padded), fan_in=cfg.d_model,
                device=device))

    def forward(self, tokens: torch.Tensor, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None):
        return forward(self, self.cfg, tokens, cache=cache,
                       positions=positions)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _attn_layer(lw, x, cfg, rope, cache, prefix_len):
    h, new_cache = attention_block(
        lw["attn"], rms_norm(x, lw["ln1"], cfg.norm_eps), cfg, rope,
        cache=cache, prefix_len=prefix_len)
    x = x + h
    h = mlp_block(lw["mlp"], rms_norm(x, lw["ln2"], cfg.norm_eps))
    return x + h, new_cache


def _remat_layer(lw, x, cfg, rope, prefix_len):
    return _attn_layer(lw, x, cfg, rope, None, prefix_len)[0]


def forward(model: Transformer, cfg, tokens: torch.Tensor,
            cache: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None):
    """Returns (logits [B, T, V] bf16, new_cache, aux_loss).

    ``cache`` (decode): see :func:`init_cache`; its KV tensors are written
    in place and its ``len`` advanced.
    """
    bf = torch.bfloat16
    x = F.embedding(tokens, model.embed.to(bf))
    if cfg.tie_embeddings:
        # the reference multiplies by ``np.sqrt(d_model)``, a float64 numpy
        # scalar, which JAX promotes (as float32) over bf16: the residual
        # stream of a tied model is f32
        x = x.float() * float(np.float32(np.sqrt(cfg.d_model)))
    B, T, _ = x.shape

    # compute weights in bf16 before the layer loop, as the reference
    weights = [layer.bf16_weights() for layer in model.layers]

    start = int(cache["len"]) if cache is not None else 0
    if positions is None:
        positions = (start + torch.arange(T, device=tokens.device))[None, :] \
            .expand(B, T)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, bf)
    prefix_len = cfg.num_prefix_embeds if cfg.prefix_lm else 0
    remat = cfg.remat and cache is None and torch.is_grad_enabled()

    new_cache = dict(cache) if cache is not None else None
    for i, lw in enumerate(weights):
        if remat:
            x = checkpoint(_remat_layer, lw, x, cfg, rope, prefix_len,
                           use_reentrant=False, preserve_rng_state=False,
                           determinism_check="none")
            continue
        cl = None if cache is None else {
            "k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i],
            "len": start}
        x, _ = _attn_layer(lw, x, cfg, rope, cl, prefix_len)

    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    logits = torch.matmul(x.to(bf), head.to(bf))
    if cache is not None:
        new_cache["len"] = start + T
    return logits, new_cache, 0.0


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device=None) -> Dict[str, Any]:
    """Decode cache: KV stacked over layers, ``[L, B, max_len, K, Dh]``
    bf16, and the filled length ``len`` (a host int: the reference also
    keeps a per-layer copy for its scan, which a loop does not need)."""
    check_family(cfg)
    K, Dh, L = cfg.eff_num_kv_heads, cfg.head_dim, cfg.num_layers
    shape = (L, batch, max_len, K, Dh)
    return {"len": 0, "kv": {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}}
