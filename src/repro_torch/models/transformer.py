"""Decoder-only LM, the JAX package's ``models/transformer.py``: the
dense, moe, vlm, ssm and hybrid families.

  dense  — GQA attention + SwiGLU           (yi-34b, qwen3, llama3.2, smollm)
  moe    — GQA attention + shared/routed MoE (qwen2-moe, olmoe)
  ssm    — Mamba2 (SSD) blocks, attention-free          (mamba2-2.7b)
  hybrid — Mamba2 backbone + one *shared* attention+MLP block applied
           after every ``attn_period`` layers (zamba2-style weight sharing)
  vlm    — dense backbone + precomputed patch-embedding prefix with
           prefix-LM (bidirectional prefix) masking       (paligemma)

The reference stacks its layers on a leading L axis and runs them with
``lax.scan`` under ``jax.checkpoint(nothing_saveable)``; here the layers
are an ``nn.ModuleList`` run in a loop, each under
``torch.utils.checkpoint`` (``use_reentrant=False``) when ``cfg.remat``
is set and gradients are on, so the residual stream between layers is
the only saved activation (the hybrid's shared block is not rematted,
as in the reference).  ``repro_torch.convert`` maps the module's
parameters to and from the reference's stacked tree.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import init_dense, rms_norm, rope_tables
from .layers import (attention_block, mlp_block, moe_block,
                     moe_block_dropless)
from .ssm import Mamba, init_mamba_state, mamba_block


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
class Attention(nn.Module):
    """``wq [d,H,Dh]``, ``wk``/``wv [d,K,Dh]``, ``wo [H,Dh,d]`` (+ qk
    norms when ``qk_norm``), f32 master weights."""

    def __init__(self, cfg, gen: torch.Generator, device,
                 qk_norm: Optional[bool] = None):
        super().__init__()
        d, H, K, Dh = (cfg.d_model, cfg.eff_num_heads, cfg.eff_num_kv_heads,
                       cfg.head_dim)

        def dense(shape, fan_in):
            return nn.Parameter(init_dense(gen, shape, fan_in, device))

        self.wq = dense((d, H, Dh), d)
        self.wk = dense((d, K, Dh), d)
        self.wv = dense((d, K, Dh), d)
        self.wo = dense((H, Dh, d), H * Dh)
        if cfg.qk_norm if qk_norm is None else qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(Dh, device=device))
            self.k_norm = nn.Parameter(torch.zeros(Dh, device=device))


class MLP(nn.Module):
    """SwiGLU: ``wg``/``wu [d,f]``, ``wd [f,d]``."""

    def __init__(self, d: int, f: int, gen: torch.Generator, device):
        super().__init__()
        self.wg = nn.Parameter(init_dense(gen, (d, f), d, device))
        self.wu = nn.Parameter(init_dense(gen, (d, f), d, device))
        self.wd = nn.Parameter(init_dense(gen, (f, d), f, device))


class MoE(nn.Module):
    """``router [d,E]``, experts ``wg``/``wu [E,d,f]``, ``wd [E,f,d]``
    (E = ``eff_num_experts``), and ``shared``, an MLP of
    ``num_shared_experts * f``, when the config has shared experts."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.eff_num_experts
        self.router = nn.Parameter(init_dense(gen, (d, E), d, device))
        self.wg = nn.Parameter(init_dense(gen, (E, d, f), d, device))
        self.wu = nn.Parameter(init_dense(gen, (E, d, f), d, device))
        self.wd = nn.Parameter(init_dense(gen, (E, f, d), f, device))
        if cfg.num_shared_experts:
            self.shared = MLP(d, f * cfg.num_shared_experts, gen, device)


class Layer(nn.Module):
    """One layer of ``family`` (the config's by default): ``ln1`` and
    ``mamba`` (ssm, hybrid), or ``ln1``, ``attn``, ``ln2`` and ``moe``
    (moe) or ``mlp`` (dense, vlm, and the hybrid's shared block)."""

    def __init__(self, cfg, gen: torch.Generator, device,
                 family: Optional[str] = None):
        super().__init__()
        family = family or cfg.family
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        if family in ("ssm", "hybrid"):
            self.mamba = Mamba(cfg, gen, device)
            return
        self.attn = Attention(cfg, gen, device)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        if family == "moe":
            self.moe = MoE(cfg, gen, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, device)


def bf16_tree(module: nn.Module) -> Dict[str, Any]:
    """Every weight of ``module`` in bf16, nested by name (``attn.wq`` ->
    ``out["attn"]["wq"]``), as the reference casts the stacked layers
    before its scan."""
    out: Dict[str, Any] = {}
    for name, t in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.to(torch.bfloat16)
    return out


class Transformer(nn.Module):
    """The decoder: ``embed [Vp, d]``, ``layers``, ``final_norm``, untied
    ``lm_head [d, Vp]`` and, for the hybrid, ``shared_attn``."""

    def __init__(self, cfg, seed: int = 0, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                             "decoder-only family")
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
        if cfg.family == "hybrid" and cfg.attn_period:
            self.shared_attn = Layer(cfg, gen, device, family="dense")

    def forward(self, tokens: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None,
                prefix_embeds: Optional[torch.Tensor] = None):
        return forward(self, self.cfg, tokens, cache=cache,
                       positions=positions, prefix_embeds=prefix_embeds)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _attn_layer(lw, x, cfg, rope, cache, prefix_len):
    """Attention, then the MLP or (``lw`` has ``moe``) the MoE: grouped
    with capacity for training and prefill, dropless for one cached
    token.  Returns (x, new_cache, aux)."""
    h, new_cache = attention_block(
        lw["attn"], rms_norm(x, lw["ln1"], cfg.norm_eps), cfg, rope,
        cache=cache, prefix_len=prefix_len)
    x = x + h
    hn = rms_norm(x, lw["ln2"], cfg.norm_eps)
    if "moe" in lw:
        decode = cache is not None and x.shape[1] == 1
        moe_fn = moe_block_dropless if decode else moe_block
        h, aux = moe_fn(lw["moe"], hn, cfg)
    else:
        h, aux = mlp_block(lw["mlp"], hn), 0.0
    return x + h, new_cache, aux


def _remat_attn_layer(lw, x, cfg, rope, prefix_len):
    x, _, aux = _attn_layer(lw, x, cfg, rope, None, prefix_len)
    return x, aux


def _mamba_layer(lw, x, cfg, state):
    h, new_state = mamba_block(
        lw["mamba"], rms_norm(x, lw["ln1"], cfg.norm_eps), cfg, state)
    return x + h, new_state


def _remat_mamba_layer(lw, x, cfg):
    return _mamba_layer(lw, x, cfg, None)[0]


_remat = functools.partial(checkpoint, use_reentrant=False,
                           preserve_rng_state=False,
                           determinism_check="none")


def _run_mamba(lw, i, x, cfg, cache, remat):
    """Mamba layer ``i``; with a cache, its decode state is read from and
    written back into ``cache["ssm"]`` in place."""
    if remat:
        return _remat(_remat_mamba_layer, lw, x, cfg)
    if cache is None:
        return _mamba_layer(lw, x, cfg, None)[0]
    states = cache["ssm"]
    x, new = _mamba_layer(lw, x, cfg, {k: v[i] for k, v in states.items()})
    for k, v in new.items():
        states[k][i].copy_(v)
    return x


def _kv_slot(cache, i, start):
    return None if cache is None else {
        "k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i], "len": start}


def forward(model: Transformer, cfg, tokens: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Returns (logits [B, T, V] bf16, new_cache, aux_loss).

    ``cache`` (decode): see :func:`init_cache`; its tensors are written in
    place and its ``len`` advanced.  ``prefix_embeds``: [B, Np, d] (vlm),
    prepended before the tokens.
    """
    bf = torch.bfloat16
    parts = []
    if prefix_embeds is not None:
        parts.append(prefix_embeds.to(bf))
    if tokens is not None and tokens.shape[1] > 0:
        emb = F.embedding(tokens, model.embed.to(bf))
        if cfg.tie_embeddings:
            # the reference multiplies by ``np.sqrt(d_model)``, a float64
            # numpy scalar, which JAX promotes (as float32) over bf16: the
            # residual stream of a tied model is f32
            emb = emb.float() * float(np.float32(np.sqrt(cfg.d_model)))
        parts.append(emb)
    # ``jnp.concatenate`` promotes to the widest part: a tied vlm's f32
    # token embeddings lift its bf16 patch embeddings to f32
    dtype = functools.reduce(torch.promote_types, [p.dtype for p in parts])
    x = torch.cat([p.to(dtype) for p in parts], dim=1)
    B, T, _ = x.shape
    dev = x.device

    # compute weights in bf16 before the layer loop, as the reference
    weights = [bf16_tree(layer) for layer in model.layers]

    start = int(cache["len"]) if cache is not None else 0
    if positions is None:
        positions = (start + torch.arange(T, device=dev))[None, :] \
            .expand(B, T)
    rope = (None if cfg.family == "ssm" else
            rope_tables(positions, cfg.head_dim, cfg.rope_theta, bf))
    prefix_len = cfg.num_prefix_embeds if cfg.prefix_lm else 0
    remat = cfg.remat and cache is None and torch.is_grad_enabled()

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.family in ("dense", "moe", "vlm"):
        for i, lw in enumerate(weights):
            if remat:
                x, a = _remat(_remat_attn_layer, lw, x, cfg, rope,
                              prefix_len)
            else:
                x, _, a = _attn_layer(lw, x, cfg, rope,
                                      _kv_slot(cache, i, start), prefix_len)
            aux = aux + a
    elif cfg.family == "ssm":
        for i, lw in enumerate(weights):
            x = _run_mamba(lw, i, x, cfg, cache, remat)
    else:
        x = _hybrid_forward(model, weights, x, cfg, rope, cache, start,
                            remat)

    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    logits = torch.matmul(x.to(bf), head.to(bf))
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["len"] = start + T
    return logits, new_cache, aux


def _hybrid_forward(model, weights, x, cfg, rope, cache, start, remat):
    """Groups of ``attn_period`` mamba layers, the one shared attention +
    MLP block after each group, then the tail layers.  The shared block's
    KV cache has one slot per group (one per use)."""
    k = cfg.attn_period
    G = cfg.num_layers // k
    shared = bf16_tree(model.shared_attn)
    for g in range(G):
        for i in range(g * k, (g + 1) * k):
            x = _run_mamba(weights[i], i, x, cfg, cache, remat)
        x, _, _ = _attn_layer(shared, x, cfg, rope, _kv_slot(cache, g, start),
                              0)
    for i in range(G * k, cfg.num_layers):
        x = _run_mamba(weights[i], i, x, cfg, cache, remat)
    return x


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def init_kv(cfg, layers: int, batch: int, max_len: int, device=None):
    """KV stacked over ``layers`` slots, ``[layers, B, max_len, K, Dh]``
    bf16."""
    shape = (layers, batch, max_len, cfg.eff_num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_cache(cfg, batch: int, max_len: int, device=None) -> Dict[str, Any]:
    """Decode cache: ``kv`` (attention families: one slot a layer; the
    hybrid: one a group), ``ssm`` (ssm, hybrid: each layer's conv buffers
    and state) and the filled length ``len`` (a host int: the reference
    also keeps a per-layer copy for its scan, which a loop does not
    need)."""
    L = cfg.num_layers
    cache: Dict[str, Any] = {"len": 0}
    if cfg.family in ("dense", "moe", "vlm"):
        cache["kv"] = init_kv(cfg, L, batch, max_len, device)
    else:
        cache["ssm"] = init_mamba_state(cfg, batch, L, device)
        if cfg.family == "hybrid":
            cache["kv"] = init_kv(cfg, L // cfg.attn_period, batch, max_len,
                                  device)
    return cache
