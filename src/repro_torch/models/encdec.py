"""Encoder–decoder model (seamless-m4t-medium backbone), the JAX
package's ``models/encdec.py``.

Encoder: bidirectional attention over precomputed speech-frame
embeddings (the modality frontend is a stub: the caller gives [B, S, d]
frames).  Decoder: causal self-attention + cross-attention over the
encoder output.  Same layer loop and remat as the decoder-only model.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import init_dense, rms_norm, rope_tables
from .layers import attention_block, flash_attention, mlp_block
from .transformer import (MLP, Attention, Layer, _kv_slot, _remat, bf16_tree,
                          init_kv)


class DecLayer(nn.Module):
    """``ln1``, ``attn`` (causal self-attention), ``lnx``, ``cross``
    (cross-attention, no qk norms), ``ln2``, ``mlp``."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        zeros = lambda: nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.ln1 = zeros()
        self.attn = Attention(cfg, gen, device)
        self.lnx = zeros()
        self.cross = Attention(cfg, gen, device, qk_norm=False)
        self.ln2 = zeros()
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, device)


class EncDec(nn.Module):
    """``embed [Vp, d]``, ``enc_layers`` (dense layers), ``enc_norm``,
    ``dec_layers``, ``final_norm``, ``lm_head [d, Vp]``."""

    def __init__(self, cfg, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        d = cfg.d_model
        self.embed = nn.Parameter(init_dense(gen, (cfg.vocab_padded, d), d,
                                             device))
        self.enc_layers = nn.ModuleList(
            [Layer(cfg, gen, device, family="dense")
             for _ in range(cfg.enc_layers)])
        self.enc_norm = nn.Parameter(torch.zeros(d, device=device))
        self.dec_layers = nn.ModuleList(
            [DecLayer(cfg, gen, device) for _ in range(cfg.num_layers)])
        self.final_norm = nn.Parameter(torch.zeros(d, device=device))
        self.lm_head = nn.Parameter(init_dense(
            gen, (d, cfg.vocab_padded), fan_in=d, device=device))


def _positions(B: int, T: int, start: int, device):
    return (start + torch.arange(T, device=device))[None, :].expand(B, T)


def _enc_layer(lw, x, cfg, rope):
    h, _ = attention_block(lw["attn"], rms_norm(x, lw["ln1"], cfg.norm_eps),
                           cfg, rope, causal=False)
    x = x + h
    return x + mlp_block(lw["mlp"], rms_norm(x, lw["ln2"], cfg.norm_eps))


def encode(model: EncDec, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: [B, S, d] (the stub frontend's output).  Returns [B, S, d]
    bf16."""
    x = frames.to(torch.bfloat16)
    B, S, _ = x.shape
    rope = rope_tables(_positions(B, S, 0, x.device), cfg.head_dim,
                       cfg.rope_theta, torch.bfloat16)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.enc_layers:
        lw = bf16_tree(layer)
        x = (_remat(_enc_layer, lw, x, cfg, rope) if remat
             else _enc_layer(lw, x, cfg, rope))
    return rms_norm(x, model.enc_norm, cfg.norm_eps)


def enc_kv(model: EncDec, enc_out: torch.Tensor, cfg) -> Dict[str, Any]:
    """Each decoder layer's cross K/V of the encoder output, stacked:
    ``[L, B, S, K, Dh]`` bf16."""
    B, S, d = enc_out.shape
    K, Dh = cfg.eff_num_kv_heads, cfg.head_dim
    xb = enc_out.to(torch.bfloat16)
    ks, vs = [], []
    for layer in model.dec_layers:
        c = layer.cross
        ks.append(torch.matmul(xb, c.wk.to(torch.bfloat16).reshape(d, K * Dh))
                  .reshape(B, S, K, Dh))
        vs.append(torch.matmul(xb, c.wv.to(torch.bfloat16).reshape(d, K * Dh))
                  .reshape(B, S, K, Dh))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def cross_attention(p: Dict[str, torch.Tensor], x, kv, cfg):
    """x: [B, T, d]; ``kv``: dict(k, v [B, S, K, Dh]) precomputed; ``p``:
    the layer's cross weights in bf16.  Bidirectional over the encoder
    output, in KV chunks of ``cfg.attn_chunk`` (the reference's; the last
    one padded and masked)."""
    B, T, d = x.shape
    H, Dh = cfg.eff_num_heads, cfg.head_dim
    q = torch.matmul(x.to(torch.bfloat16), p["wq"].reshape(d, H * Dh)) \
        .reshape(B, T, H, Dh)
    out = flash_attention(q, kv["k"], kv["v"], causal=False,
                          chunk=cfg.attn_chunk)
    return torch.matmul(out.to(torch.bfloat16).reshape(B, T, H * Dh),
                        p["wo"].reshape(H * Dh, d))


def _dec_layer(lw, x, kv, cfg, rope, cache):
    h, _ = attention_block(lw["attn"], rms_norm(x, lw["ln1"], cfg.norm_eps),
                           cfg, rope, cache=cache)
    x = x + h
    x = x + cross_attention(lw["cross"], rms_norm(x, lw["lnx"], cfg.norm_eps),
                            kv, cfg)
    return x + mlp_block(lw["mlp"], rms_norm(x, lw["ln2"], cfg.norm_eps))


def _remat_dec_layer(lw, x, kv, cfg, rope):
    return _dec_layer(lw, x, kv, cfg, rope, None)


def decode(model: EncDec, tokens: torch.Tensor,
           enc_out: Optional[torch.Tensor], cfg,
           cache: Optional[dict] = None, kv: Optional[dict] = None):
    """Teacher-forced decode over [B, T] targets (``cache=None``) or
    decode into a cache (its self-attention KV written in place, its
    ``len`` advanced; the cross K/V from ``cache["enc_kv"]``).  Returns
    (logits [B, T, V] bf16, new_cache)."""
    bf = torch.bfloat16
    x = F.embedding(tokens, model.embed.to(bf))
    B, T, _ = x.shape
    start = int(cache["len"]) if cache is not None else 0
    rope = rope_tables(_positions(B, T, start, x.device), cfg.head_dim,
                       cfg.rope_theta, bf)
    if kv is None:
        kv = cache["enc_kv"] if cache is not None else enc_kv(model, enc_out,
                                                              cfg)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, layer in enumerate(model.dec_layers):
        lw = bf16_tree(layer)
        kv_l = {"k": kv["k"][i], "v": kv["v"][i]}
        if remat:
            x = _remat(_remat_dec_layer, lw, x, kv_l, cfg, rope)
        else:
            x = _dec_layer(lw, x, kv_l, cfg, rope, _kv_slot(cache, i, start))
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = torch.matmul(x.to(bf), model.lm_head.to(bf))
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["len"] = start + T
    return logits, new_cache


def init_cache(cfg, batch: int, max_len: int, enc_len: int,
               device=None) -> Dict[str, Any]:
    """``kv``: the decoder's self-attention KV, ``[L, B, max_len, K, Dh]``;
    ``enc_kv``: the cross K/V, ``[L, B, enc_len, K, Dh]`` (prefill fills
    it); ``len`` a host int."""
    L = cfg.num_layers
    return {"len": 0, "kv": init_kv(cfg, L, batch, max_len, device),
            "enc_kv": init_kv(cfg, L, batch, enc_len, device)}
