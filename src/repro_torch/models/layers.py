"""Transformer building blocks: GQA attention (blockwise/flash, cached)
and the SwiGLU MLP — the JAX package's ``models/layers.py`` for the dense
family (its MoE blocks are not ported yet, ROADMAP queue 1).

Attention mirrors the reference's blockwise algorithm step for step: a
loop over KV chunks with an online softmax in f32, and a custom backward
(:class:`FlashAttention`) that keeps only ``(q, k, v, out, lse)`` and
recomputes each chunk's probabilities from ``lse``.  The products are
``torch.matmul`` on the compute dtype, as the reference's XLA einsums
are; no fused attention kernel is called.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import rms_norm, rotate

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def _online_softmax_chunk(qg, k, v, mask, carry):
    """One flash step: qg [B,K,G,Tq,Dh], k/v [B,K,Tc,Dh], mask [Tq,Tc]
    additive f32.  carry = (m, l, acc): [B,K,G,Tq], [B,K,G,Tq],
    [B,K,G,Tq,Dh], all f32."""
    m, l, acc = carry
    B, K, G, Tq, Dh = qg.shape
    Tc = k.shape[2]
    s = torch.matmul(qg.reshape(B, K, G * Tq, Dh), k.transpose(-1, -2))
    s = s.reshape(B, K, G, Tq, Tc).float()
    s = s / np.sqrt(Dh) + mask
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.matmul(p.to(v.dtype).reshape(B, K, G * Tq, Tc), v)
    acc_new = acc * alpha[..., None] + pv.reshape(B, K, G, Tq, Dh).float()
    return m_new, l_new, acc_new


@functools.lru_cache(maxsize=16)
def _chunk_mask(Tq, chunk, cidx, q_offset, causal, prefix_len, valid_total,
                device):
    """Additive f32 mask [Tq, chunk] for kv chunk ``cidx``: the same for
    every layer of a forward, so the last few are kept (never written)."""
    q_pos = q_offset + torch.arange(Tq, device=device)
    k_pos = cidx * chunk + torch.arange(chunk, device=device)
    ok = (k_pos < valid_total)[None, :]
    if causal:
        vis = q_pos[:, None] >= k_pos[None, :]
        if prefix_len:
            vis = vis | (k_pos < prefix_len)[None, :]
        ok = ok & vis
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, NEG_INF)


def _kv_chunks(k, chunk):
    """[B, Tk, K, Dh] -> [nc, B, K, chunk, Dh], zero-padded to whole
    chunks."""
    B, Tk, K, Dh = k.shape
    nc = -(-Tk // chunk)
    kp = F.pad(k, (0, 0, 0, 0, 0, nc * chunk - Tk))
    return kp.reshape(B, nc, chunk, K, Dh).permute(1, 0, 3, 2, 4)


def _flash_fwd(q, k, v, causal, chunk, q_offset, prefix_len, kv_valid_len):
    """Returns (out [B,Tq,H,Dh] in q's dtype, lse [B,K,G,Tq] f32)."""
    B, Tq, H, Dh = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    kp, vp = _kv_chunks(k, chunk), _kv_chunks(v, chunk)
    qg = q.permute(0, 2, 1, 3).reshape(B, K, G, Tq, Dh)
    valid_total = Tk if kv_valid_len is None else kv_valid_len
    dev = q.device
    carry = (torch.full((B, K, G, Tq), NEG_INF, dtype=torch.float32,
                        device=dev),
             torch.zeros((B, K, G, Tq), dtype=torch.float32, device=dev),
             torch.zeros((B, K, G, Tq, Dh), dtype=torch.float32, device=dev))
    for cidx in range(kp.shape[0]):
        mask = _chunk_mask(Tq, chunk, cidx, q_offset, causal, prefix_len,
                           valid_total, dev)
        carry = _online_softmax_chunk(qg, kp[cidx], vp[cidx], mask, carry)
    m, l, acc = carry
    out = acc / torch.clamp(l[..., None], min=1e-30)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = out.reshape(B, H, Tq, Dh).permute(0, 2, 1, 3)
    return out.to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, causal, chunk, q_offset,
               prefix_len):
    """Flash backward: recompute each chunk's probabilities from
    ``(q, k, lse)``; only O(T) residuals are kept."""
    B, Tq, H, Dh = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    kp, vp = _kv_chunks(k, chunk), _kv_chunks(v, chunk)
    nc = kp.shape[0]

    def grouped(t):
        return t.permute(0, 2, 1, 3).reshape(B, K, G, Tq, Dh)

    qg, dog, og = grouped(q), grouped(dout), grouped(out)
    delta = (dog.float() * og.float()).sum(dim=-1)
    scale = 1.0 / np.sqrt(Dh)
    qf = qg.reshape(B, K, G * Tq, Dh)
    dof = dog.reshape(B, K, G * Tq, Dh)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for cidx in range(nc):
        kc, vc = kp[cidx], vp[cidx]
        C = kc.shape[2]
        mask = _chunk_mask(Tq, chunk, cidx, q_offset, causal, prefix_len,
                           Tk, q.device)
        s = torch.matmul(qf, kc.transpose(-1, -2)).reshape(B, K, G, Tq, C)
        s = s.float() * scale + mask
        p = torch.exp(s - lse[..., None])                     # [B,K,G,Tq,C]
        pf = p.to(dog.dtype).reshape(B, K, G * Tq, C)
        dvs.append(torch.matmul(pf.transpose(-1, -2), dof))   # [B,K,C,Dh]
        dp = torch.matmul(dof, vc.transpose(-1, -2)).reshape(B, K, G, Tq, C)
        ds = p * (dp.float() - delta[..., None]) * scale
        dsf = ds.reshape(B, K, G * Tq, C)
        dq = dq + torch.matmul(dsf.to(kc.dtype), kc).reshape(B, K, G, Tq, Dh)
        dks.append(torch.matmul(dsf.to(qg.dtype).transpose(-1, -2), qf))
    dq = dq.reshape(B, H, Tq, Dh).permute(0, 2, 1, 3).to(q.dtype)
    # [nc, B, K, chunk, Dh] -> [B, nc*chunk, K, Dh]
    dk = torch.stack(dks).permute(1, 0, 3, 2, 4).reshape(B, nc * chunk, K, Dh)
    dv = torch.stack(dvs).permute(1, 0, 3, 2, 4).reshape(B, nc * chunk, K, Dh)
    return dq, dk[:, :Tk].to(k.dtype), dv[:, :Tk].to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_train`` ``custom_vjp``: saves ``(q, k, v,
    out, lse)`` and recomputes the probabilities in the backward.  Under
    ``torch.utils.checkpoint`` its forward runs again in the backward
    pass, and the tensors saved there are the ones the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, q_offset, prefix_len):
        out, lse = _flash_fwd(q, k, v, causal, chunk, q_offset, prefix_len,
                              None)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, chunk, q_offset, prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                *ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0,
                    prefix_len: int = 0, kv_valid_len=None):
    """Blockwise (flash) attention with a memory-efficient backward.

    q: [B, Tq, H, Dh]; k, v: [B, Tk, K, Dh] (GQA: H % K == 0, head h reads
    KV head h // (H // K)).  ``q_offset``: absolute position of q[0]
    (prefill into a cache: its length).  ``prefix_len``: bidirectional
    prefix.  ``kv_valid_len``: mask out cache positions >= this (the
    cached path is not differentiated, so it takes the plain forward).
    """
    if kv_valid_len is None:
        return FlashAttention.apply(q, k, v, causal, chunk, q_offset,
                                    prefix_len)
    return _flash_fwd(q, k, v, causal, chunk, q_offset, prefix_len,
                      kv_valid_len)[0]


def attention_block(p: Dict[str, torch.Tensor], x, cfg, rope,
                    cache: Optional[dict] = None, prefix_len: int = 0,
                    causal: bool = True):
    """x: [B, T, d].  ``p``: the layer's attention weights in bf16 (the
    reference casts the layers before its scan).  ``rope``: the
    ``common.rope_tables`` (cos, sin) of the positions, in bf16.
    ``cache``: None or dict(k, v: [B, S, K, Dh], len: int); the new keys
    and values are written into it at ``len`` in place (decode: T new
    tokens, usually 1).  Returns (out, new_cache)."""
    B, T, d = x.shape
    H, K, Dh = cfg.eff_num_heads, cfg.eff_num_kv_heads, cfg.head_dim
    xc = x.to(torch.bfloat16)
    q = torch.matmul(xc, p["wq"].reshape(d, H * Dh)).reshape(B, T, H, Dh)
    k = torch.matmul(xc, p["wk"].reshape(d, K * Dh)).reshape(B, T, K, Dh)
    v = torch.matmul(xc, p["wv"].reshape(d, K * Dh)).reshape(B, T, K, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotate(q, *rope)
    k = rotate(k, *rope)

    new_cache = None
    if cache is not None:
        ck, cv, start = cache["k"], cache["v"], int(cache["len"])
        S = ck.shape[1]
        ck[:, start:start + T] = k.to(ck.dtype)
        cv[:, start:start + T] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "len": start + T}
        if T == 1:
            # decode fast path: scores are [B,K,G,S]
            G = H // K
            qg = q.reshape(B, K, G, Dh)
            s = torch.matmul(qg, ck.permute(0, 2, 3, 1)).float()  # [B,K,G,S]
            s = s / np.sqrt(Dh)
            valid = torch.arange(S, device=x.device) < (start + T)
            s = torch.where(valid, s, torch.full((), NEG_INF, device=x.device))
            pattn = torch.softmax(s, dim=-1)
            out = torch.matmul(pattn.to(cv.dtype), cv.permute(0, 2, 1, 3))
            out = out.reshape(B, 1, H, Dh)
        else:
            out = flash_attention(
                q, ck, cv, causal=causal, chunk=min(cfg.attn_chunk, S),
                q_offset=start, prefix_len=prefix_len, kv_valid_len=start + T)
    else:
        out = flash_attention(q, k, v, causal=causal,
                              chunk=min(cfg.attn_chunk, T),
                              prefix_len=prefix_len)
    y = torch.matmul(out.to(torch.bfloat16).reshape(B, T, H * Dh),
                     p["wo"].reshape(H * Dh, d))
    return y, new_cache


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
def mlp_block(p: Dict[str, torch.Tensor], x):
    """``p``: the layer's MLP weights in bf16."""
    xc = x.to(torch.bfloat16)
    g = torch.matmul(xc, p["wg"])
    u = torch.matmul(xc, p["wu"])
    h = F.silu(g) * u
    return torch.matmul(h, p["wd"])
