"""Transformer building blocks: GQA attention (blockwise/flash, cached),
the SwiGLU MLP and the GShard-style MoE — the JAX package's
``models/layers.py``.

Attention mirrors the reference's blockwise algorithm step for step: a
loop over KV chunks with an online softmax in f32, and a custom backward
(:class:`FlashAttention`) that keeps only ``(q, k, v, out, lse)`` and
recomputes each chunk's probabilities from ``lse``.  The products are
``torch.matmul`` on the compute dtype, as the reference's XLA einsums
are; no fused attention kernel is called.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import rms_norm, rotate, silu

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def attention_specs(cfg, s):
    """Specs of an attention's weights by logical names (``s``: a spec
    function of the rules), the reference's table."""
    p = {
        "wq": s("fsdp", "heads", None),
        "wk": s("fsdp", "kv_heads", None),
        "wv": s("fsdp", "kv_heads", None),
        "wo": s("heads", None, "fsdp"),
    }
    if cfg.qk_norm:
        p["q_norm"] = s(None)
        p["k_norm"] = s(None)
    return p


def mlp_specs(s):
    return {"wg": s("fsdp", "ffn"), "wu": s("fsdp", "ffn"),
            "wd": s("ffn", "fsdp")}


def moe_specs(cfg, s):
    """The experts on ``experts`` (the model axis), their ``d`` dim on
    ``fsdp``; the router whole; the shared experts an MLP's."""
    p = {"router": s(None, None), "wg": s("experts", "fsdp", None),
         "wu": s("experts", "fsdp", None), "wd": s("experts", None, "fsdp")}
    if cfg.num_shared_experts:
        p["shared"] = mlp_specs(s)
    return p


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
    tokens, usually 1).  The head counts are the weights' (on a mesh, a
    coordinate's local heads).  Returns (out, new_cache): on a mesh
    with the heads split, ``out`` is this coordinate's partial sum."""
    B, T, d = x.shape
    H, K, Dh = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
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
    """``p``: the layer's MLP weights in bf16 (on a mesh with the ffn dim
    split, a coordinate's columns of ``wg``/``wu`` and rows of ``wd``: the
    output is its partial sum)."""
    xc = x.to(torch.bfloat16)
    g = torch.matmul(xc, p["wg"])
    u = torch.matmul(xc, p["wu"])
    h = silu(g) * u
    return torch.matmul(h, p["wd"])


# --------------------------------------------------------------------------
# MoE (GShard-style grouped dispatch; shared + routed experts)
# --------------------------------------------------------------------------
def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, ties
    broken by the lower index.  A stable descending sort keeps that order;
    ``torch.topk`` does not promise it, and a zero row (the padding of a
    group) gives exactly uniform probabilities, all ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_router(p: Dict[str, torch.Tensor], xg, cfg,
               top_e: Optional[torch.Tensor] = None):
    """Router logits ``[..., E]`` f32 -> (probs, top_p, top_e): padded
    experts (``eff_num_experts > num_experts``) get -1e30 and are never
    chosen; the top-k probabilities are renormalised to sum to 1.  With
    ``top_e`` given (``[..., k]``, another run's choice: see
    :func:`routing_log`), those experts are taken instead of the top k.

    The product is an f32 matmul of the bf16 operands (each product exact
    in f32).  The reference casts its bf16 einsum to f32 at once, and XLA
    then keeps the dot's f32 result (it allows excess precision): its
    compiled logits are never rounded to bf16, and a near-tie between
    experts turns on that rounding."""
    logits = torch.matmul(xg.to(torch.bfloat16).float(), p["router"].float())
    E = cfg.eff_num_experts
    if E > cfg.num_experts:
        pad = torch.arange(E, device=logits.device) >= cfg.num_experts
        logits = logits.masked_fill(pad, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if top_e is None:
        top_p, top_e = top_k(probs, cfg.top_k)
    else:
        top_p = probs.gather(-1, top_e)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def capacity(cfg, g: int) -> int:
    """Slots an expert has in a group of ``g`` tokens (GShard)."""
    return max(1, int(g * cfg.top_k / cfg.eff_num_experts
                      * cfg.capacity_factor))


def queue_positions(top_e: torch.Tensor, E: int, C: int):
    """Each (token, slot)'s position in its expert's queue and whether it
    is kept (``pos < C``): a cumulative count over the group's ``g * k``
    pairs in (token, slot) order.  ``top_e``: ``[..., g, k]``."""
    *lead, g, k = top_e.shape
    onehot = F.one_hot(top_e, E)                              # [..., g, k, E]
    pos = onehot.reshape(*lead, g * k, E).cumsum(dim=-2) \
        .reshape(*lead, g, k, E) - 1
    pos = (pos * onehot).sum(dim=-1)                          # [..., g, k]
    return pos, pos < C


class RoutingLog(list):
    """What :func:`routing_log` yields: one entry a MoE layer call, in call
    order, ``{"top_e": [B, T, k], "kept": [B, T, k] bool}`` over the
    whole batch (a mesh's rows in order); ``replay`` the log whose
    choices the calls take, or None."""

    replay: Optional[list] = None


_LOG: Optional[RoutingLog] = None


@contextlib.contextmanager
def routing_log(replay: Optional[list] = None):
    """While open, every MoE layer (``transformer.moe_sublayer``) appends
    the experts its block routed each token to and the (token, slot)
    pairs it kept.  With ``replay`` (another log of the same layers), the
    i-th call routes each token to the experts ``replay[i]`` has for it
    (its last T positions: a decoded token takes the last position of a
    prefill), weighted by this call's own probabilities.  Off, the
    blocks pay one test of a global."""
    global _LOG
    log = RoutingLog()
    log.replay = replay
    saved, _LOG = _LOG, log
    try:
        yield log
    finally:
        _LOG = saved


def active_routing_log() -> Optional[RoutingLog]:
    return _LOG


def moe_block_dropless(p: Dict[str, torch.Tensor], x, cfg,
                       experts: Optional[Tuple[int, int]] = None,
                       route=None):
    """Capacity-free MoE for decode (small token counts): every expert is
    applied to every token and combined by the routing weights, so no
    token is dropped.  With ``experts`` = (e0, e1), ``p``'s expert
    weights are those experts' only (a mesh coordinate's) and the output
    is their partial sum.  ``route``: :func:`moe_router`'s output for
    ``x``'s tokens, if the caller has it.  Returns (out, 0.0)."""
    B, T, d = x.shape
    E = cfg.eff_num_experts
    xt = x.reshape(B * T, d).to(torch.bfloat16)
    _, top_p, top_e = moe_router(p, xt, cfg) if route is None else route
    w = (F.one_hot(top_e, E).float() * top_p[..., None]).sum(dim=1)  # [N, E]
    if experts is not None:
        w = w[:, experts[0]:experts[1]]
    h = silu(torch.matmul(xt, p["wg"])) * torch.matmul(xt, p["wu"])
    out = torch.matmul(h, p["wd"])                                   # [E,N,d]
    y = torch.einsum("end,ne->nd", out.float(), w).reshape(B, T, d)
    if "shared" in p:
        y = y + mlp_block(p["shared"], x).float()
    return y.to(x.dtype), 0.0


def moe_block(p: Dict[str, torch.Tensor], x, cfg, group_size: int = 0,
              experts: Optional[Tuple[int, int]] = None, route=None,
              batch=None, row0: int = 0, kept: Optional[list] = None):
    """x: [B, T, d].  Top-k routing with per-group expert capacity
    ``C = g*k/E * capacity_factor`` (GShard); a dropped (token, slot)
    passes through the residual only.  Groups have a fixed size
    ``g`` (the last one padded with zero rows), so a token's queue
    position never depends on the tokens after it.  The reference maps
    over the groups one at a time; here they are a leading batch axis.
    Dispatch and combine are its one-hot products, in bf16.

    On a mesh coordinate, ``x`` is the coordinate's rows of the batch
    (from ``row0``), ``route`` their routing (:func:`moe_router` of
    their flattened tokens), ``batch`` = (probs ``[N, E]``, top_e ``[N,
    k]``) the whole batch's, gathered over the data axes: the groups run
    over the batch's flattened tokens, so the queue positions, the drops
    and the aux loss are one device's.  The coordinate dispatches only
    its own tokens, to their slots of the ``experts`` = (e0, e1) that
    ``p`` holds, in the groups its tokens lie in (a static C slots an
    expert: the slots of the rows on other coordinates stay zero).  The
    output is ``x``'s rows' partial sum over those experts (and the
    shared experts ``p`` holds).  ``kept``: a list that gets the batch's
    kept pairs ``[N, k]``.  Returns (out, aux_loss)."""
    B, T, d = x.shape
    E, k = cfg.eff_num_experts, cfg.top_k
    g = group_size or cfg.moe_group_size
    Nl = B * T
    xt = x.reshape(Nl, d)
    probs, top_p, top_e = moe_router(p, xt, cfg) if route is None else route
    probs_b, top_e_b = (probs, top_e) if batch is None else batch
    N = top_e_b.shape[0]
    ng = -(-N // g)
    pad = ng * g - N
    if pad:
        # a group's padding, zero rows: uniform probabilities, the first
        # k experts (the stable sort's ties)
        zp, zt, ze = moe_router(p, xt.new_zeros(1, d), cfg)
        probs_b = torch.cat([probs_b, zp.expand(pad, E)])
        top_e_b = torch.cat([top_e_b, ze.expand(pad, k)])
        if Nl == N:
            top_p = torch.cat([top_p, zt.expand(pad, k)])
    C = capacity(cfg, g)
    bf = torch.bfloat16

    pos, within = queue_positions(top_e_b.reshape(ng, g, k), E, C)
    # load-balance aux loss (Switch): E * mean(frac_tokens * mean_prob)
    frac = F.one_hot(top_e_b, E).float().sum(dim=1).reshape(ng, g, E) \
        .mean(dim=1)                                          # [ng, E]
    aux = E * (frac * probs_b.reshape(ng, g, E).mean(dim=1)).sum(dim=-1)
    if kept is not None:
        kept.append(within.reshape(ng * g, k)[:N])

    a = row0 * T                                  # our first token
    if Nl == N:
        # the whole batch: the groups as they are (their padding too)
        ngl, off = ng, 0
        xl = F.pad(xt, (0, 0, 0, pad)).reshape(ng, g, d)
        top_e_l, top_p_l = top_e_b.reshape(ng, g, k), top_p.reshape(ng, g, k)
        pos_l, keep = pos, within
    else:
        G0, G1 = a // g, (a + Nl - 1) // g
        ngl = G1 - G0 + 1
        # our tokens in their groups: [1, Nl] inside one group, else
        # [ngl, g] with the others' places empty (zero rows, not kept)
        s = Nl if ngl == 1 else g
        lo = a if ngl == 1 else G0 * g
        off, after = a - lo, lo + ngl * s - a - Nl
        xl, top_e_l, top_p_l = (
            F.pad(t, (0, 0, off, after)) if off or after else t
            for t in (xt, top_e, top_p))
        xl, top_e_l, top_p_l = (t.reshape(ngl, s, -1)
                                for t in (xl, top_e_l, top_p_l))
        pos_l, keep = (t.reshape(ng * g, k)[lo:lo + ngl * s]
                       .reshape(ngl, s, k) for t in (pos, within))
        if off or after:
            i = torch.arange(ngl * s, device=x.device)
            keep = keep & ((i >= off) & (i < off + Nl)).reshape(ngl, s, 1)
    ge = F.one_hot(top_e_l, E).to(bf)                         # [ngl,s,k,E]
    if experts is not None:
        ge = ge[..., experts[0]:experts[1]]
    pc = F.one_hot(torch.where(keep, pos_l, C), C + 1).to(bf)[..., :C]
    disp = torch.einsum("nske,nskc->nsec", ge, pc)            # [ngl,s,E,C]
    comb = torch.einsum("nske,nskc->nsec", ge * top_p_l.to(bf)[..., None],
                        pc)
    xin = torch.einsum("nsec,nsd->necd", disp, xl.to(bf))     # [ngl,E,C,d]
    h = silu(torch.matmul(xin, p["wg"])) * torch.matmul(xin, p["wu"])
    out = torch.matmul(h, p["wd"])                            # [ngl,E,C,d]
    y = torch.einsum("necd,nsec->nsd", out, comb)
    y = y.reshape(-1, d)[off:off + Nl].reshape(B, T, d)
    if "shared" in p:
        y = y + mlp_block(p["shared"], x)
    return y.to(x.dtype), aux.mean()
