"""Encoder–decoder model (seamless-m4t-medium backbone), the JAX
package's ``models/encdec.py``.

Encoder: bidirectional attention over precomputed speech-frame
embeddings (the modality frontend is a stub: the caller gives [B, S, d]
frames).  Decoder: causal self-attention + cross-attention over the
encoder output.  The blocks, the layer loop, the remat and the mesh
layout are the decoder-only model's (:mod:`.transformer`): on a mesh the
encoder runs the same attention and MLP blocks, non-causal, its frames
split on the sequence (``seq_sp``) between blocks; the cross-attention
computes each coordinate's heads against the K/V of the whole encoder
output.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import sharding as shd
from .common import NO_SHARD, ShardCtx, init_dense, new_generator
from .layers import attention_specs, flash_attention, mlp_specs
from .transformer import (_TP_DIM, MLP, Attention, Layer, _add, _bf16, _entry,
                          _heads_axes, _remat, attn_sublayer, cache_specs_kv,
                          dotted, embed_tokens, flat_params, gathered,
                          geo_of, kv_shapes, layer_specs, layer_weights,
                          lm_head, mlp_sublayer, normed_input, parts,
                          rope_parts, run_attn_layer, to_residual,
                          zeros_tree)


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
        gen = new_generator(seed, device)
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


def encode(model, frames, cfg, ctx: ShardCtx = NO_SHARD):
    """frames: [B, S, d] (the stub frontend's output).  Returns [B, S, d]
    bf16; on a mesh, :class:`~repro_torch.sharding.Sharded` ``("batch",
    None, None)``: each coordinate's rows, the whole sequence."""
    flat = flat_params(model)
    x0 = {c: t.to(torch.bfloat16)
          for c, t in ctx.parts(frames, "batch", None, None).items()}
    B, S = frames.shape[0], frames.shape[1]
    geo = geo_of(ctx, B, S)
    rope = rope_parts(ctx, cfg, x0, None, 0, S)
    x = shd.split(x0, geo.mesh, geo.seq, 1)
    remat = cfg.remat and torch.is_grad_enabled()
    for lw in layer_weights(flat, "enc_layers", cfg.enc_layers):
        x, _ = run_attn_layer(lw, x, cfg, geo, rope, None, 0, 0, 0, remat,
                              causal=False)
    out = normed_input(x, flat["enc_norm"], cfg, geo)
    if geo.mesh is None:
        return out[()]
    return shd.Sharded(out, (B, S, cfg.d_model), (_entry(geo.rows), None,
                                                   None), geo.mesh)


def enc_kv(model, enc_out, cfg, ctx: ShardCtx = NO_SHARD,
           stack: bool = True) -> Dict[str, Any]:
    """Each decoder layer's cross K/V of the encoder output, stacked:
    ``[L, B, S, K, Dh]`` bf16; on a mesh,
    :class:`~repro_torch.sharding.Sharded` ``(None, "batch", None,
    "kv_heads", None)``: each coordinate's rows and the KV heads its
    cross-attention computes.  ``stack=False`` (teacher-forced training)
    keeps each coordinate's list of the L layers' [B, S, K, Dh] instead:
    a layer's slice of a stacked tensor takes back a gradient of the
    whole stack, which would make the backward's work grow as L**2."""
    flat = flat_params(model)
    eo = parts(enc_out)
    Dh = cfg.head_dim
    got = {"k": {c: [] for c in eo}, "v": {c: [] for c in eo}}
    heads = ()
    for i in range(cfg.num_layers):
        pre = f"dec_layers.{i}.cross."
        heads = _heads_axes({n: flat[pre + n] for n in ("wq", "wk")})
        for n in ("k", "v"):
            w = gathered(_bf16(flat[pre + "w" + n]), 1 if heads else None)
            for c, xb in eo.items():
                B, S, d = xb.shape
                K = w[c].shape[1]
                got[n][c].append(torch.matmul(
                    xb.to(torch.bfloat16), w[c].reshape(d, K * Dh))
                    .reshape(B, S, K, Dh))
    if not stack:
        return got
    out = {n: {c: torch.stack(ts) for c, ts in v.items()}
           for n, v in got.items()}
    if ctx.mesh is None:
        return {n: v[()] for n, v in out.items()}
    B, S = enc_out.shape[0], enc_out.shape[1]
    shape = (cfg.num_layers, B, S, cfg.eff_num_kv_heads, Dh)
    sp = (None, enc_out.spec[0], None, _entry(heads), None)
    return {n: shd.Sharded(v, shape, sp, ctx.mesh) for n, v in out.items()}


def cross_attention(p: Dict[str, torch.Tensor], x, kv, cfg):
    """x: [B, T, d]; ``kv``: dict(k, v [B, S, K, Dh]) precomputed; ``p``:
    the layer's cross weights in bf16 (on a mesh with the heads split, a
    coordinate's: the output is its partial sum).  Bidirectional over the
    encoder output, in KV chunks of ``cfg.attn_chunk`` (the reference's;
    the last one padded and masked)."""
    B, T, d = x.shape
    H, Dh = p["wq"].shape[1], cfg.head_dim
    q = torch.matmul(x.to(torch.bfloat16), p["wq"].reshape(d, H * Dh)) \
        .reshape(B, T, H, Dh)
    out = flash_attention(q, kv["k"], kv["v"], causal=False,
                          chunk=cfg.attn_chunk)
    return torch.matmul(out.to(torch.bfloat16).reshape(B, T, H * Dh),
                        p["wo"].reshape(H * Dh, d))


def cross_sublayer(lw, x: shd.Local, kv: shd.Local, cfg, geo) -> shd.Local:
    """``x + cross_attention(rms_norm(x, lnx))``: each coordinate's heads
    against its part of the cross K/V."""
    cross = lw["cross"]
    heads = _heads_axes(cross)
    w = {n: gathered(cross[n], _TP_DIM[n] if heads else None)
         for n in ("wq", "wo")}
    hn = normed_input(x, lw["lnx"], cfg, geo)
    y = {c: cross_attention({n: t[c] for n, t in w.items()}, h, kv[c], cfg)
         for c, h in hn.items()}
    return _add(x, to_residual(y, geo, heads))


def dec_layer(lw, x, kv, cfg, geo, rope, cache=None, i: int = 0,
              start: int = 0):
    x = attn_sublayer(lw, x, cfg, geo, rope, cache, i, start)
    x = cross_sublayer(lw, x, kv, cfg, geo)
    return mlp_sublayer(lw, x, cfg, geo)


def decode(model, tokens: torch.Tensor, enc_out, cfg,
           cache: Optional[dict] = None, kv: Optional[dict] = None,
           ctx: ShardCtx = NO_SHARD):
    """Teacher-forced decode over [B, T] targets (``cache=None``) or
    decode into a cache (its self-attention KV written in place, its
    ``len`` advanced; the cross K/V from ``cache["enc_kv"]``).  Returns
    (logits [B, T, V] bf16, new_cache); on a mesh the logits are
    :class:`~repro_torch.sharding.Sharded` ``("batch", None, "vocab")``."""
    flat = flat_params(model)
    B, T = tokens.shape[0], tokens.shape[1]
    geo = geo_of(ctx, B, T)
    x0 = embed_tokens(flat, ctx.parts(tokens, "batch", None), cfg)
    start = int(cache["len"]) if cache is not None else 0
    rope = rope_parts(ctx, cfg, x0, None, start, T)
    x = shd.split(x0, geo.mesh, geo.seq, 1)
    if kv is None and cache is not None:
        kv = cache["enc_kv"]
    if kv is None:      # each coordinate's list of the layers' K/V
        lists = enc_kv(model, enc_out, cfg, ctx, stack=False)
        kp, vp = lists["k"], lists["v"]
    else:
        kp, vp = parts(kv["k"]), parts(kv["v"])
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, lw in enumerate(layer_weights(flat, "dec_layers",
                                         cfg.num_layers)):
        kv_l = {c: {"k": kp[c][i], "v": vp[c][i]} for c in kp}
        if remat:
            x = _remat(dec_layer, lw, x, kv_l, cfg, geo, rope)
        else:
            x = dec_layer(lw, x, kv_l, cfg, geo, rope, cache, i, start)
    logits = lm_head(flat, x, cfg, geo, B, T)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["len"] = start + T
    return logits, new_cache


def init_cache(cfg, batch: int, max_len: int, enc_len: int, device=None,
               ctx: ShardCtx = NO_SHARD) -> Dict[str, Any]:
    """``kv``: the decoder's self-attention KV, ``[L, B, max_len, K, Dh]``;
    ``enc_kv``: the cross K/V, ``[L, B, enc_len, K, Dh]`` (prefill fills
    it); ``len`` a host int.  On a mesh each is
    :class:`~repro_torch.sharding.Sharded` by :func:`cache_specs`."""
    L = cfg.num_layers
    shapes = {"kv": kv_shapes(cfg, L, batch, max_len),
              "enc_kv": kv_shapes(cfg, L, batch, enc_len)}
    specs = None if ctx.mesh is None else cache_specs(cfg, ctx.rules)
    return {"len": 0, **zeros_tree(shapes, specs, device, ctx)}


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
def param_specs(cfg, rules) -> Dict[str, shd.Spec]:
    """Specs keyed by the module's parameter names, in its order (the
    reference's ``encdec.param_specs``)."""
    s = functools.partial(shd.spec, rules)
    enc = dotted(layer_specs(cfg, s, "dense"))
    attn = attention_specs(cfg, s)
    dec = dotted({"ln1": s(None), "attn": attn, "lnx": s(None),
                  "cross": {n: attn[n] for n in ("wq", "wk", "wv", "wo")},
                  "ln2": s(None), "mlp": mlp_specs(s)})
    out = {"embed": s("vocab", "fsdp")}
    for i in range(cfg.enc_layers):
        out.update({f"enc_layers.{i}.{k}": v for k, v in enc.items()})
    out["enc_norm"] = s(None)
    for i in range(cfg.num_layers):
        out.update({f"dec_layers.{i}.{k}": v for k, v in dec.items()})
    out["final_norm"] = s(None)
    out["lm_head"] = s("fsdp", "vocab")
    return out


def cache_specs(cfg, rules) -> Dict[str, Any]:
    """Specs of :func:`init_cache`'s tree: the self-attention KV as the
    decoder-only model's, the cross K/V on ``cache_batch`` and
    ``cache_heads``."""
    s = functools.partial(shd.spec, rules)
    enc = s(None, "cache_batch", None, "cache_heads", None)
    return {"len": s(), "kv": cache_specs_kv(s),
            "enc_kv": {"k": enc, "v": enc}}
