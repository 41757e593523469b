"""Decoder-only LM, the JAX package's ``models/transformer.py``: the
dense, moe, vlm, ssm and hybrid families.

  dense  — GQA attention + SwiGLU           (yi-34b, qwen3, llama3.2, smollm)
  moe    — GQA attention + shared/routed MoE (qwen2-moe, olmoe)
  ssm    — Mamba2 (SSD) blocks, attention-free          (mamba2-2.7b)
  hybrid — Mamba2 backbone + one *shared* attention+MLP block applied
           after every ``attn_period`` layers (zamba2-style weight sharing)
  vlm    — dense backbone + precomputed patch-embedding prefix with
           prefix-LM (bidirectional prefix) masking       (paligemma)

On a mesh (``ctx=ShardCtx(mesh, rules)``, the dense family), the
parameters are a dict of :class:`~repro_torch.sharding.Sharded` keyed by
the module's names, laid out by :func:`param_specs`, and every
coordinate computes on its own batch rows and weight shards, as the
reference's ``with_sharding_constraint`` points make XLA partition it
(see :func:`_mesh_forward`).

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

from .. import sharding as shd
from .common import NO_SHARD, ShardCtx, init_dense, rms_norm, rope_tables
from .layers import (attention_block, attention_specs, mlp_block,
                     mlp_specs, moe_block, moe_block_dropless)
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
            prefix_embeds: Optional[torch.Tensor] = None,
            ctx: ShardCtx = NO_SHARD):
    """Returns (logits [B, T, V] bf16, new_cache, aux_loss).

    ``cache`` (decode): see :func:`init_cache`; its tensors are written in
    place and its ``len`` advanced.  ``prefix_embeds``: [B, Np, d] (vlm),
    prepended before the tokens.  On a mesh (``ctx.mesh``), ``model`` is
    a dict of sharded parameters, ``tokens`` a global tensor or one laid
    out ``("batch", None)``, and the logits are
    :class:`~repro_torch.sharding.Sharded` ``("batch", None, "vocab")``.
    """
    if ctx.mesh is not None:
        if prefix_embeds is not None or positions is not None:
            raise NotImplementedError("the mesh path takes tokens only")
        return _mesh_forward(model, cfg, ctx, tokens, cache)
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


def init_cache(cfg, batch: int, max_len: int, device=None,
               ctx: ShardCtx = NO_SHARD) -> Dict[str, Any]:
    """Decode cache: ``kv`` (attention families: one slot a layer; the
    hybrid: one a group), ``ssm`` (ssm, hybrid: each layer's conv buffers
    and state) and the filled length ``len`` (a host int: the reference
    also keeps a per-layer copy for its scan, which a loop does not
    need).  On a mesh, ``k`` and ``v`` are
    :class:`~repro_torch.sharding.Sharded` by :func:`cache_specs`, each
    coordinate's part allocated on its device."""
    L = cfg.num_layers
    cache: Dict[str, Any] = {"len": 0}
    if ctx.mesh is not None:
        check_mesh_family(cfg)
        shape = (L, batch, max_len, cfg.eff_num_kv_heads, cfg.head_dim)
        sp = shd.sanitize_spec(cache_specs(cfg, ctx.rules)["kv"]["k"], shape,
                               ctx.mesh)
        lshape = shd.local_shape(shape, sp, ctx.mesh)

        def zeros():
            return shd.Sharded(
                {c: torch.zeros(lshape, dtype=torch.bfloat16,
                                device=shd.device(ctx.mesh, c))
                 for c in shd.coords(ctx.mesh)}, shape, sp, ctx.mesh)

        cache["kv"] = {"k": zeros(), "v": zeros()}
        return cache
    if cfg.family in ("dense", "moe", "vlm"):
        cache["kv"] = init_kv(cfg, L, batch, max_len, device)
    else:
        cache["ssm"] = init_mamba_state(cfg, batch, L, device)
        if cfg.family == "hybrid":
            cache["kv"] = init_kv(cfg, L // cfg.attn_period, batch, max_len,
                                  device)
    return cache


# --------------------------------------------------------------------------
# specs (the mesh layout, by logical names)
# --------------------------------------------------------------------------
def check_mesh_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the LM runs on a mesh for the dense family; "
            f"{cfg.family!r} runs on one device")


def _dotted(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def param_specs(cfg, rules) -> Dict[str, shd.Spec]:
    """Specs keyed by the module's parameter names, in its order (the
    reference's ``param_specs``, whose stacked layers add a leading
    ``None``)."""
    check_mesh_family(cfg)
    s = functools.partial(shd.spec, rules)
    layer = _dotted({"ln1": s(None), "attn": attention_specs(cfg, s),
                     "ln2": s(None), "mlp": mlp_specs(s)})
    out = {"embed": s("vocab", "fsdp")}
    for i in range(cfg.num_layers):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out["final_norm"] = s(None)
    if not cfg.tie_embeddings:
        out["lm_head"] = s("fsdp", "vocab")
    return out


def cache_specs(cfg, rules) -> Dict[str, Any]:
    """Specs of :func:`init_cache`'s tree (``k``/``v`` stacked on layers;
    the reference's per-layer ``len`` has no counterpart here)."""
    check_mesh_family(cfg)
    s = functools.partial(shd.spec, rules)
    kv = s(None, "cache_batch", "cache_seq", "cache_heads", None)
    return {"len": s(), "kv": {"k": kv, "v": kv}}


# --------------------------------------------------------------------------
# the forward on a mesh
# --------------------------------------------------------------------------
# the dim of each weight that stays split over the model axis while it is
# used (tensor parallelism); every other split dim is fsdp's, gathered
# just before use
_TP_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "wg": 1, "wu": 1, "wd": 0,
           "embed": 0, "lm_head": 1}


def _gather_fsdp(sh: shd.Sharded, keep: Optional[int]) -> shd.Local:
    """``sh``'s parts with every split dim but ``keep`` all-gathered."""
    parts = sh.parts
    for dim, e in enumerate(sh.spec):
        if dim != keep and e is not None:
            parts = shd.all_gather(parts, sh.mesh, shd.entry_axes(e), dim)
    return parts


def _to_residual(y: shd.Local, mesh, partial, seq) -> shd.Local:
    """A block's output into the residual's layout (split on the sequence
    over ``seq``): partial sums over ``partial`` are reduce-scattered
    (all-reduced, then split, if the sequence is not split the same
    way), in their dtype; a replicated output is split."""
    if partial:
        if tuple(partial) == tuple(seq):
            return shd.reduce_scatter(y, mesh, partial, 1)
        y = shd.all_reduce(y, mesh, partial)
    return shd.split(y, mesh, seq, 1)


def _heads_axes(attn: Dict[str, shd.Sharded]):
    """The axes the attention's heads are computed split over: those of
    ``wq``'s heads when ``wk``'s KV heads are split alike (GQA groups
    stay whole on a coordinate), else () and every head is computed on
    every coordinate."""
    h = shd.entry_axes(attn["wq"].spec[1])
    return h if h == shd.entry_axes(attn["wk"].spec[1]) else ()


def _kv_slots(cache, i, mesh):
    """Layer ``i``'s cache on each coordinate, all-gathered over the
    sequence axes it rests on: (k, v, their axes)."""
    k, v = cache["kv"]["k"], cache["kv"]["v"]
    ax = shd.entry_axes(k.spec[2])
    return (shd.all_gather({c: t[i] for c, t in k.parts.items()}, mesh, ax, 1),
            shd.all_gather({c: t[i] for c, t in v.parts.items()}, mesh, ax, 1),
            ax)


def _write_back(cache, i, full, ax, start: int, T: int, mesh) -> None:
    """Positions [start, start + T) of the gathered layer ``i`` into the
    shard of the cache that owns them."""
    if shd.axes_size(mesh, ax) == 1:
        return                      # the gathered cache is the cache
    for name, got in zip(("k", "v"), full):
        for c, t in cache["kv"][name].parts.items():
            S_l = t.shape[2]
            lo = shd.index(mesh, c, ax) * S_l
            a, b = max(start, lo), min(start + T, lo + S_l)
            if a < b:
                t[i, :, a - lo:b - lo] = got[c][:, a:b]


def _normed(x, w, cfg):
    """A block's normed input in bf16, which is all the block reads of it:
    the sequence all-gather after it moves 2-byte words (a tied model's
    residual stream is f32)."""
    return rms_norm(x, w, cfg.norm_eps).to(torch.bfloat16)


def _mesh_layer(lw, x: shd.Local, cfg, ctx: ShardCtx, rope, seq,
                cache, i: int, start: int) -> shd.Local:
    """One dense layer on every coordinate.  ``lw``: the layer's bf16
    weights, :class:`~repro_torch.sharding.Sharded`; ``x``: the residual,
    split on the sequence over ``seq``."""
    mesh = ctx.mesh
    cs = list(x)
    T = next(iter(x.values())).shape[1] * shd.axes_size(mesh, seq)
    attn = lw["attn"]
    heads = _heads_axes(attn)
    w = {n: _gather_fsdp(sh, _TP_DIM.get(n) if heads else None)
         for n, sh in attn.items()}
    hn = shd.all_gather({c: _normed(x[c], lw["ln1"].parts[c], cfg)
                         for c in cs}, mesh, seq, 1)
    slots = None if cache is None else _kv_slots(cache, i, mesh)
    y = {}
    for c in cs:
        slot = None if slots is None else {
            "k": slots[0][c], "v": slots[1][c], "len": start}
        y[c], _ = attention_block({n: t[c] for n, t in w.items()}, hn[c],
                                  cfg, rope[c], cache=slot)
    if slots is not None:
        _write_back(cache, i, slots[:2], slots[2], start, T, mesh)
    h = _to_residual(y, mesh, heads, seq)
    x = {c: x[c] + h[c] for c in cs}

    mlp = lw["mlp"]
    w = {n: _gather_fsdp(sh, _TP_DIM[n]) for n, sh in mlp.items()}
    hn = shd.all_gather({c: _normed(x[c], lw["ln2"].parts[c], cfg)
                         for c in cs}, mesh, seq, 1)
    y = {c: mlp_block({n: t[c] for n, t in w.items()}, hn[c]) for c in cs}
    h = _to_residual(y, mesh, shd.entry_axes(mlp["wg"].spec[1]), seq)
    return {c: x[c] + h[c] for c in cs}


def _remat_mesh_layer(lw, x, cfg, ctx, rope, seq):
    return _mesh_layer(lw, x, cfg, ctx, rope, seq, None, 0, 0)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _embed(params, tok: shd.Sharded, cfg, ctx: ShardCtx) -> shd.Local:
    """The vocab-parallel lookup: each coordinate looks up the rows of
    its vocab shard, zeroes the others, and the lookups are all-reduced
    over the vocab axes (one non-zero term: exact)."""
    mesh, bf = ctx.mesh, torch.bfloat16
    sh = params["embed"]
    vocab = shd.entry_axes(sh.spec[0])
    table = _gather_fsdp(sh.map(lambda t: t.to(bf)), _TP_DIM["embed"])
    out = {}
    for c, ids in tok.parts.items():
        Vl = table[c].shape[0]
        loc = ids - shd.index(mesh, c, vocab) * Vl
        mine = (loc >= 0) & (loc < Vl)
        out[c] = F.embedding(loc.clamp(0, Vl - 1), table[c]) \
            .masked_fill(~mine[..., None], 0)
    out = shd.all_reduce(out, mesh, vocab)
    if cfg.tie_embeddings:
        scale = float(np.float32(np.sqrt(cfg.d_model)))
        out = {c: t.float() * scale for c, t in out.items()}
    return out


def _mesh_forward(params: Dict[str, shd.Sharded], cfg, ctx: ShardCtx,
                  tokens, cache):
    """The dense decoder on every coordinate of ``ctx.mesh``, following
    the reference's constraint points: the embedding's output, each
    block's output and the final norm's input are split on the sequence
    over the model axis (``seq_sp``); each block all-gathers its normed
    input, computes its heads and ffn columns (column-parallel up,
    row-parallel down, its partial sums reduce-scattered in bf16), its
    weights all-gathered over the data axes just before use (fsdp); the
    logits come out split on the vocab (``"batch", None, "vocab"``).
    With a cache, each layer's KV cache is all-gathered over the axes
    its sequence rests on and the new positions written back to their
    owners."""
    check_mesh_family(cfg)
    mesh, bf = ctx.mesh, torch.bfloat16
    tok = ctx.local(tokens, "batch", None)
    B, T = tok.shape
    seq = ctx.axes("seq_sp", T)
    x = shd.split(_embed(params, tok, cfg, ctx), mesh, seq, 1)

    flat = {n[len("layers."):]: sh.map(lambda t: t.to(bf))
            for n, sh in params.items() if n.startswith("layers.")}
    layers = _nest(flat)
    start = int(cache["len"]) if cache is not None else 0
    rope = {}
    for c, ids in tok.parts.items():
        pos = (start + torch.arange(T, device=ids.device))[None, :] \
            .expand(ids.shape[0], T)
        rope[c] = rope_tables(pos, cfg.head_dim, cfg.rope_theta, bf)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        lw = layers[str(i)]
        if remat:
            x = _remat(_remat_mesh_layer, lw, x, cfg, ctx, rope, seq)
        else:
            x = _mesh_layer(lw, x, cfg, ctx, rope, seq, cache, i, start)

    fn = params["final_norm"]
    xn = shd.all_gather({c: _normed(t, fn.parts[c], cfg)
                         for c, t in x.items()}, mesh, seq, 1)
    # a tied head casts and gathers the embedding again, as one device
    # casts it twice: each use's gradient is cast to f32 on its own
    name = "embed" if cfg.tie_embeddings else "lm_head"
    sh = params[name]
    head = _gather_fsdp(sh.map(lambda t: t.to(bf)), _TP_DIM[name])
    if cfg.tie_embeddings:
        head = {c: t.t() for c, t in head.items()}
    vocab = sh.spec[_TP_DIM[name]]
    logits = shd.Sharded({c: torch.matmul(t, head[c])
                          for c, t in xn.items()},
                         (B, T, cfg.vocab_padded), (tok.spec[0], None, vocab),
                         mesh)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["len"] = start + T
    aux = torch.zeros((), dtype=torch.float32,
                      device=shd.device(mesh, shd.coords(mesh)[0]))
    return logits, new_cache, aux
