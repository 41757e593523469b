"""Decoder-only LM, the JAX package's ``models/transformer.py``: the
dense, moe, vlm, ssm and hybrid families.

  dense  — GQA attention + SwiGLU           (yi-34b, qwen3, llama3.2, smollm)
  moe    — GQA attention + shared/routed MoE (qwen2-moe, olmoe)
  ssm    — Mamba2 (SSD) blocks, attention-free          (mamba2-2.7b)
  hybrid — Mamba2 backbone + one *shared* attention+MLP block applied
           after every ``attn_period`` layers (zamba2-style weight sharing)
  vlm    — dense backbone + precomputed patch-embedding prefix with
           prefix-LM (bidirectional prefix) masking       (paligemma)

One decoder serves one device and a mesh.  Every layer runs on every
coordinate of ``ctx.mesh`` at once: the residual stream is a dict
coordinate -> tensor (one device is the one coordinate ``()``), each
block is called per coordinate on its local weights and rows, and the
collectives between blocks (:mod:`repro_torch.sharding`) move the parts
as the reference's ``with_sharding_constraint`` points make XLA
partition it.  Off the mesh every collective has no axes and returns its
input, and a weight is its own one part: the one-device path runs the
same ops as a plain loop would.

On a mesh (``ctx=ShardCtx(mesh, rules)``) the parameters are a dict of
:class:`~repro_torch.sharding.Sharded` keyed by the module's names, laid
out by :func:`param_specs`: the embedding's output, each block's output
and the final norm's input are split on the sequence over the model
axis (``seq_sp``); each block all-gathers its normed input, computes its
heads, ffn columns, experts or SSM heads (column-parallel up,
row-parallel down, its partial sums reduce-scattered in bf16), its
weights all-gathered over the data axes just before use (fsdp); the
logits come out split on the vocab (``"batch", None, "vocab"``).

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
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import sharding as shd
from .common import (NO_SHARD, ShardCtx, init_dense, new_generator, rms_norm,
                     rope_tables)
from . import layers
from .layers import (attention_block, attention_specs, mlp_block,
                     mlp_specs, moe_block, moe_block_dropless, moe_specs)
from .ssm import Mamba, mamba_mix, mamba_out, mamba_specs


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


class Transformer(nn.Module):
    """The decoder: ``embed [Vp, d]``, ``layers``, ``final_norm``, untied
    ``lm_head [d, Vp]`` and, for the hybrid, ``shared_attn``."""

    def __init__(self, cfg, seed: int = 0, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                             "decoder-only family")
        self.cfg = cfg
        gen = new_generator(seed, device)
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
# parameters and parts
# --------------------------------------------------------------------------
def flat_params(model) -> Dict[str, Any]:
    """Name -> tensor of a module, or a mesh's dict of name ->
    :class:`~repro_torch.sharding.Sharded` as it is."""
    return dict(model.named_parameters()) if isinstance(model, nn.Module) \
        else model


def _bf16(w):
    if isinstance(w, shd.Sharded):
        return w.map(lambda t: t.to(torch.bfloat16))
    return w.to(torch.bfloat16)


def weights(flat: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries of ``flat`` under ``prefix`` in bf16, nested by name
    (``attn.wq`` -> ``out["attn"]["wq"]``), as the reference casts the
    stacked layers before its scan."""
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split(".")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = _bf16(t)
    return out


def layer_weights(flat: Dict[str, Any], group: str, n: int) -> list:
    """Each of the ``n`` layers of ``group`` (``layers``, ``enc_layers``,
    ``dec_layers``) as :func:`weights`, cast once before the loop."""
    every = weights(flat, group + ".")
    return [every[str(i)] for i in range(n)]


def parts(t) -> shd.Local:
    """A sharded tensor's parts; a tensor is its own one part."""
    return t.parts if isinstance(t, shd.Sharded) else {(): t}


def split_axes(t, dim: int) -> Tuple[str, ...]:
    """The mesh axes ``t``'s ``dim`` is split over (() off the mesh)."""
    return shd.entry_axes(t.spec[dim]) if isinstance(t, shd.Sharded) else ()


def _entry(axes: Tuple[str, ...]) -> shd.Entry:
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def gathered(w, keep: Optional[int] = None) -> shd.Local:
    """``w``'s parts with every split dim but ``keep`` all-gathered (the
    fsdp shards just before use; ``keep`` the tensor-parallel dim)."""
    if not isinstance(w, shd.Sharded):
        return {(): w}
    out = w.parts
    for dim, e in enumerate(w.spec):
        if dim != keep and e is not None:
            out = shd.all_gather(out, w.mesh, shd.entry_axes(e), dim)
    return out


class Geo(NamedTuple):
    """Where a forward runs: the mesh (None on one device), and the mesh
    axes the residual stream's sequence and rows are split over."""

    mesh: Any
    seq: Tuple[str, ...]
    rows: Tuple[str, ...]

    def first(self) -> shd.Coord:
        return () if self.mesh is None else shd.coords(self.mesh)[0]


def geo_of(ctx: ShardCtx, B: int, T: int) -> Geo:
    return Geo(ctx.mesh, ctx.axes("seq_sp", T), ctx.axes("batch", B))


def rope_parts(ctx: ShardCtx, cfg, rows: shd.Local, positions, start: int,
               T: int) -> shd.Local:
    """(cos, sin) on each coordinate for its rows: of ``positions``
    (laid out ``("batch", None)``), else of ``start + arange(T)``."""
    if positions is not None:
        pos = ctx.parts(positions, "batch", None)
    else:
        pos = {c: (start + torch.arange(T, device=t.device))[None, :]
               .expand(t.shape[0], T) for c, t in rows.items()}
    return {c: rope_tables(p, cfg.head_dim, cfg.rope_theta, torch.bfloat16)
            for c, p in pos.items()}


# --------------------------------------------------------------------------
# the collectives between blocks
# --------------------------------------------------------------------------
# the dim of each weight that stays split over the model axis while it is
# used (tensor parallelism); every other split dim is fsdp's, gathered
# just before use
_TP_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "wg": 1, "wu": 1, "wd": 0,
           "embed": 0, "lm_head": 1}
_MAMBA_TP_DIM = {"wz": 1, "wx": 1, "conv_x": 1, "norm": 0, "wo": 0}


def to_residual(y: shd.Local, geo: Geo, partial) -> shd.Local:
    """A block's output into the residual's layout (split on the sequence
    over ``geo.seq``): partial sums over ``partial`` are reduce-scattered
    (all-reduced, then split, if the sequence is not split the same
    way), in their dtype; a replicated output is split."""
    if partial:
        if tuple(partial) == tuple(geo.seq):
            return shd.reduce_scatter(y, geo.mesh, partial, 1)
        y = shd.all_reduce(y, geo.mesh, partial)
    return shd.split(y, geo.mesh, geo.seq, 1)


def _normed(x, w, cfg):
    """A block's normed input in bf16, which is all the block reads of it:
    the sequence all-gather after it moves 2-byte words (a tied model's
    residual stream is f32)."""
    return rms_norm(x, w, cfg.norm_eps).to(torch.bfloat16)


def normed_input(x: shd.Local, w, cfg, geo: Geo) -> shd.Local:
    """Each coordinate's rows of ``rms_norm(x)``, whole sequence."""
    wp = parts(w)
    return shd.all_gather({c: _normed(t, wp[c], cfg) for c, t in x.items()},
                          geo.mesh, geo.seq, 1)


def _add(x: shd.Local, h: shd.Local) -> shd.Local:
    return {c: x[c] + h[c] for c in x}


def _heads_axes(attn: Dict[str, Any]):
    """The axes the attention's heads are computed split over: those of
    ``wq``'s heads when ``wk``'s KV heads are split alike (GQA groups
    stay whole on a coordinate), else () and every head is computed on
    every coordinate."""
    h = split_axes(attn["wq"], 1)
    return h if h == split_axes(attn["wk"], 1) else ()


def _kv_slots(cache, i, mesh):
    """Layer ``i``'s cache on each coordinate, all-gathered over the
    sequence axes it rests on: (k, v, their axes)."""
    k, v = cache["kv"]["k"], cache["kv"]["v"]
    ax = split_axes(k, 2)
    return (shd.all_gather({c: t[i] for c, t in parts(k).items()}, mesh, ax,
                           1),
            shd.all_gather({c: t[i] for c, t in parts(v).items()}, mesh, ax,
                           1),
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


# --------------------------------------------------------------------------
# the blocks on every coordinate
# --------------------------------------------------------------------------
def attn_sublayer(lw, x: shd.Local, cfg, geo: Geo, rope, cache=None,
                  i: int = 0, start: int = 0, prefix_len: int = 0,
                  causal: bool = True) -> shd.Local:
    """``x + attention(rms_norm(x, ln1))``: each coordinate computes its
    heads (all of them when ``_heads_axes`` is empty); with a cache,
    layer ``i``'s KV is gathered over the axes its sequence rests on and
    the new positions written back to their owners."""
    attn = lw["attn"]
    heads = _heads_axes(attn)
    w = {n: gathered(t, _TP_DIM.get(n) if heads else None)
         for n, t in attn.items()}
    hn = normed_input(x, lw["ln1"], cfg, geo)
    slots = None if cache is None else _kv_slots(cache, i, geo.mesh)
    y = {}
    for c, h in hn.items():
        slot = None if slots is None else {
            "k": slots[0][c], "v": slots[1][c], "len": start}
        y[c], _ = attention_block({n: t[c] for n, t in w.items()}, h, cfg,
                                  rope[c], cache=slot, prefix_len=prefix_len,
                                  causal=causal)
    if slots is not None:
        T = next(iter(hn.values())).shape[1]
        _write_back(cache, i, slots[:2], slots[2], start, T, geo.mesh)
    return _add(x, to_residual(y, geo, heads))


def mlp_sublayer(lw, x: shd.Local, cfg, geo: Geo,
                 ln: str = "ln2") -> shd.Local:
    """``x + mlp(rms_norm(x, ln))``: column-parallel up, row-parallel
    down."""
    mlp = lw["mlp"]
    w = {n: gathered(t, _TP_DIM[n]) for n, t in mlp.items()}
    hn = normed_input(x, lw[ln], cfg, geo)
    y = {c: mlp_block({n: t[c] for n, t in w.items()}, h)
         for c, h in hn.items()}
    return _add(x, to_residual(y, geo, split_axes(mlp["wg"], 1)))


def moe_sublayer(lw, x: shd.Local, cfg, geo: Geo, decode: bool):
    """``x + moe(rms_norm(x, ln2))`` and the load-balance loss.  Each
    coordinate routes its own rows' tokens, runs its experts
    (``"experts"``: the model axis) on them and sends its combine's
    partial sums back like the row-parallel MLP.  The capacity groups are
    the one device's, over the global flattened tokens: a group may span
    the data shards, so the routing (probabilities and top-k experts,
    not the tokens) is all-gathered over the rows' axes, and every
    coordinate counts the queue positions, and so the dropped (token,
    slot) pairs, over the whole batch as one device does.  Decode is
    dropless, per token.  The aux loss (the same on every coordinate) is
    the first coordinate's.  Under :func:`layers.routing_log` the layer's
    routing is logged (or replayed)."""
    moe, mesh = lw["moe"], geo.mesh
    ex = split_axes(moe["wg"], 0)
    w = {n: gathered(moe[n], 0) for n in ("wg", "wu", "wd")}
    w["router"] = gathered(moe["router"])
    shared = moe.get("shared")
    if shared is not None:
        # the shared MLP's partial sums go with the experts'
        if split_axes(shared["wg"], 1) != ex:
            raise ValueError(f"{cfg.name}: the shared experts' ffn and the "
                             "experts split over different mesh axes")
        w_sh = {n: gathered(t, _TP_DIM[n]) for n, t in shared.items()}
    hn = normed_input(x, lw["ln2"], cfg, geo)
    B_l, T, d = next(iter(hn.values())).shape
    log = layers.active_routing_log()
    forced = None if log is None or log.replay is None \
        else log.replay[len(log)]["top_e"]
    ps, row0, kw, routes = {}, {}, {}, {}
    for c, h in hn.items():
        ps[c] = {n: t[c] for n, t in w.items()}
        if shared is not None:
            ps[c]["shared"] = {n: t[c] for n, t in w_sh.items()}
        row0[c] = r0 = shd.index(mesh, c, geo.rows) * B_l
        E_l = ps[c]["wg"].shape[0]
        e0 = shd.index(mesh, c, ex) * E_l
        kw[c] = {} if mesh is None else {"experts": (e0, e0 + E_l)}
        fe = None if forced is None else \
            forced[r0:r0 + B_l, -T:].reshape(B_l * T, -1).to(h.device)
        routes[c] = layers.moe_router(ps[c], h.reshape(B_l * T, d), cfg, fe)
    if not decode:
        batch = [shd.all_gather({c: r[i] for c, r in routes.items()}, mesh,
                                geo.rows, 0) for i in (0, 2)]
    y, aux, kept = {}, 0.0, []
    for c, h in hn.items():
        if decode:
            y[c], a = moe_block_dropless(ps[c], h, cfg, route=routes[c],
                                         **kw[c])
        else:
            y[c], a = moe_block(
                ps[c], h, cfg, route=routes[c],
                batch=(batch[0][c], batch[1][c]), row0=row0[c],
                kept=kept if c == geo.first() and log is not None else None,
                **kw[c])
        if c == geo.first():
            aux = a
    if log is not None:
        # the batch's rows in order, from the first expert shard's
        # coordinates
        first = sorted((row0[c], c) for c in hn
                       if shd.index(mesh, c, ex) == 0)
        dev = routes[geo.first()][2].device
        top_e = torch.cat([routes[c][2].to(dev) for _, c in first]) \
            .reshape(-1, T, cfg.top_k)
        log.append({"top_e": top_e,
                    "kept": kept[0].reshape(-1, T, cfg.top_k) if kept
                    else torch.ones_like(top_e, dtype=torch.bool)})
    return _add(x, to_residual(y, geo, ex)), aux


def mamba_heads(mw, cfg, mesh) -> Tuple[str, ...]:
    """The axes a mamba layer's SSM heads are split over: those of
    ``wx``'s ``d_inner``, which must split it on head boundaries."""
    ax = split_axes(mw["wx"], 1)
    if cfg.ssm_heads % shd.axes_size(mesh, ax):
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} SSM heads do not "
                         f"split over {ax}")
    return ax


def mamba_sublayer(lw, x: shd.Local, cfg, geo: Geo, cache=None,
                   i: int = 0) -> shd.Local:
    """``x + mamba(rms_norm(x, ln1))``: ``wz``/``wx`` column-parallel on
    the SSM heads, ``wo`` row-parallel; ``wB``, ``wC``, ``wdt`` and the
    head-wise ``dt_bias``, ``A_log``, ``D`` whole, each coordinate taking
    its heads.  The gated norm's mean of squares over the whole
    ``d_inner`` is all-reduced over the heads' axes before the scale.
    With a cache, layer ``i``'s conv buffers and SSM state (each
    coordinate's heads) are read and written back in place."""
    mw, mesh = lw["mamba"], geo.mesh
    heads = mamba_heads(mw, cfg, mesh)
    w = {n: gathered(t, _MAMBA_TP_DIM.get(n)) for n, t in mw.items()}
    hn = normed_input(x, lw["ln1"], cfg, geo)
    states = None if cache is None else cache["ssm"]
    H_l = cfg.ssm_heads // shd.axes_size(mesh, heads)
    ys, new = {}, {}
    for c, h in hn.items():
        h0 = shd.index(mesh, c, heads) * H_l
        st = None if states is None else {
            k: parts(v)[c][i] for k, v in states.items()}
        ys[c], new[c] = mamba_mix({n: t[c] for n, t in w.items()}, h, cfg,
                                  st, heads=(h0, h0 + H_l) if heads else None)
    ss = None
    if heads:
        ss = shd.all_reduce({c: y.square().sum(dim=-1, keepdim=True)
                             for c, y in ys.items()}, mesh, heads)
    out = {c: mamba_out({n: t[c] for n, t in w.items()}, y, cfg,
                        None if ss is None else ss[c])
           for c, y in ys.items()}
    if states is not None:
        for c, st in new.items():
            for k, v in st.items():
                parts(states[k])[c][i].copy_(v)
    return _add(x, to_residual(out, geo, heads))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def attn_layer(lw, x: shd.Local, cfg, geo: Geo, rope, cache=None, i: int = 0,
               start: int = 0, prefix_len: int = 0, causal: bool = True):
    """Attention, then the MLP or (``lw`` has ``moe``) the MoE: grouped
    with capacity for training and prefill, dropless for one cached
    token.  Returns (x, aux)."""
    x = attn_sublayer(lw, x, cfg, geo, rope, cache, i, start, prefix_len,
                      causal)
    if "moe" in lw:
        T = next(iter(x.values())).shape[1] * shd.axes_size(geo.mesh,
                                                            geo.seq)
        return moe_sublayer(lw, x, cfg, geo, cache is not None and T == 1)
    return mlp_sublayer(lw, x, cfg, geo), 0.0


# called with the arguments of every rematerialised block: all that the
# backward keeps of its forward (``launch/cost.py`` counts them as saved)
REMAT_OBSERVERS: list = []


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: the backward keeps
    only ``args`` and recomputes the rest."""
    for observe in REMAT_OBSERVERS:
        observe(args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, determinism_check="none")


def run_attn_layer(lw, x, cfg, geo, rope, cache, i, start, prefix_len,
                   remat: bool, causal: bool = True):
    """:func:`attn_layer`, under ``torch.utils.checkpoint`` when
    ``remat`` (no cache then)."""
    if remat:
        return _remat(attn_layer, lw, x, cfg, geo, rope, None, 0, 0,
                      prefix_len, causal)
    return attn_layer(lw, x, cfg, geo, rope, cache, i, start, prefix_len,
                      causal)


def _run_mamba(lw, i, x, cfg, geo, cache, remat):
    if remat:
        return _remat(mamba_sublayer, lw, x, cfg, geo)
    return mamba_sublayer(lw, x, cfg, geo, cache, i)


# --------------------------------------------------------------------------
# embedding and head
# --------------------------------------------------------------------------
def embed_tokens(flat, tok: shd.Local, cfg) -> shd.Local:
    """The token embeddings on each coordinate.  On a mesh with the vocab
    split, the lookup is vocab-parallel: each coordinate looks up the
    rows of its vocab shard, zeroes the others, and the lookups are
    all-reduced over the vocab axes (one non-zero term: exact)."""
    sh = _bf16(flat["embed"])
    vocab = split_axes(sh, 0)
    table = gathered(sh, _TP_DIM["embed"])
    out = {}
    for c, ids in tok.items():
        if vocab:
            Vl = table[c].shape[0]
            loc = ids - shd.index(sh.mesh, c, vocab) * Vl
            mine = (loc >= 0) & (loc < Vl)
            out[c] = F.embedding(loc.clamp(0, Vl - 1), table[c]) \
                .masked_fill(~mine[..., None], 0)
        else:
            out[c] = F.embedding(ids, table[c])
    if vocab:
        out = shd.all_reduce(out, sh.mesh, vocab)
    if cfg.tie_embeddings:
        # the reference multiplies by ``np.sqrt(d_model)``, a float64
        # numpy scalar, which JAX promotes (as float32) over bf16: the
        # residual stream of a tied model is f32
        scale = float(np.float32(np.sqrt(cfg.d_model)))
        out = {c: t.float() * scale for c, t in out.items()}
    return out


def lm_head(flat, x: shd.Local, cfg, geo: Geo, B: int, T: int,
            norm: str = "final_norm"):
    """The final norm, then the logits ``[B, T, Vp]`` bf16: a tensor on
    one device, :class:`~repro_torch.sharding.Sharded` ``("batch", None,
    "vocab")`` on a mesh.  A tied head casts and gathers the embedding
    again, as one device casts it twice: each use's gradient is cast to
    f32 on its own."""
    xn = normed_input(x, flat[norm], cfg, geo)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    sh = _bf16(flat[name])
    head = gathered(sh, _TP_DIM[name])
    if cfg.tie_embeddings:
        head = {c: t.t() for c, t in head.items()}
    logits = {c: torch.matmul(t, head[c]) for c, t in xn.items()}
    if geo.mesh is None:
        return logits[()]
    vocab = sh.spec[_TP_DIM[name]]
    return shd.Sharded(logits, (B, T, cfg.vocab_padded),
                       (_entry(geo.rows), None, vocab), geo.mesh)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def forward(model, cfg, tokens: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            ctx: ShardCtx = NO_SHARD):
    """Returns (logits [B, T, V] bf16, new_cache, aux_loss).

    ``cache`` (decode): see :func:`init_cache`; its tensors are written in
    place and its ``len`` advanced.  ``prefix_embeds``: [B, Np, d] (vlm),
    prepended before the tokens.  On a mesh (``ctx.mesh``), ``model`` is
    a dict of sharded parameters, the inputs global tensors or laid out
    ``("batch", ...)``, and the logits
    :class:`~repro_torch.sharding.Sharded` ``("batch", None, "vocab")``.
    """
    flat = flat_params(model)
    inputs = []
    if prefix_embeds is not None:
        inputs.append({c: t.to(torch.bfloat16) for c, t in ctx.parts(
            prefix_embeds, "batch", None, None).items()})
    if tokens is not None and tokens.shape[1] > 0:
        inputs.append(embed_tokens(flat, ctx.parts(tokens, "batch", None),
                                   cfg))
    # ``jnp.concatenate`` promotes to the widest part: a tied vlm's f32
    # token embeddings lift its bf16 patch embeddings to f32
    dtype = functools.reduce(torch.promote_types,
                             [t.dtype for p in inputs for t in p.values()])
    x0 = {c: torch.cat([p[c].to(dtype) for p in inputs], dim=1)
          if len(inputs) > 1 else t for c, t in inputs[0].items()}
    first = next(iter(x0.values()))
    T = first.shape[1]
    B = (tokens if tokens is not None else prefix_embeds).shape[0]
    geo = geo_of(ctx, B, T)
    x = shd.split(x0, geo.mesh, geo.seq, 1)

    start = int(cache["len"]) if cache is not None else 0
    rope = (None if cfg.family == "ssm" else
            rope_parts(ctx, cfg, x0, positions, start, T))
    prefix_len = cfg.num_prefix_embeds if cfg.prefix_lm else 0
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    # compute weights in bf16 before the layer loop, as the reference
    layers = layer_weights(flat, "layers", cfg.num_layers)

    aux = torch.zeros((), dtype=torch.float32, device=first.device)
    if cfg.family in ("dense", "moe", "vlm"):
        for i, lw in enumerate(layers):
            x, a = run_attn_layer(lw, x, cfg, geo, rope, cache, i, start,
                                  prefix_len, remat)
            aux = aux + a
    elif cfg.family == "ssm":
        for i, lw in enumerate(layers):
            x = _run_mamba(lw, i, x, cfg, geo, cache, remat)
    else:
        x = _hybrid_forward(flat, layers, x, cfg, geo, rope, cache, start,
                            remat)

    logits = lm_head(flat, x, cfg, geo, B, T)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["len"] = start + T
    return logits, new_cache, aux


def _hybrid_forward(flat, layers, x, cfg, geo, rope, cache, start, remat):
    """Groups of ``attn_period`` mamba layers, the one shared attention +
    MLP block after each group, then the tail layers.  The shared block's
    KV cache has one slot per group (one per use)."""
    k = cfg.attn_period
    G = cfg.num_layers // k
    shared = weights(flat, "shared_attn.")
    for g in range(G):
        for i in range(g * k, (g + 1) * k):
            x = _run_mamba(layers[i], i, x, cfg, geo, cache, remat)
        x, _ = attn_layer(shared, x, cfg, geo, rope, cache, g, start)
    for i in range(G * k, cfg.num_layers):
        x = _run_mamba(layers[i], i, x, cfg, geo, cache, remat)
    return x


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def kv_shapes(cfg, layers: int, batch: int, max_len: int) -> Dict[str, Any]:
    """KV stacked over ``layers`` slots, ``[layers, B, max_len, K, Dh]``
    bf16: (shape, dtype) of ``k`` and ``v``."""
    shape = (layers, batch, max_len, cfg.eff_num_kv_heads, cfg.head_dim)
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


def cache_shapes(cfg, batch: int, max_len: int) -> Dict[str, Any]:
    """(shape, dtype) of every tensor of :func:`init_cache`'s tree."""
    L = cfg.num_layers
    out: Dict[str, Any] = {}
    if cfg.family in ("dense", "moe", "vlm"):
        out["kv"] = kv_shapes(cfg, L, batch, max_len)
    else:
        W, N = cfg.conv_width, cfg.ssm_state
        H, P = cfg.ssm_heads, cfg.ssm_headdim
        bf = torch.bfloat16
        out["ssm"] = {"conv_x": ((L, batch, W - 1, cfg.d_inner), bf),
                      "conv_B": ((L, batch, W - 1, N), bf),
                      "conv_C": ((L, batch, W - 1, N), bf),
                      "ssm": ((L, batch, H, N, P), torch.float32)}
        if cfg.family == "hybrid":
            out["kv"] = kv_shapes(cfg, L // cfg.attn_period, batch, max_len)
    return out


def zeros_tree(shapes: Dict[str, Any], specs, device, ctx: ShardCtx):
    """Zeros of each (shape, dtype) leaf: on ``device``, or, on a mesh,
    :class:`~repro_torch.sharding.Sharded` by its spec (sanitized
    against the shape), each coordinate's part allocated on its
    device."""
    out = {}
    for name, leaf in shapes.items():
        if isinstance(leaf, dict):
            out[name] = zeros_tree(leaf, None if specs is None
                                   else specs[name], device, ctx)
            continue
        shape, dtype = leaf
        if ctx.mesh is None:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        sp = shd.sanitize_spec(specs[name], shape, ctx.mesh)
        lshape = shd.local_shape(shape, sp, ctx.mesh)
        out[name] = shd.Sharded(
            {c: torch.zeros(lshape, dtype=dtype,
                            device=shd.device(ctx.mesh, c))
             for c in shd.coords(ctx.mesh)}, shape, sp, ctx.mesh)
    return out


def init_cache(cfg, batch: int, max_len: int, device=None,
               ctx: ShardCtx = NO_SHARD) -> Dict[str, Any]:
    """Decode cache: ``kv`` (attention families: one slot a layer; the
    hybrid: one a group), ``ssm`` (ssm, hybrid: each layer's conv buffers
    and state) and the filled length ``len`` (a host int: the reference
    also keeps a per-layer copy for its scan, which a loop does not
    need).  On a mesh each tensor is
    :class:`~repro_torch.sharding.Sharded` by :func:`cache_specs`."""
    specs = None if ctx.mesh is None else cache_specs(cfg, ctx.rules)
    return {"len": 0, **zeros_tree(cache_shapes(cfg, batch, max_len), specs,
                                   device, ctx)}


# --------------------------------------------------------------------------
# specs (the mesh layout, by logical names)
# --------------------------------------------------------------------------
def dotted(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(dotted(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def layer_specs(cfg, s, family: Optional[str] = None) -> Dict[str, Any]:
    """One layer's specs, nested as :class:`Layer`'s parameters."""
    family = family or cfg.family
    if family in ("ssm", "hybrid"):
        return {"ln1": s(None), "mamba": mamba_specs(cfg, s)}
    p = {"ln1": s(None), "attn": attention_specs(cfg, s), "ln2": s(None)}
    if family == "moe":
        p["moe"] = moe_specs(cfg, s)
    else:
        p["mlp"] = mlp_specs(s)
    return p


def param_specs(cfg, rules) -> Dict[str, shd.Spec]:
    """Specs keyed by the module's parameter names, in its order (the
    reference's ``param_specs``, whose stacked layers add a leading
    ``None``)."""
    s = functools.partial(shd.spec, rules)
    layer = dotted(layer_specs(cfg, s))
    out = {"embed": s("vocab", "fsdp")}
    for i in range(cfg.num_layers):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out["final_norm"] = s(None)
    if not cfg.tie_embeddings:
        out["lm_head"] = s("fsdp", "vocab")
    if cfg.family == "hybrid" and cfg.attn_period:
        out.update(dotted(layer_specs(cfg, s, "dense"), "shared_attn."))
    return out


def cache_specs_kv(s) -> Dict[str, shd.Spec]:
    kv = s(None, "cache_batch", "cache_seq", "cache_heads", None)
    return {"k": kv, "v": kv}


def cache_specs(cfg, rules) -> Dict[str, Any]:
    """Specs of :func:`init_cache`'s tree (stacked on layers; the
    reference's per-layer ``len`` has no counterpart here)."""
    s = functools.partial(shd.spec, rules)
    specs: Dict[str, Any] = {"len": s()}
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        specs["kv"] = cache_specs_kv(s)
    if cfg.family in ("ssm", "hybrid"):
        specs["ssm"] = {
            "conv_x": s(None, "cache_batch", None, "ffn"),
            "conv_B": s(None, "cache_batch", None, None),
            "conv_C": s(None, "cache_batch", None, None),
            "ssm": s(None, "cache_batch", "ssm_heads", None, None)}
    return specs
