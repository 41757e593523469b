"""Mamba2 (SSD, state-space duality) blocks, the JAX package's
``models/ssm.py``: the chunked scan for training and prefill, the O(1)
recurrence for decode.

Recurrence per head h (state N, head dim P):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t ⊗ x_t ;   y_t = C_t · h_t + D x_t

The chunked algorithm (arXiv:2405.21060) is a quadratic intra-chunk term
plus a state carried from chunk to chunk; the reference's ``lax.scan``
over chunks is a Python loop here, in f32 as there.  n_groups = 1 (B, C
shared across heads).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import init_dense, rms_norm, silu
from .layers import NEG_INF


class Mamba(nn.Module):
    """``wz``/``wx [d, d_inner]``, ``wB``/``wC [d, N]``, ``wdt [d, H]``,
    ``dt_bias``, ``A_log``, ``D [H]``, the depthwise convolutions
    ``conv_x [W, d_inner]``, ``conv_B``/``conv_C [W, N]``, the gated norm
    ``norm [d_inner]`` and ``wo [d_inner, d]``."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        d, di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.conv_width)

        def dense(shape, fan_in):
            return nn.Parameter(init_dense(gen, shape, fan_in, device))

        self.wz = dense((d, di), d)
        self.wx = dense((d, di), d)
        self.wB = dense((d, N), d)
        self.wC = dense((d, N), d)
        self.wdt = dense((d, H), d)
        self.dt_bias = nn.Parameter(torch.zeros(H, device=device))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, device=device)))
        self.D = nn.Parameter(torch.ones(H, device=device))
        self.conv_x = dense((W, di), W)
        self.conv_B = dense((W, N), W)
        self.conv_C = dense((W, N), W)
        self.norm = nn.Parameter(torch.zeros(di, device=device))
        self.wo = dense((di, d), di)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: [B, T, C]; w: [W, C].  ``state``:
    [B, W-1, C] rolling buffer (decode) or None (train).  The W products
    are summed in x's dtype, in the reference's order.  Returns
    (y [B,T,C], new_state)."""
    Wd = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, Wd - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(Wd))
    new_state = xp[:, -(Wd - 1):, :] if Wd > 1 else None
    return y, new_state


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """x: [B,T,H,P]; dt: [B,T,H] (post-softplus); A: [H] (<0);
    Bm, Cm: [B,T,N].  Returns (y [B,T,H,P] f32, final_state [B,H,N,P]
    f32)."""
    B_, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-T // chunk)
    pad = nc * chunk - T
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S = (torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc = x[:, sl].float(), dt[:, sl].float()
        Bc, Cc = Bm[:, sl].float(), Cm[:, sl].float()
        dA = dtc * A[None, None, :]                           # [B,q,H]
        cum = torch.cumsum(dA, dim=1)                         # [B,q,H]
        # intra-chunk:  Y[i] = sum_{j<=i} (C_i.B_j) e^{cum_i-cum_j} dt_j x_j
        # the exponent is masked BEFORE exp: exp(+large) in the dead
        # triangle would poison the gradients through the where
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # [B,i,j,H]
        diff = torch.where(tri[None, :, :, None], diff,
                           torch.full((), NEG_INF, device=x.device))
        L = torch.exp(diff)
        sc = torch.einsum("bin,bjn->bij", Cc, Bc)             # [B,i,j]
        M = sc[..., None] * L                                 # [B,i,j,H]
        xw = xc * dtc[..., None]                              # [B,j,H,P]
        y_intra = torch.einsum("bijh,bjhp->bihp", M, xw)
        # inter-chunk: the carried state
        y_inter = torch.einsum("bin,bhnp->bihp", Cc, S) \
            * torch.exp(cum)[..., None]
        # chunk-local end state + decay of the carried state
        decay_end = torch.exp(cum[:, -1:, :] - cum)           # [B,j,H]
        S_loc = torch.einsum("bjn,bjh,bjhp->bhnp", Bc, decay_end * dtc, xc)
        S = S * torch.exp(cum[:, -1, :])[:, :, None, None] + S_loc
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :T]
    return y, S


def mamba_specs(cfg, s):
    """Specs of a mamba layer's weights by logical names, the reference's
    table: ``wz``/``wx`` column-parallel on ``ffn`` (``d_inner``), ``wo``
    row-parallel, ``conv_x`` and ``norm`` split alike; the rest whole
    (``wB``, ``wC``, ``wdt`` on ``fsdp`` only)."""
    return {
        "wz": s("fsdp", "ffn"), "wx": s("fsdp", "ffn"),
        "wB": s("fsdp", None), "wC": s("fsdp", None),
        "wdt": s("fsdp", None), "dt_bias": s(None),
        "A_log": s(None), "D": s(None),
        "conv_x": s(None, "ffn"), "conv_B": s(None, None),
        "conv_C": s(None, None),
        "norm": s("ffn"), "wo": s("ffn", "fsdp"),
    }


def mamba_mix(p: Dict[str, torch.Tensor], x, cfg,
              state: Optional[Dict[str, torch.Tensor]] = None,
              heads: Optional[Tuple[int, int]] = None):
    """The mamba block up to its gated norm.  x: [B, T, d].  ``p``: the
    layer's mamba weights in bf16; with ``heads`` = (h0, h1), ``wz``,
    ``wx`` and ``conv_x`` hold those SSM heads' columns only (a mesh
    coordinate's), and the head-wise ``dt``, ``dt_bias``, ``A_log``, ``D``
    are sliced to them.  ``state``: None (train, from zero) or dict
    (``conv_x``/``conv_B``/``conv_C`` rolling buffers, ``ssm`` [B,H,N,P]
    f32, those heads').  Returns (``y * silu(z)`` [B, T, H*P] f32,
    new_state)."""
    B, T, d = x.shape
    P = cfg.ssm_headdim
    bf, f32 = torch.bfloat16, torch.float32
    xb = x.to(bf)
    z = torch.matmul(xb, p["wz"])
    xi = torch.matmul(xb, p["wx"])
    Bm = torch.matmul(xb, p["wB"])
    Cm = torch.matmul(xb, p["wC"])
    dt = torch.matmul(xb, p["wdt"])
    A_log, dt_bias, D = p["A_log"], p["dt_bias"], p["D"]
    if heads is not None:
        h0, h1 = heads
        dt, A_log, dt_bias, D = (dt[..., h0:h1], A_log[h0:h1],
                                 dt_bias[h0:h1], D[h0:h1])
    H = xi.shape[-1] // P

    decoding = state is not None
    xi, ncx = _causal_conv(xi, p["conv_x"].to(xi.dtype),
                           state["conv_x"] if decoding else None)
    Bm, ncB = _causal_conv(Bm, p["conv_B"].to(Bm.dtype),
                           state["conv_B"] if decoding else None)
    Cm, ncC = _causal_conv(Cm, p["conv_C"].to(Cm.dtype),
                           state["conv_C"] if decoding else None)
    xi, Bm, Cm = silu(xi), silu(Bm), silu(Cm)

    A = -torch.exp(A_log.to(f32))
    dt = F.softplus(dt.to(f32) + dt_bias.to(f32)[None, None, :])
    xh = xi.reshape(B, T, H, P)

    if decoding and T == 1:
        # O(1) recurrent update
        S = state["ssm"].to(f32)                              # [B,H,N,P]
        dA = torch.exp(dt[:, 0, :] * A[None, :])              # [B,H]
        upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].to(f32), dt[:, 0],
                           xh[:, 0].to(f32))
        S_new = S * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(f32), S_new)[:, None]
    else:
        y, S_new = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                state["ssm"] if decoding else None)
    new_state = {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC, "ssm": S_new}
    y = y + xh.to(f32) * D.to(f32)[None, None, :, None]
    y = y.reshape(B, T, H * P)
    return y * silu(z.to(f32)), new_state


def mamba_out(p: Dict[str, torch.Tensor], y, cfg, sumsq=None):
    """The gated rms norm over ``d_inner``, then ``wo``: bf16 [B, T, d].
    ``sumsq``: the sum of ``y``'s squares over the whole ``d_inner``
    ([B, T, 1] f32) when ``y`` holds only some heads' columns (a mesh
    coordinate's, its ``norm`` and ``wo`` rows alike): the output is
    then that coordinate's partial sum."""
    if sumsq is None:
        y = rms_norm(y, p["norm"], cfg.norm_eps)
    else:
        scale = torch.rsqrt(sumsq / cfg.d_inner + cfg.norm_eps).to(y.dtype)
        y = y * scale * (1.0 + p["norm"]).to(y.dtype)
    return torch.matmul(y.to(torch.bfloat16), p["wo"])
