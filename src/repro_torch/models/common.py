"""Shared model utilities: norms, rope, inits.

The JAX package's ``models/common.py`` without its ``ShardCtx``: this
package runs the LM on one device (the mesh counterpart comes with a
port of ``sharding.py``).  The casts are the reference's, written out:
torch rounds after every op, so each ``astype`` of the reference is an
explicit ``.to(dtype)`` here and nothing is left to ``autocast``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """Variance reduction in f32; the elementwise scale applies in the
    compute dtype, the weight as ``(1 + w)``."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + w).to(x.dtype)


class Logistic(torch.autograd.Function):
    """The JAX package's ``lax.logistic``: ``1 / (1 + exp(-x))`` in x's
    dtype, each of the four ops rounded to it (JAX lowers the primitive
    so on every backend; ``torch.sigmoid`` rounds once, which moves
    about a third of bf16 results by an ulp), and its derivative
    ``g * (ans * logistic(-x))``, the primitive's own rule."""

    @staticmethod
    def forward(ctx, x):
        ans = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        x, ans = ctx.saved_tensors
        return g * (ans * (1.0 / (1.0 + torch.exp(x))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * logistic(x)`` in x's dtype."""
    return x * Logistic.apply(x)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                dtype: torch.dtype):
    """(cos, sin) ``[..., T, 1, Dh/2]`` in ``dtype``: angles in f32 from
    ``positions [..., T]``.  A forward computes them once for every
    layer."""
    freqs = torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)) \
        .to(positions.device)
    ang = positions[..., :, None].float() * freqs          # [..., T, Dh/2]
    return (torch.cos(ang)[..., :, None, :].to(dtype),
            torch.sin(ang)[..., :, None, :].to(dtype))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [..., T, H, Dh]; the two halves are split, not interleaved."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., T, H, Dh]; positions: [..., T].  Angles in f32, rotation in
    the compute dtype."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, x.dtype))


def init_dense(gen: torch.Generator, shape: Sequence[int], fan_in=None,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """Normal with std ``1/sqrt(fan_in)`` (``fan_in`` defaults to
    ``shape[0]``), drawn from ``gen`` on ``device``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / np.sqrt(fan_in)
    return (torch.randn(tuple(shape), generator=gen, device=device)
            * std).to(dtype)
