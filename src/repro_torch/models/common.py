"""Shared model utilities: the shard context, norms, rope, inits — the
JAX package's ``models/common.py``.

The casts are the reference's, written out: torch rounds after every
op, so each ``astype`` of the reference is an explicit ``.to(dtype)``
here and nothing is left to ``autocast``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import sharding as shd


@dataclass
class ShardCtx:
    """Carries (mesh, logical rules).  With a mesh, the model runs on
    every coordinate of it (``repro_torch.sharding``): ``ctx.axes(name,
    size)`` names the mesh axes a logical dimension of ``size`` is split
    over, and ``ctx.local(tensor, *names)`` lays a global tensor out by
    logical names.  ``NO_SHARD`` (no mesh) is the one-device path."""

    mesh: Optional[object] = None
    rules: Optional[dict] = None

    def axes(self, name: Optional[str], size: int) -> Tuple[str, ...]:
        """The mesh axes logical ``name`` maps to, () when the rules
        replicate it or its axes do not divide ``size``."""
        if name is None or self.mesh is None:
            return ()
        return shd.entry_axes(shd.sanitize_spec(
            shd.spec(self.rules, name), (size,), self.mesh)[0])

    def spec(self, shape: Sequence[int], *names: Optional[str]) -> shd.Spec:
        """The sanitized spec of a tensor of ``shape`` with logical
        ``names``."""
        return shd.sanitize_spec(shd.spec(self.rules, *names), shape,
                                 self.mesh)

    def local(self, x, *names: Optional[str]) -> shd.Sharded:
        """``x`` laid out by logical ``names``: a global tensor is
        sharded, a :class:`~repro_torch.sharding.Sharded` one must
        already have that layout."""
        sp = self.spec(x.shape, *names)
        if isinstance(x, shd.Sharded):
            if x.spec != sp:
                raise ValueError(f"input laid out as {x.spec}, not {sp}")
            return x
        return shd.shard(x, self.mesh, sp)

    def parts(self, x, *names: Optional[str]) -> shd.Local:
        """Each coordinate's part of ``x`` laid out by logical ``names``
        (:meth:`local`); off the mesh, ``x`` is the one part of the one
        coordinate ``()``."""
        if self.mesh is None:
            return {(): x}
        return self.local(x, *names).parts


NO_SHARD = ShardCtx()


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


def new_generator(seed: int, device) -> Optional[torch.Generator]:
    """The init's generator on ``device``; ``None`` on the meta device,
    which holds shapes only (the dry run's parameter structs)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def init_dense(gen: Optional[torch.Generator], shape: Sequence[int],
               fan_in=None, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal with std ``1/sqrt(fan_in)`` (``fan_in`` defaults to
    ``shape[0]``), drawn from ``gen`` on ``device``; with no generator
    (the meta device) an empty tensor of that shape, nothing drawn."""
    if gen is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / np.sqrt(fan_in)
    return (torch.randn(tuple(shape), generator=gen, device=device)
            * std).to(dtype)
