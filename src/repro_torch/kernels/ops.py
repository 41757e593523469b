"""Public kernel entry points, the numpy <-> tensor word crossing, and
the device resolver.

A kernel entry point runs its CUDA kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor; it never falls back from one to
the other.  Engines name their device explicitly: ``"cuda"`` unless the
caller asks for ``"cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import nfa_step as _nfa


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises
    :class:`RuntimeError`; there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the kernels' "
                "plain PyTorch versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor (same bits) on ``device``."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy words (same bits), on the host."""
    return t.cpu().numpy().view(np.uint32)


def pack_bits(planes: np.ndarray) -> np.ndarray:
    """bool/int planes [..., S] -> packed uint32 [..., ceil(S/32)]."""
    planes = np.asarray(planes)
    S = planes.shape[-1]
    W = (S + 31) // 32
    pad = W * 32 - S
    p = np.pad(planes.astype(np.uint8), [(0, 0)] * (planes.ndim - 1) + [(0, pad)])
    p = p.reshape(*p.shape[:-1], W, 32)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    out = (p.astype(np.uint64) * weights).sum(axis=-1)
    return out.astype(np.uint32)


def unpack_bits(packed: np.ndarray, S: int) -> np.ndarray:
    """packed uint32 [..., W] -> planes [..., S] uint8."""
    packed = np.asarray(packed)
    W = packed.shape[-1]
    bits = (packed[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*packed.shape[:-1], W * 32)[..., :S].astype(np.uint8)


def nfa_step(X: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    """Bit-parallel reverse Glushkov step: Y = T'[X] (packed int32
    words).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if X.device.type == "cuda":
        return _nfa.nfa_step_cuda(X, bwd)
    if X.device.type == "cpu":
        return _nfa.nfa_step_plain(X, bwd)
    raise ValueError(f"nfa_step: unsupported device {X.device}")
