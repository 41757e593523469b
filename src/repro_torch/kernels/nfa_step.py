"""Bit-parallel Glushkov backward step: the CUDA kernel's wrapper, its
plain version, and the block-diagonal table packer.

Computes, for a batch of already-label-masked state words X (Fact 1:
X = D & B[p] happens upstream), the reverse transition

    Y[t] = T'[X[t]] = OR_{j : bit j set in X[t]}  PRED[j]

where PRED[j] is the packed predecessor mask of NFA state j (paper
Eq. 2).  The kernel itself is ``csrc/nfa_step.cu`` (one thread per
task row, walking the row's set bits; see the note there for what
bounds it).

Heterogeneous batches: one launch serves tasks from *different*
automata when their PRED tables are packed block-diagonally
(:func:`pack_block_diagonal`).  Plan i's states occupy bit range
[offset_i, offset_i + S_i); a plan-local mask shifted by its offset only
ever selects rows of its own block, and those rows only set bits inside
the block, so per-plan semantics are preserved exactly while the batch
mixes plans freely.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import _build
from .ref import nfa_step_ref

# launches of the CUDA kernel since the last reset (see
# ``repro_torch.kernels.reset_launch_counts``)
launches = 0


def _check(X: torch.Tensor, bwd: torch.Tensor) -> None:
    if X.dim() != 2 or bwd.dim() != 2:
        raise ValueError(f"nfa_step wants 2-D X and bwd, got "
                         f"{tuple(X.shape)} and {tuple(bwd.shape)}")
    if X.dtype != torch.int32 or bwd.dtype != torch.int32:
        raise TypeError(f"nfa_step wants int32 words, got {X.dtype} "
                        f"and {bwd.dtype}")
    if X.device != bwd.device:
        raise ValueError(f"X on {X.device} but bwd on {bwd.device}")
    N, W = X.shape
    S, Wb = bwd.shape
    if Wb != W or not 1 <= S <= 32 * W:
        raise ValueError(f"nfa_step shapes disagree: X [{N}, {W}], "
                         f"bwd [{S}, {Wb}]")


def nfa_step_cuda(X: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  X: [N, W] and
    bwd: [S, W] contiguous int32 words on one CUDA device.  Raises on
    anything the kernel does not take and on a refused launch."""
    global launches
    _check(X, bwd)
    if X.device.type != "cuda":
        raise ValueError(f"nfa_step_cuda wants CUDA tensors, got {X.device}")
    if not (X.is_contiguous() and bwd.is_contiguous()):
        raise ValueError("nfa_step_cuda wants contiguous X and bwd")
    N, W = X.shape
    Y = torch.empty_like(X)
    if N == 0:
        return Y
    lib = _build.library("nfa_step")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.nfa_step_launch(X.data_ptr(), bwd.data_ptr(), Y.data_ptr(),
                                 N, bwd.shape[0], W, stream)
    if rc != 0:
        raise RuntimeError(f"nfa_step launch failed: cudaError {rc}")
    launches += 1
    return Y


def nfa_step_plain(X: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, for CPU tensors."""
    _check(X, bwd)
    if X.device.type != "cpu":
        raise ValueError(f"nfa_step_plain runs on CPU tensors, got "
                         f"{X.device}")
    return nfa_step_ref(X, bwd)


def pack_block_diagonal(
    pred_masks: Sequence[Sequence[int]],
    offsets: Sequence[int],
    S_total: int,
) -> np.ndarray:
    """Pack several automata's predecessor masks into one block-diagonal
    ``bwd`` operand for :func:`nfa_step_cuda`.

    ``pred_masks[i][j]`` is plan i's (Python-int) predecessor mask of
    state j; plan i's block starts at bit ``offsets[i]``.  Returns uint32
    [S_total, W_total] where row ``offsets[i] + j`` holds
    ``pred_masks[i][j] << offsets[i]`` — i.e. both the row index and the
    mask bits are lifted into bundle space, so ``T'`` applied to a
    shifted task mask stays confined to its plan's block.
    """
    W = (S_total + 31) // 32
    out = np.zeros((S_total, W), dtype=np.uint32)
    for masks, off in zip(pred_masks, offsets):
        for j, m in enumerate(masks):
            shifted = int(m) << off
            for w in range(W):
                word = (shifted >> (32 * w)) & 0xFFFFFFFF
                if word:
                    out[off + j, w] = word
    return out
