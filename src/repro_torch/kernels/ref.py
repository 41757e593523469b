"""Plain PyTorch versions of the port's kernels (exact ground truth).

Word convention: packed state words are uint32 bit patterns carried in
``int32`` tensors (``arr.view(np.int32)`` on the way in,
``.view(np.uint32)`` on the way out).  The CPU build of torch has no
shifts or bitwise-not on ``uint32``, so the plain versions widen to
``int64``, mask to 32 bits, and narrow back to the int32 bit pattern.
"""
from __future__ import annotations

import torch

WORD_MASK = 0xFFFFFFFF


def widen(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & WORD_MASK


def narrow(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return torch.where(values > 0x7FFFFFFF, values - (1 << 32),
                       values).to(torch.int32)


def nfa_step_ref(X: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    """X: [N, W] int32 words; bwd: [S, W] int32 words, S <= 32 * W.
    Y[n] = OR_{j < S : bit j of X[n]} bwd[j], as [N, W] int32 words."""
    N, W = X.shape
    S = bwd.shape[0]
    x = widen(X)
    b = widen(bwd)
    Y = torch.zeros((N, W), dtype=torch.int64, device=X.device)
    for j in range(S):
        w, k = divmod(j, 32)
        bit = (x[:, w] >> k) & 1                  # [N] in {0, 1}
        Y |= (-bit)[:, None] & b[j][None, :]      # -1 is all ones in int64
    return narrow(Y)
