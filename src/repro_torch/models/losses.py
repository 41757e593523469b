"""Losses: the JAX package's ``models/losses.py``."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """logits: [B, T, V]; labels: [B, T] int; mask: [B, T] (1 = count).
    Returns (mean_loss, ntokens).  A stop-gradient max, then lse minus the
    label logit; without a mask the mean runs over every position, pad
    included.  The label logit is a ``gather``: it selects the same value
    the reference's iota-compare-select-sum does."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    shifted = lg - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    label_logit = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    per_tok = lse - label_logit
    if mask is None:
        return per_tok.mean(), per_tok.numel()
    mask = mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return (per_tok * mask).sum() / n, n
