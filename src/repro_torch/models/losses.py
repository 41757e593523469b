"""Losses: the JAX package's ``models/losses.py``."""
from __future__ import annotations

import torch

from .. import sharding as shd


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


def softmax_xent_sharded(logits, labels, mask=None):
    """The vocab-parallel :func:`softmax_xent` on a mesh: ``logits``
    :class:`~repro_torch.sharding.Sharded` ``("batch", None, "vocab")``,
    ``labels`` (and ``mask``, 1 = count; else every position counts)
    laid out like its rows.
    Each coordinate reduces its vocab shard: the max and the sum of
    ``exp`` are all-reduced over the vocab axes, and the label logit
    comes from the shard that owns the label (the others add 0), so no
    coordinate holds more than its ``[B, T, V / model]`` f32 slice.
    Returns (mean_loss on the first coordinate's device, ntokens)."""
    mesh = logits.mesh
    vocab = shd.entry_axes(logits.spec[2])
    rows = shd.entry_axes(logits.spec[0])
    lg = {c: t.float() for c, t in logits.parts.items()}
    m = shd.all_reduce({c: t.amax(dim=-1, keepdim=True).detach()
                        for c, t in lg.items()}, mesh, vocab, "max")
    se = shd.all_reduce({c: torch.exp(t - m[c]).sum(dim=-1)
                         for c, t in lg.items()}, mesh, vocab)
    picked = {}
    for c, t in lg.items():
        Vl = t.shape[-1]
        loc = labels.parts[c].long() - shd.index(mesh, c, vocab) * Vl
        mine = (loc >= 0) & (loc < Vl)
        got = torch.gather(t, -1, loc.clamp(0, Vl - 1)[..., None])[..., 0]
        picked[c] = got.masked_fill(~mine, 0.0)
    picked = shd.all_reduce(picked, mesh, vocab)
    # one coordinate a batch shard, in shard order: each row counts once
    others = tuple(a for a in mesh.axis_names if a not in rows)
    owners = sorted((c for c in lg if shd.index(mesh, c, others) == 0),
                    key=lambda c: shd.index(mesh, c, rows))
    dev = shd.device(mesh, owners[0])
    total = count = None
    for c in owners:
        per_tok = torch.log(se[c]) + m[c][..., 0] - picked[c]
        if mask is not None:
            w = mask.parts[c].float()
            per_tok = per_tok * w
            k = w.sum().to(dev)
            count = k if count is None else count + k
        part = per_tok.sum().to(dev)
        total = part if total is None else total + part
    if mask is None:
        n = logits.shape[0] * logits.shape[1]
        return total / n, n
    n = torch.clamp(count, min=1.0)
    return total / n, n
