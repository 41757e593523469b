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


# -- bitwise helpers ----------------------------------------------------------

_BYTE_POPCOUNT = torch.tensor([bin(b).count("1") for b in range(256)],
                              dtype=torch.int64)


def popcount(values: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 value in [0, 2**32) (torch has no popcount):
    four byte lookups."""
    table = _BYTE_POPCOUNT.to(values.device)
    out = torch.zeros_like(values)
    for shift in (0, 8, 16, 24):
        out += table[(values >> shift) & 0xFF]
    return out


# -- segment OR ---------------------------------------------------------------

def segment_or_ref(vals: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """vals: [E, W] int32 words; seg_ids: [E] int32 or int64, in any order.
    out[v] = OR of vals[e] with seg_ids[e] == v, as [V, W] int32 words;
    ids outside [0, V) contribute nothing.  All-zero rows are dropped
    first (they OR nothing in), then one ``amax`` scatter per bit."""
    V, W = num_segments, vals.shape[1]
    seg = seg_ids.to(torch.int64)
    keep = (vals != 0).any(dim=1) & (seg >= 0) & (seg < V)
    x = widen(vals[keep])
    idx = seg[keep][:, None].expand(-1, W)
    out = torch.zeros((V, W), dtype=torch.int64, device=vals.device)
    for b in range(32):
        bit = torch.zeros((V, W), dtype=torch.int64, device=vals.device)
        bit.scatter_reduce_(0, idx, (x >> b) & 1, "amax")
        out |= bit << b
    return narrow(out)


def segmented_or_scan_ref(vals: torch.Tensor,
                          flags: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented OR-scan over the whole array (no tiles).
    vals: [E, W] int32 words; flags: [E], nonzero where a segment starts.
    Row e is the OR of rows s..e, s being the last start at or before e
    (row 0 if none).  Per bit: a running count of set bits, less the
    count before the segment's start, is positive iff some row set it."""
    E, W = vals.shape
    x = widen(vals)
    pos = torch.arange(E, device=vals.device)
    start = torch.cummax(torch.where(flags != 0, pos, 0), dim=0).values \
        if E else pos
    out = torch.zeros_like(x)
    for b in range(32):
        run = torch.cumsum((x >> b) & 1, dim=0)
        before = torch.where((start > 0)[:, None], run[start - 1], 0)
        out |= ((run - before) > 0).to(torch.int64) << b
    return narrow(out)


# -- packed BFS superstep ----------------------------------------------------

def packed_superstep_ref(f: torch.Tensor, v: torch.Tensor, nxt: torch.Tensor,
                         spare: torch.Tensor, flag: torch.Tensor, stamp: int,
                         Bp: torch.Tensor, bwd: torch.Tensor,
                         subj: torch.Tensor, pred: torch.Tensor,
                         obj: torch.Tensor,
                         gathered: torch.Tensor = None) -> None:
    """One packed BFS superstep of R rows, in place (see
    ``kernels/packed_superstep.py``): per row the gathers, the transition
    of :func:`nfa_step_ref` with the row's own table, :func:`segment_or_ref`
    (over ids ``r * V + subj``, one segment per row and node) and the
    and-not.  f, v, nxt, spare: [R, V, W] int32 words, nxt zero on entry;
    flag: [1] int32; Bp [R, L, W], bwd [R, S, W] int32 words; subj, pred,
    obj: [E] int32 ids in range; ``gathered`` [R, Vg, W], the frontier
    ``obj`` indexes (``f`` when ``None``).  Nothing changes while
    ``flag[0] < stamp - 1``."""
    if int(flag[0]) < stamp - 1:
        return
    R, V, W = f.shape
    S = bwd.shape[1]
    g = f if gathered is None else gathered
    rows = torch.arange(R, device=f.device)[:, None]
    X = g[:, obj] & Bp[rows, pred[None, :]]               # [R, E, W]
    r_idx, e_idx = (X != 0).any(dim=2).nonzero(as_tuple=True)
    x = widen(X[r_idx, e_idx])                             # live (row, edge)
    b = widen(bwd)
    Y = torch.zeros_like(x)
    for j in range(S):
        w, k = divmod(j, 32)
        bit = (x[:, w] >> k) & 1
        Y |= (-bit)[:, None] & b[r_idx, j]
    seg = r_idx * V + subj[e_idx].to(torch.int64)
    v |= f
    new = segment_or_ref(narrow(Y), seg, R * V).reshape(R, V, W) & ~v
    nxt |= new
    spare.zero_()
    if bool((new != 0).any()):
        flag.fill_(stamp)


# -- rank -----------------------------------------------------------------------

SB_WORDS = 16  # 16 x 32-bit words = 512-bit superblocks


def superblock_popcounts_ref(words: torch.Tensor,
                             sb_words: int = SB_WORDS) -> torch.Tensor:
    """words: [NW] int32 words, NW % sb_words == 0 -> [NW / sb_words]
    int32 set bits per superblock."""
    return popcount(widen(words)).reshape(-1, sb_words).sum(dim=1) \
        .to(torch.int32)


def rank_window_ref(windows: torch.Tensor, masks: torch.Tensor,
                    bases: torch.Tensor) -> torch.Tensor:
    """windows, masks: [Q, 16] int32 words; bases: [Q] int32 ->
    bases + set bits of (windows & masks) per row, int32."""
    pc = popcount(widen(windows) & widen(masks)).sum(dim=1)
    return (bases.to(torch.int64) + pc).to(torch.int32)


def rank1_window_ref(words: torch.Tensor, directory: torch.Tensor,
                     i: torch.Tensor) -> torch.Tensor:
    """The rank kernel's function: directory[i >> 9] plus the masked
    popcount of the query's 16-word superblock window.  words: [NW] int32
    words; directory: [NW/16 + 1] int32; i: [Q] int32 bit offsets ->
    [Q] int32.  Word and directory indices are clamped into their
    arrays, as the JAX package's gathers clamp."""
    i64 = i.to(torch.int64)
    sb = i64 >> 9
    widx = sb[:, None] * SB_WORDS + torch.arange(SB_WORDS,
                                                 device=words.device)
    windows = words[widx.clamp(0, words.shape[0] - 1)]
    # masks: all ones below the query's word, its low i & 31 bits in it
    # (none when that is 0), nothing above
    rel = (i64 >> 5)[:, None] - widx
    partial = (1 << (i64 & 31)[:, None]) - 1
    masks = torch.where(rel > 0, WORD_MASK, torch.where(rel == 0, partial, 0))
    bases = directory[sb.clamp(0, directory.shape[0] - 1)]
    return rank_window_ref(windows, narrow(masks), bases)


def rank1_ref(words: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """End-to-end rank1: set bits in [0, i) from a global prefix sum, no
    directory and no window.  words: [NW] int32; i: [Q] int32 -> [Q]
    int32."""
    i64 = i.to(torch.int64)
    pc = popcount(widen(words))
    cum = torch.cat([pc.new_zeros(1), torch.cumsum(pc, dim=0)])
    wq = i64 >> 5
    partial = (1 << (i64 & 31)) - 1
    word = widen(words[wq.clamp(0, words.shape[0] - 1)])
    return (cum[wq.clamp(0, words.shape[0])] + popcount(word & partial)) \
        .to(torch.int32)
