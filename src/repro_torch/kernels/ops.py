"""Public kernel entry points, the numpy <-> tensor word crossing, and
the device resolver.

A kernel entry point runs its CUDA kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor; it never falls back from one to
the other, and it raises on a tensor of any other device (a ``meta``
tensor included: no kernel has a meta implementation).  Engines name
their device explicitly: ``"cuda"`` unless the caller asks for ``"cpu"``;
the dry run (``launch/dryrun.py``) names ``"meta"``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import nfa_step as _nfa
from . import packed_superstep as _sup
from . import rank_popcount as _rank
from . import ref as _ref
from . import segment_or as _seg


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises
    :class:`RuntimeError`; there is no silent CPU fallback.  ``"meta"``
    (shapes and dtypes, no storage: the dry run's) is taken only when it
    is named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the kernels' "
                "plain PyTorch versions on the host")
    elif dev.type not in ("cpu", "meta"):
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


def planes_to_words(planes: torch.Tensor) -> torch.Tensor:
    """0/1 planes [..., S] (any integer dtype) -> packed int32 words
    [..., ceil(S/32)] on their device: bit i of word w is plane 32w + i
    (:func:`pack_bits`'s layout).  One pass a plane, so the temporaries
    stay the size of the words."""
    S = planes.shape[-1]
    out = torch.zeros((*planes.shape[:-1], (S + 31) // 32),
                      dtype=torch.int64, device=planes.device)
    for i in range(S):
        out[..., i // 32] |= (planes[..., i] != 0).to(torch.int64) << (i & 31)
    return _ref.narrow(out)


def words_to_planes(words: torch.Tensor, S: int) -> torch.Tensor:
    """Packed int32 words [..., W] -> int8 planes [..., S] on their
    device (:func:`unpack_bits`'s layout)."""
    wide = _ref.widen(words)
    out = torch.empty((*words.shape[:-1], S), dtype=torch.int8,
                      device=words.device)
    for i in range(S):
        out[..., i] = (wide[..., i // 32] >> (i & 31)) & 1
    return out


def _route(name: str, cuda, plain, t: torch.Tensor):
    """The kernel for a CUDA tensor, the plain version for a CPU one; any
    other device raises (a meta tensor has no kernel to run)."""
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no kernel runs on a {t.device.type} tensor "
                     "(only cuda, or cpu for the plain version)")


def nfa_step(X: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    """Bit-parallel reverse Glushkov step: Y = T'[X] (packed int32
    words).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    return _route("nfa_step", _nfa.nfa_step_cuda, _nfa.nfa_step_plain,
                  X)(X, bwd)


def segment_or(vals: torch.Tensor, seg_ids: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Scatter-OR of packed rows: out[v] = OR of vals[e] with
    seg_ids[e] == v, as [num_segments, W] int32 words.  vals [E, W] and
    seg_ids [E] are int32; unlike the JAX package's, ids need not be
    sorted."""
    return _route("segment_or", _seg.segment_or_cuda, _seg.segment_or_plain,
                  vals)(vals, seg_ids, num_segments)


def packed_superstep(f: torch.Tensor, v: torch.Tensor, nxt: torch.Tensor,
                     spare: torch.Tensor, flag: torch.Tensor, stamp: int,
                     Bp: torch.Tensor, bwd: torch.Tensor,
                     layout: _sup.GroupedEdges,
                     scratch: _sup.SuperstepScratch,
                     gathered: torch.Tensor = None) -> None:
    """One superstep of R packed BFS runs, in place: per row r,
    ``v[r] |= f[r]``, then ``nxt[r] |= segment_or(nfa_step(g[r][obj] &
    Bp[r][pred], bwd[r]), subj, V) & ~v[r]`` (nxt zero on entry),
    ``spare`` zeroed, and ``flag[0] = stamp`` if that put a non-zero word
    into some nxt row.  f, v, nxt, spare: four [R, V, W] int32 word
    buffers; Bp [R, L, W], bwd [R, S, W]; ``layout`` the edges grouped
    by object (``kernels/packed_superstep.py`` ``group_by_object``),
    shared by the rows; ``scratch`` the worklist of this BFS (its
    ``new_scratch``); flag [1] int32.  ``g`` is ``gathered`` [R, Vg, W]
    when given (a shard's superstep reads the frontier gathered over the
    mesh; its ``subj`` is local to its ``V`` rows), else ``f``.  A call changes nothing while
    ``flag[0] < stamp - 1`` (the superstep before found nothing).  See
    ``kernels/packed_superstep.py`` for the buffer rotation a caller
    runs."""
    _route("packed_superstep", _sup.packed_superstep_cuda,
           _sup.packed_superstep_plain, f)(f, v, nxt, spare, flag, stamp,
                                           Bp, bwd, layout, scratch,
                                           gathered=gathered)


def segmented_or_scan(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented OR-scan of [E, W] int32 words over the whole
    array; flags [E] int32 are nonzero at segment starts."""
    return _route("segmented_or_scan", _seg.segmented_or_scan_cuda,
                  _seg.segmented_or_scan_plain, vals)(vals, flags)


def superblock_popcounts(words: torch.Tensor) -> torch.Tensor:
    """Set bits per 512-bit superblock of [NW] int32 words (NW % 16 == 0)
    -> [NW / 16] int32."""
    return _route("superblock_popcounts", _rank.superblock_popcounts_cuda,
                  _rank.superblock_popcounts_plain, words)(words)


def build_rank_directory(words: torch.Tensor) -> torch.Tensor:
    """Rank directory of [NW] int32 words: a leading 0, then the prefix
    sum of the superblock popcounts, [NW / 16 + 1] int32.  On the card
    one launch of the popcount kernel's directory mode (the first call
    on a stream, or at a larger size, also clears its new scratch); on
    the host the plain popcounts, ``cumsum`` and ``cat``."""
    return _route("superblock_popcounts", _rank.rank_directory_cuda,
                  _rank.rank_directory_plain, words)(words)


def rank1(words: torch.Tensor, directory: torch.Tensor,
          i: torch.Tensor) -> torch.Tensor:
    """Batched rank1 over a packed bitvector: the set bits in [0, i) for
    each int32 bit offset of ``i`` [Q], from [NW] int32 words and their
    directory (:func:`build_rank_directory`) -> [Q] int32."""
    return _route("rank1", _rank.rank1_cuda, _rank.rank1_plain,
                  words)(words, directory, i)
