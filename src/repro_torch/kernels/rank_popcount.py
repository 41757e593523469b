"""Bitvector rank over packed words: the CUDA kernels' wrappers, their
plain versions and their launch counters.

Two kernels (``csrc/rank_popcount.cu``), as in the JAX package:

  * ``superblock_popcounts``: set bits per 512-bit superblock
    (``SB_WORDS`` words).  Its directory mode (:func:`rank_directory_cuda`)
    writes the rank directory itself, a leading 0 and the prefix sum of
    the counts, in the same launch (a single-pass chained scan); it
    counts as a ``superblock_popcounts`` launch.
  * ``rank1``: ``rank1(i) = dir[i >> 9] + popcount(window(i) & mask(i))``.
    The JAX package gathers each query's window and builds its masks in
    XLA and reduces them in its ``rank_window`` kernel; here one kernel
    does all of it, a thread a query reading the window's needed 16-byte
    quarters, with the masks built in uint32 inside the kernel
    (torch's ``>>`` on int32 is arithmetic, so ``0xFFFFFFFF >> k``
    cannot be built with torch ops on the card).

Words are uint32 bit patterns in int32 tensors (see :mod:`.ref`).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import SB_WORDS, rank1_window_ref, superblock_popcounts_ref

# the directory mode's scratch, per (device, stream); see
# rank_directory_launch
_SCRATCH = _build.SeqScratch()

# launches of each CUDA kernel since the last reset (see
# ``repro_torch.kernels.reset_launch_counts``)
launches = {"superblock_popcounts": 0, "rank1": 0}


def _check_words(name: str, words: torch.Tensor) -> None:
    if words.dim() != 1 or words.shape[0] % SB_WORDS:
        raise ValueError(f"{name} wants [NW] words with NW % {SB_WORDS} "
                         f"== 0, got {tuple(words.shape)}")
    if words.dtype != torch.int32:
        raise TypeError(f"{name} wants int32 words, got {words.dtype}")


def _check_rank(words, directory, i) -> None:
    _check_words("rank1", words)
    if directory.dim() != 1 or i.dim() != 1:
        raise ValueError(f"rank1 wants a 1-D directory and 1-D offsets, got "
                         f"{tuple(directory.shape)} and {tuple(i.shape)}")
    if directory.shape[0] < 1 or words.shape[0] < SB_WORDS:
        raise ValueError("rank1 wants at least one superblock and one "
                         "directory entry")
    if directory.dtype != torch.int32 or i.dtype != torch.int32:
        raise TypeError(f"rank1 wants an int32 directory and int32 offsets, "
                        f"got {directory.dtype} and {i.dtype}")
    if not words.device == directory.device == i.device:
        raise ValueError(f"words on {words.device}, directory on "
                         f"{directory.device}, offsets on {i.device}")


def superblock_popcounts_cuda(words: torch.Tensor) -> torch.Tensor:
    """Launch on the current stream.  words: [NW] contiguous int32 words
    on a CUDA device, NW % 16 == 0 -> [NW / 16] int32."""
    _check_words("superblock_popcounts", words)
    _build.check_cuda("superblock_popcounts_cuda", words)
    NW = words.shape[0]
    out = torch.empty(NW // SB_WORDS, dtype=torch.int32, device=words.device)
    if NW == 0:
        return out
    lib = _build.library("rank_popcount")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.superblock_popcounts_launch(words.data_ptr(), out.data_ptr(),
                                             NW, stream)
    _build.check_launch(rc, "superblock_popcounts")
    launches["superblock_popcounts"] += 1
    return out


def rank_directory_cuda(words: torch.Tensor) -> torch.Tensor:
    """Launch on the current stream: the rank directory of [NW]
    contiguous int32 words on a CUDA device (NW % 16 == 0), a leading 0
    and the prefix sum of the superblock popcounts, [NW / 16 + 1] int32,
    in one launch of the popcount kernel's directory mode."""
    _check_words("superblock_popcounts", words)
    _build.check_cuda("rank_directory_cuda", words)
    NW = words.shape[0]
    out = torch.empty(NW // SB_WORDS + 1, dtype=torch.int32,
                      device=words.device)
    if NW == 0:
        return out.zero_()
    lib = _build.library("rank_popcount")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        scratch, seq = _SCRATCH.take(words.device, stream,
                                     lib.rank_directory_scratch_words(NW))
        rc = lib.rank_directory_launch(words.data_ptr(), out.data_ptr(),
                                       scratch.data_ptr(), NW, seq, stream)
    if rc != 0:
        _SCRATCH.drop(words.device, stream)
    _build.check_launch(rc, "superblock_popcounts (directory)")
    launches["superblock_popcounts"] += 1
    return out


def rank_directory_plain(words: torch.Tensor) -> torch.Tensor:
    """The directory mode's plain PyTorch version, for CPU tensors."""
    pc = superblock_popcounts_plain(words)
    return torch.cat([pc.new_zeros(1),
                      torch.cumsum(pc, dim=0, dtype=torch.int32)])


def superblock_popcounts_plain(words: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, for CPU tensors."""
    _check_words("superblock_popcounts", words)
    _build.check_cpu("superblock_popcounts_plain", words)
    return superblock_popcounts_ref(words)


def rank1_cuda(words: torch.Tensor, directory: torch.Tensor,
               i: torch.Tensor) -> torch.Tensor:
    """Launch on the current stream.  words: [NW] int32 words, directory:
    [ndir] int32, i: [Q] int32 bit offsets, all contiguous on one CUDA
    device -> [Q] int32 ranks.  Words whose address is not 16-byte
    aligned (a view at an offset) take the kernel's per-word path."""
    _check_rank(words, directory, i)
    _build.check_cuda("rank1_cuda", words, directory, i)
    Q = i.shape[0]
    out = torch.empty(Q, dtype=torch.int32, device=words.device)
    if Q == 0:
        return out
    lib = _build.library("rank_popcount")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.rank1_launch(words.data_ptr(), directory.data_ptr(),
                              i.data_ptr(), out.data_ptr(), words.shape[0],
                              directory.shape[0], Q, stream)
    _build.check_launch(rc, "rank1")
    launches["rank1"] += 1
    return out


def rank1_plain(words: torch.Tensor, directory: torch.Tensor,
                i: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, for CPU tensors."""
    _check_rank(words, directory, i)
    _build.check_cpu("rank1_plain", words)
    return rank1_window_ref(words, directory, i)

