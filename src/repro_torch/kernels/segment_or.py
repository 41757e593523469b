"""Segment OR of packed rows (the packed BFS's frontier merge) and the
segmented OR-scan: the CUDA kernels' wrappers, their plain versions and
their launch counters.

``segment_or`` computes ``out[v] = OR of vals[e] with seg_ids[e] == v``.
The JAX package computes it on the TPU, which has no atomic scatter, as
a tile-local segmented OR-scan over rows sorted by segment
(``segmented_or_scan``, ``TILE_E`` rows a tile) plus a carry stitch and
a pick of each segment's last row.  The scan keeps a kernel of its own
here, over the whole array, for the contract the JAX package's tests
hold (its first ``TILE_E`` rows equal the TPU kernel's).

Both CUDA kernels (``csrc/segment_or.cu``) run a grid of resident blocks
over tiles of 4,096 rows, 16 consecutive rows a thread, one column at a
time; a block copies its next tile into shared memory asynchronously
while it works on the current one (16-byte chunks at W = 1; a base
address that is not 16-byte aligned, a ragged last tile or W > 1 take
the per-word path of the same kernel).

``segment_or`` is a zero fill (``torch.zeros``) and one launch of an
atomic-OR scatter.  It reads the values (4*E*W bytes) and the id of each
row with a non-zero word (at most 4*E), and writes the output (4*V*W):
a thread ORs runs of equal (id, column) keys in registers, a segmented
warp-shuffle scan joins them across threads and shared memory across
warps, and one ``atomicOr`` goes out a run.  OR does not depend on
order, so ids in any order are exact; sorted ids make the runs long,
and a hub's word takes one atomic a tile it touches instead of one a
warp (the atomics on one word serialise in L2).

``segmented_or_scan`` is one launch, one pass: blocks take tiles in the
order of an atomic ticket, publish each tile's aggregate as soon as its
rows are staged, and chain the tiles by decoupled look-back through
descriptors (one 64-bit word a tile and column: a sequence number, an
inclusive bit, the value) in a scratch kept per (device, stream)
(``_build.SeqScratch``), whose sequence numbers spare every launch a
clear.  It reads 4*E*W + 4*E bytes and writes 4*E*W.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import segment_or_ref, segmented_or_scan_ref

TILE_E = 1024  # rows per tile of the JAX package's scan kernel

# launches of each CUDA kernel since the last reset (see
# ``repro_torch.kernels.reset_launch_counts``)
launches = {"segment_or": 0, "segmented_or_scan": 0}

# the scan's descriptors and ticket counter, per (device, stream); see
# segmented_or_scan_launch
_SCRATCH = _build.SeqScratch()


def _check_vals(name: str, vals: torch.Tensor, other: torch.Tensor) -> None:
    if vals.dim() != 2 or other.dim() != 1 or other.shape[0] != vals.shape[0]:
        raise ValueError(f"{name} wants vals [E, W] and a [E] index, got "
                         f"{tuple(vals.shape)} and {tuple(other.shape)}")
    if vals.dtype != torch.int32 or other.dtype != torch.int32:
        raise TypeError(f"{name} wants int32 words and int32 ids, got "
                        f"{vals.dtype} and {other.dtype}")
    if vals.device != other.device:
        raise ValueError(f"vals on {vals.device} but ids on {other.device}")


def _check_segments(vals, seg_ids, num_segments: int) -> None:
    _check_vals("segment_or", vals, seg_ids)
    if num_segments < 0:
        raise ValueError(f"segment_or wants num_segments >= 0, got "
                         f"{num_segments}")


def segment_or_cuda(vals: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Zero the output and launch the scatter on the current stream.
    vals: [E, W] int32 words, seg_ids: [E] int32 in any order, both
    contiguous on one CUDA device -> [num_segments, W] int32 words."""
    _check_segments(vals, seg_ids, num_segments)
    _build.check_cuda("segment_or_cuda", vals, seg_ids)
    E, W = vals.shape
    out = torch.zeros((num_segments, W), dtype=torch.int32,
                      device=vals.device)
    if E * W == 0 or num_segments == 0:
        return out
    lib = _build.library("segment_or")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.segment_or_launch(vals.data_ptr(), seg_ids.data_ptr(),
                                   out.data_ptr(), E, W, num_segments, stream)
    _build.check_launch(rc, "segment_or")
    launches["segment_or"] += 1
    return out


def segment_or_plain(vals: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """The scatter's plain PyTorch version, for CPU tensors."""
    _check_segments(vals, seg_ids, num_segments)
    _build.check_cpu("segment_or_plain", vals)
    return segment_or_ref(vals, seg_ids, num_segments)


def segmented_or_scan_cuda(vals: torch.Tensor,
                           flags: torch.Tensor) -> torch.Tensor:
    """Launch the scan on the current stream.  vals: [E, W] int32 words,
    flags: [E] int32 (nonzero where a segment starts; the JAX package
    wants flags[0] = 1; row 0 starts a segment whatever its flag), both
    contiguous on one CUDA device -> [E, W] int32 words, in one launch."""
    _check_vals("segmented_or_scan", vals, flags)
    _build.check_cuda("segmented_or_scan_cuda", vals, flags)
    E, W = vals.shape
    out = torch.empty_like(vals)
    if E * W == 0:
        return out
    lib = _build.library("segment_or")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        scratch, seq = _SCRATCH.take(
            vals.device, stream, lib.segmented_or_scan_scratch_words(E, W))
        rc = lib.segmented_or_scan_launch(
            vals.data_ptr(), flags.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), E, W, seq, stream)
    if rc != 0:
        _SCRATCH.drop(vals.device, stream)
    _build.check_launch(rc, "segmented_or_scan")
    launches["segmented_or_scan"] += 1
    return out


def segmented_or_scan_plain(vals: torch.Tensor,
                            flags: torch.Tensor) -> torch.Tensor:
    """The scan's plain PyTorch version, for CPU tensors."""
    _check_vals("segmented_or_scan", vals, flags)
    _build.check_cpu("segmented_or_scan_plain", vals)
    return segmented_or_scan_ref(vals, flags)
