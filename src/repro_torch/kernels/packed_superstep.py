"""One superstep of the packed BFS as one edge pass: the CUDA kernel's
wrapper, its plain version and its launch counter.

For frontier ``f`` and visited ``v`` ([V, W] int32 words), one call

    v |= f
    nxt |= segment_or(nfa_step(f[obj] & Bp[pred], bwd), subj, V) & ~v
    spare[:] = 0
    flag[0] = stamp, if that OR put a non-zero word into nxt

in place, ``nxt`` zero on entry.  So ``v`` trails the frontier by one
superstep and the caller rotates three frontier buffers: this superstep's
``nxt`` is the next one's frontier, and its ``spare`` (the frontier
before this one) the next one's ``nxt``.  The JAX package's loop state
``(f, v)`` is ``(f, v | f)`` here.  The kernel is
``csrc/packed_superstep.cu`` (see the note there for what bounds it);
:mod:`repro_torch.core.packed` drives it.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import packed_superstep_ref

# launches of the CUDA kernel since the last reset (see
# ``repro_torch.kernels.reset_launch_counts``)
launches = {"packed_superstep": 0}


def _check(f, v, nxt, spare, flag, Bp, bwd, subj, pred, obj) -> None:
    words = (f, v, nxt, spare, Bp, bwd)
    if any(t.dim() != 2 for t in words) or flag.shape != (1,) or \
            any(t.dim() != 1 for t in (subj, pred, obj)):
        raise ValueError("packed_superstep wants [V, W] state words, [L, W] "
                         "and [S, W] tables, [E] edge ids and a [1] flag")
    if any(t.dtype != torch.int32 for t in words + (flag, subj, pred, obj)):
        raise TypeError("packed_superstep wants int32 words, ids and flag")
    tensors = words + (flag, subj, pred, obj)
    if any(t.device != f.device for t in tensors):
        raise ValueError("packed_superstep wants every tensor on one device")
    V, W = f.shape
    S = bwd.shape[0]
    if any(t.shape != (V, W) for t in (v, nxt, spare)) or \
            Bp.shape[1] != W or bwd.shape[1] != W or not 1 <= S <= 32 * W:
        raise ValueError(
            f"packed_superstep shapes disagree: state {tuple(f.shape)}, "
            f"{tuple(v.shape)}, {tuple(nxt.shape)}, {tuple(spare.shape)}; "
            f"Bp {tuple(Bp.shape)}, bwd {tuple(bwd.shape)}")
    if not subj.shape == pred.shape == obj.shape:
        raise ValueError(f"packed_superstep edge ids disagree: "
                         f"{subj.shape}, {pred.shape}, {obj.shape}")
    state = {t.data_ptr() for t in (f, v, nxt, spare)}
    if len(state) != 4 and V * W:
        raise ValueError("packed_superstep wants four distinct state "
                         "buffers")


def packed_superstep_cuda(f, v, nxt, spare, flag, stamp: int, Bp, bwd,
                          subj, pred, obj) -> None:
    """Launch the edge pass on the current stream: every tensor
    contiguous on one CUDA device, as the module note says.  Raises on
    anything the kernel does not take and on a refused launch."""
    _check(f, v, nxt, spare, flag, Bp, bwd, subj, pred, obj)
    _build.check_cuda("packed_superstep_cuda", f, v, nxt, spare, flag, Bp,
                      bwd, subj, pred, obj)
    V, W = f.shape
    lib = _build.library("packed_superstep")
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = lib.packed_superstep_launch(
            f.data_ptr(), v.data_ptr(), nxt.data_ptr(), spare.data_ptr(),
            flag.data_ptr(), int(stamp), Bp.data_ptr(), bwd.data_ptr(),
            subj.data_ptr(), pred.data_ptr(), obj.data_ptr(),
            subj.shape[0], V, Bp.shape[0], bwd.shape[0], W, stream)
    _build.check_launch(rc, "packed_superstep")
    if max(subj.shape[0], V * W):        # else nothing was launched
        launches["packed_superstep"] += 1


def packed_superstep_plain(f, v, nxt, spare, flag, stamp: int, Bp, bwd,
                           subj, pred, obj) -> None:
    """The edge pass's plain PyTorch version, for CPU tensors."""
    _check(f, v, nxt, spare, flag, Bp, bwd, subj, pred, obj)
    _build.check_cpu("packed_superstep_plain", f)
    packed_superstep_ref(f, v, nxt, spare, flag, stamp, Bp, bwd, subj,
                         pred, obj)
