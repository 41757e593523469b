"""One superstep of R packed BFS runs as one edge pass: the CUDA kernel's
wrapper, its plain version and its launch counter.

For frontier ``f`` and visited ``v`` ([R, V, W] int32 words, a BFS a
row), one call does for every row r

    v[r] |= f[r]
    nxt[r] |= segment_or(nfa_step(g[r][obj] & Bp[r][pred], bwd[r]),
                         subj, V) & ~v[r]
    spare[r][:] = 0
    flag[0] = stamp, if that OR put a non-zero word into some nxt[r]

in place, ``nxt`` zero on entry; the edges ``subj, pred, obj`` are shared
by every row, each row has its own tables (its own automaton).  ``g``
([R, Vg, W], the frontier that ``obj`` indexes) is ``f`` itself unless
the caller passes ``gathered``: on a mesh (:mod:`repro_torch.core.
distributed`) it is the frontier gathered over every shard, ``f`` the
shard's own ``V`` rows of it and ``subj`` local to them.  So ``v``
trails the frontier by one superstep and the caller rotates three
frontier buffers: this superstep's ``nxt`` is the next one's frontier,
and its ``spare`` (the frontier before this one) the next one's ``nxt``.
The JAX package's loop state ``(f, v)`` is ``(f, v | f)`` here.

The flag holds the stamp of the last superstep that found a word, so a
caller may queue supersteps ``it + 1 .. it + k`` before it reads it: a
call made while ``flag[0] < stamp - 1`` follows a superstep that found
nothing (every frontier is empty) and changes nothing at all.  A first
superstep takes stamp 1 with the flag at 0.

The kernel is ``csrc/packed_superstep.cu`` (see the note there for what
bounds it); :mod:`repro_torch.core.dense` drives it.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import packed_superstep_ref

# launches of the CUDA kernel since the last reset (see
# ``repro_torch.kernels.reset_launch_counts``)
launches = {"packed_superstep": 0}


def _check(f, v, nxt, spare, flag, Bp, bwd, subj, pred, obj, g) -> None:
    words = (f, v, nxt, spare, Bp, bwd, g)
    if any(t.dim() != 3 for t in words) or flag.shape != (1,) or \
            any(t.dim() != 1 for t in (subj, pred, obj)):
        raise ValueError("packed_superstep wants [R, V, W] state words, "
                         "[R, L, W] and [R, S, W] tables, [E] edge ids and "
                         "a [1] flag")
    if any(t.dtype != torch.int32 for t in words + (flag, subj, pred, obj)):
        raise TypeError("packed_superstep wants int32 words, ids and flag")
    tensors = words + (flag, subj, pred, obj)
    if any(t.device != f.device for t in tensors):
        raise ValueError("packed_superstep wants every tensor on one device")
    R, V, W = f.shape
    S = bwd.shape[1]
    if any(t.shape != (R, V, W) for t in (v, nxt, spare)) or \
            g.shape[0] != R or g.shape[2] != W or \
            Bp.shape[0] != R or bwd.shape[0] != R or Bp.shape[2] != W or \
            bwd.shape[2] != W or not 1 <= S <= 32 * W:
        raise ValueError(
            f"packed_superstep shapes disagree: state {tuple(f.shape)}, "
            f"{tuple(v.shape)}, {tuple(nxt.shape)}, {tuple(spare.shape)}; "
            f"gathered {tuple(g.shape)}; "
            f"Bp {tuple(Bp.shape)}, bwd {tuple(bwd.shape)}")
    if not subj.shape == pred.shape == obj.shape:
        raise ValueError(f"packed_superstep edge ids disagree: "
                         f"{subj.shape}, {pred.shape}, {obj.shape}")
    state = {t.data_ptr() for t in (f, v, nxt, spare)}
    if len(state) != 4 and R * V * W:
        raise ValueError("packed_superstep wants four distinct state "
                         "buffers")
    if g.numel() and g.data_ptr() in {t.data_ptr() for t in (v, nxt,
                                                          spare)}:
        raise ValueError("packed_superstep's gathered frontier must not "
                         "share a buffer the pass writes")


def packed_superstep_cuda(f, v, nxt, spare, flag, stamp: int, Bp, bwd,
                          subj, pred, obj, gathered=None) -> None:
    """Launch the edge pass on the current stream: every tensor
    contiguous on one CUDA device, as the module note says.  Raises on
    anything the kernel does not take and on a refused launch."""
    g = f if gathered is None else gathered
    _check(f, v, nxt, spare, flag, Bp, bwd, subj, pred, obj, g)
    _build.check_cuda("packed_superstep_cuda", g, f, v, nxt, spare, flag,
                      Bp, bwd, subj, pred, obj)
    R, V, W = f.shape
    lib = _build.library("packed_superstep")
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = lib.packed_superstep_launch(
            g.data_ptr(), f.data_ptr(), v.data_ptr(), nxt.data_ptr(),
            spare.data_ptr(), flag.data_ptr(), int(stamp), Bp.data_ptr(),
            bwd.data_ptr(), subj.data_ptr(), pred.data_ptr(), obj.data_ptr(),
            subj.shape[0], R, V, g.shape[1], Bp.shape[1], bwd.shape[1], W,
            stream)
    _build.check_launch(rc, "packed_superstep")
    if R and max(subj.shape[0], V * W):      # else nothing was launched
        launches["packed_superstep"] += 1


def packed_superstep_plain(f, v, nxt, spare, flag, stamp: int, Bp, bwd,
                           subj, pred, obj, gathered=None) -> None:
    """The edge pass's plain PyTorch version, for CPU tensors."""
    g = f if gathered is None else gathered
    _check(f, v, nxt, spare, flag, Bp, bwd, subj, pred, obj, g)
    _build.check_cpu("packed_superstep_plain", f)
    packed_superstep_ref(f, v, nxt, spare, flag, stamp, Bp, bwd, subj,
                         pred, obj, gathered=gathered)
