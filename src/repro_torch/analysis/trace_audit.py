"""Run-time invariant audit (layer 1 of the static analyzer), for the port.

The JAX package lowers its hot entry points against abstract shapes and
walks the jaxprs and HLO.  The port has no compiler between its eager
ops and the card, so it runs each entry point once, on small inputs made
from a seed, under :class:`AuditMode`: a ``TorchDispatchMode`` (as
``launch/cost.py``'s ``CostMode``) that sees every aten op, on the CPU
(the kernels' plain versions) or on the card (the kernels themselves):

T001  dtype contracts: packed state words are ``int32`` views of the
      JAX package's uint32 words end to end, node / segment ids and
      counts are int32, BFS planes are int8.  A silent upcast (e.g. to
      int64 from a stray Python int) doubles the packed representation
      and breaks the word-RAM cost model.
T002  host round-trips inside a step: ``aten._local_scalar_dense``
      (``.item()``, ``bool``/``int`` of a tensor), an op whose output
      size is read from the data (``nonzero``, ``masked_select``, a
      boolean-mask index, ``unique``), and a ``_to_copy``/``copy_``
      that leaves the device.  The JAX package's jitted steps read
      nothing; where the port's design reads the host, the check names
      how many reads are allowed (the chunk-end flag of
      ``dense.superstep_loop``, the plane read-back of a sharded
      superstep), never a blanket exemption.  On the CPU a read inside
      a kernel's plain version (a frame under ``repro_torch/kernels/``)
      stands in for the kernel, which reads nothing on the card: it is
      noted, not counted.
T003  pow2 padding: the dense engine's heterogeneous bucket widths must
      be minimal powers of two (min 4) so mixed-size automata share
      launch shapes.
T004  retrace budget: a canonical mixed workload on both engines must
      stay within a fixed number of distinct dispatch signatures, and a
      repeat of the same workload must add ZERO new signatures.
T005  collective traffic: the bytes the sharded batched superstep
      copies into its gathered buffers or across devices, counted op by
      op under :class:`AuditMode`, per participant per superstep, must
      not exceed the port's wire model (``launch/cost.py``
      ``wire_bytes("all-gather", 4 * R * V_pad * W, n)``, the model the
      dry run uses) beyond tolerance.  Needs a mesh of >= 2 devices;
      reported as a skip note otherwise.
T006  an entry point that raises, or whose output differs from its plain
      version's on CPU copies of the same inputs (each kernel's
      ``ref.<name>_ref``; a sharded superstep's one-device
      ``dense.bfs_rows``): on the card this holds every kernel the audit
      launches to its plain version, bit for bit.

``audit_step`` is the reusable primitive: tests hand it deliberately
bad steps to prove the mode catches them.

Each named check's result is cached on disk under
``<root>/.cache/repro_torch-analysis/``, keyed by the content hash of
the source files the check runs plus the torch version, the device's
name and the mesh size: unchanged entry points skip re-running.
:func:`run_trace_audit` returns, beside the findings and the notes, each
check's result and T005's numbers as data (the CLI's ``--json`` document
holds them under ``trace``).
``--no-trace-cache`` (or ``use_cache=False``) forces a live run.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from dataclasses import asdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding

aten = torch.ops.aten

# T002: ops that read the host.  A scalar read, and the ops whose output
# size is read from the data (a boolean-mask index reads its mask's
# count; ``index_put_`` with one does too).
SCALAR_READS = {aten._local_scalar_dense, aten.equal}
DATA_SIZED = {aten.nonzero, aten.masked_select, aten._unique,
              aten._unique2, aten.unique_dim, aten.unique_consecutive}
MASK_INDEXED = {aten.index, aten.index_put, aten.index_put_}

# Wire-model tolerance for T005, the JAX package's: the port copies each
# device's own rows into its gathered buffer too, so it moves n / (n - 1)
# times the wire model, inside this headroom.
COLLECTIVE_TOLERANCE = 1.75
COLLECTIVE_SLACK_BYTES = 4096
# T005's node rows a shard: wide enough that the slack is below the
# gathered bytes, so a second gather exceeds the limit at any n >= 2
COLLECTIVE_ROWS_PER_SHARD = 256

# Distinct-signature budgets for the canonical workload (T004), the JAX
# package's: a per-query retrace blowup (signatures scaling with the
# number of queries) fails, a benign new bucket does not.
RETRACE_BUDGET = {"dense": 3, "ring": 2}

CANONICAL_QUERIES = (
    "l5/l1",
    ("l5/(l1)*", 0, None),
    ("(l1|l2)/^bus", None, 3),
    "l5/l1",          # replay: must hit the same dispatch signature
)

_KERNELS_DIR = os.path.realpath(
    os.path.join(os.path.dirname(__file__), os.pardir, "kernels")) + os.sep
_TORCH_DIR = os.path.realpath(os.path.dirname(torch.__file__)) + os.sep
_HERE = os.path.realpath(__file__)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _caller() -> Tuple[str, bool]:
    """(``file:line`` of the innermost frame outside torch and the
    analyzer, whether some frame lies in ``repro_torch/kernels/``)."""
    where, in_kernel = "", False
    f = sys._getframe(2)
    while f is not None:
        path = os.path.realpath(f.f_code.co_filename)
        if path.startswith(_KERNELS_DIR):
            in_kernel = True
        if not where and not path.startswith(_TORCH_DIR) and \
                path != _HERE:
            where = f"{os.path.basename(path)}:{f.f_lineno}"
            if "repro_torch" in path:
                where = f"{path[path.rindex('repro_torch'):]}:{f.f_lineno}"
        f = f.f_back
    return where, in_kernel


def _leaves_device(func, args, out) -> bool:
    """A copy from a device tensor into host memory."""
    packet = func._overloadpacket
    if packet is aten._to_copy and isinstance(out, torch.Tensor):
        return args[0].device.type not in ("cpu", "meta") and \
            out.device.type == "cpu"
    if packet is aten.copy_:
        return args[0].device.type == "cpu" and \
            args[1].device.type not in ("cpu", "meta")
    return False


def _host_read(func, args, out) -> bool:
    packet = func._overloadpacket
    if packet in SCALAR_READS or packet in DATA_SIZED:
        return True
    if packet in MASK_INDEXED and len(args) > 1:
        return any(t.dtype in (torch.bool, torch.uint8)
                   for t in _tensors(args[1]))
    return _leaves_device(func, args, out)


def _storage(t: torch.Tensor) -> Tuple[str, int]:
    return str(t.device), t.untyped_storage().data_ptr()


def _copied_bytes(func, args, out, watched) -> int:
    """Bytes a ``copy_`` writes into a watched buffer (any view of it) or
    across devices, or a ``_to_copy`` moves to another device."""
    packet = func._overloadpacket
    if packet is aten.copy_:
        dst, src = args[0], args[1]
        if dst.device != src.device or _storage(dst) in watched:
            return dst.numel() * dst.element_size()
    elif packet is aten._to_copy and isinstance(out, torch.Tensor) and \
            out.device != args[0].device:
        return out.numel() * out.element_size()
    return 0


class AuditMode(TorchDispatchMode):
    """Sees every aten op dispatched under it and records each host
    round-trip (``reads``: ``(op, where)``, ``where`` the innermost frame
    that made it).  With ``plain_stand_in`` (the CPU), a read made
    inside a kernel's plain version goes to ``plain_reads`` instead: on
    the card the kernel runs there and reads nothing.  ``copied`` counts
    the bytes copied into the ``watch`` tensors' storage or across
    devices (T005)."""

    def __init__(self, plain_stand_in: bool = False,
                 watch: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.plain_stand_in = plain_stand_in
        self.reads: List[Tuple[str, str]] = []
        self.plain_reads = 0
        self.watched = {_storage(t) for t in watch}
        self.copied = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.copied += _copied_bytes(func, args, out, self.watched)
        if _host_read(func, args, out):
            where, in_kernel = _caller()
            if self.plain_stand_in and in_kernel:
                self.plain_reads += 1
            else:
                self.reads.append((str(func.overloadpacket), where))
        return out


def _flatten(out) -> List:
    if isinstance(out, (list, tuple)):
        return [y for x in out for y in _flatten(x)]
    return [out]


def _dtype_name(x) -> Optional[str]:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    if isinstance(x, np.ndarray):
        return str(x.dtype)
    return None


def _want_name(want) -> str:
    if isinstance(want, torch.dtype):
        return str(want).replace("torch.", "")
    return str(np.dtype(want))


def _host_copy(x):
    """``x`` with every tensor (in lists, tuples and dicts too) and array
    copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(y) for y in x)
    if isinstance(x, dict):
        return {k: _host_copy(y) for k, y in x.items()}
    return x


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _disagreement(got, want) -> Optional[str]:
    """Why the flattened outputs ``got`` differ from ``want`` (their
    shapes, or the elements that differ), or None when bit for bit
    equal."""
    got, want = _flatten(got), _flatten(want)
    if len(got) != len(want):
        return f"{len(got)} outputs, the plain version gives {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _host_array(a), _host_array(b)
        if a.shape != b.shape:
            return f"output {i} has shape {a.shape}, the plain version's " \
                f"{b.shape}"
        bad = int(np.count_nonzero(a != b))
        if bad:
            return f"output {i} differs from the plain version's at {bad} " \
                f"of {a.size} elements"
    return None


def audit_step(
    fn: Callable,
    args: Sequence,
    *,
    label: str,
    file: str,
    line: int = 0,
    expect_out_dtypes: Optional[Sequence] = None,
    allowed_syncs: Union[int, Callable[[], int]] = 0,
    device,
    notes: Optional[List[str]] = None,
    reference: Optional[Callable] = None,
) -> List[Finding]:
    """Run ``fn(*args)`` under :class:`AuditMode` on ``device``'s
    tensors and audit what it did.

    ``expect_out_dtypes``: required dtype per flattened output (torch or
    numpy dtypes; None entries skip).  ``allowed_syncs``: the host
    round-trips the step's design makes (an int, or a callable read
    after the run, e.g. one a chunk the loop ran); more is T002.  An
    exception is T006.  ``reference``: the plain version, called on host
    copies of ``args`` taken before the run (``fn`` may write its
    inputs); an output that differs from its output is T006.  ``notes``
    gets the reads left to the kernels' plain versions on the CPU."""
    host_args = _host_copy(tuple(args)) if reference is not None else ()
    mode = AuditMode(plain_stand_in=torch.device(device).type == "cpu")
    try:
        with mode:
            out = fn(*args)
    except Exception as exc:  # noqa: BLE001 - any failure is T006
        return [Finding(
            file, line, "T006",
            f"{label}: entry point raised {type(exc).__name__}: {exc}",
            "fix the step or its inputs; run the audit locally to "
            "reproduce", f"{label}:failure")]
    findings: List[Finding] = []
    if reference is not None:
        why = _disagreement(out, reference(*host_args))
        if why is not None:
            findings.append(Finding(
                file, line, "T006", f"{label}: {why}",
                "the kernel or step computes another function than its "
                "plain version; hold it to the plain version at this "
                "shape on the card", f"{label}:disagrees"))
    if expect_out_dtypes is not None:
        outs = _flatten(out)
        for i, want in enumerate(expect_out_dtypes):
            if want is None or i >= len(outs):
                continue
            got = _dtype_name(outs[i])
            if got != _want_name(want):
                findings.append(Finding(
                    file, line, "T001",
                    f"{label}: output {i} is {got}, contract requires "
                    f"{_want_name(want)}",
                    "check for a silent upcast (Python int arithmetic, "
                    "default dtypes) in the step math; words stay int32 "
                    "views", f"{label}:out{i}:{got}"))
    allowed = allowed_syncs() if callable(allowed_syncs) else allowed_syncs
    if len(mode.reads) > allowed:
        kinds = sorted({op for op, _ in mode.reads})
        shown = ", ".join(f"{op} at {where or '?'}"
                          for op, where in mode.reads[:6])
        findings.append(Finding(
            file, line, "T002",
            f"{label}: {len(mode.reads)} host round-trip(s) in the step, "
            f"{allowed} allowed by design: {shown}",
            "keep step state on the device; read the host only at the "
            "designed points (a chunk's flag, the exit's read-back)",
            f"{label}:host-read:{','.join(kinds)}"))
    if notes is not None and mode.plain_reads:
        notes.append(f"{label}: {mode.plain_reads} host read(s) inside "
                     "the kernels' plain versions (CPU stand-ins; the "
                     "card's kernels read nothing) not counted")
    return findings


def _on(a: np.ndarray, device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of the array)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _rand_words(rng, shape, S: int) -> np.ndarray:
    """Random int32 views of uint32 words with bits only below ``S`` in
    the last axis's ceil(S / 32) words."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    bits = np.arange(shape[-1] * 32).reshape(shape[-1], 32) < S
    mask = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(axis=1)
    return (w & mask.astype(np.uint64)).astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------
# T001/T002: kernel + superstep entry-point contracts
# ---------------------------------------------------------------------

def check_kernel_contracts(device, notes: Optional[List[str]] = None
                           ) -> List[Finding]:
    """Every ``KERNELS`` entry through ``kernels/ops.py`` at the JAX
    package's shapes (``packed_superstep`` at its ``_bfs_hetero``
    sizes): the plain versions on the CPU, the kernels on the card, each
    held bit for bit to its ``ref.<name>_ref`` on host copies."""
    from ..kernels import ops, ref
    from ..kernels.packed_superstep import group_by_object, new_scratch

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    i32 = torch.int32
    ops_file = "src/repro_torch/kernels/ops.py"
    findings: List[Finding] = []

    def audit(fn, args, label, out_dtypes, plain):
        findings.extend(audit_step(
            fn, args, label=label, file=ops_file,
            expect_out_dtypes=out_dtypes, device=dev, notes=notes,
            reference=plain))

    for N, S, W in ((512, 33, 2), (700, 7, 1)):
        audit(ops.nfa_step, (_on(_rand_words(rng, (N, W), S), dev),
                             _on(_rand_words(rng, (S, W), S), dev)),
              f"kernels.ops.nfa_step[{N}x{W}]", [i32], ref.nfa_step_ref)
    seg = np.sort(rng.integers(0, 64, 256)).astype(np.int32)
    audit(lambda v, s: ops.segment_or(v, s, 64),
          (_on(_rand_words(rng, (256, 2), 64), dev), _on(seg, dev)),
          "kernels.ops.segment_or", [i32],
          lambda v, s: ref.segment_or_ref(v, s, 64))
    flags = (rng.random(256) < 0.1).astype(np.int32)
    audit(ops.segmented_or_scan,
          (_on(_rand_words(rng, (256, 2), 64), dev), _on(flags, dev)),
          "kernels.ops.segmented_or_scan", [i32], ref.segmented_or_scan_ref)
    nw = 64  # 4 superblocks of 16 words
    words = _on(_rand_words(rng, (nw,), 32), dev)
    audit(ops.superblock_popcounts, (words,),
          "kernels.ops.superblock_popcounts", [i32],
          ref.superblock_popcounts_ref)
    audit(ops.build_rank_directory, (words,),
          "kernels.ops.build_rank_directory", [i32],
          lambda w: torch.cat([
              torch.zeros(1, dtype=i32),
              torch.cumsum(ref.superblock_popcounts_ref(w), 0).to(i32)]))
    directory = ops.build_rank_directory(words)
    q = rng.integers(0, nw * 32, 128).astype(np.int32)
    audit(ops.rank1, (words, directory, _on(q, dev)), "kernels.ops.rank1",
          [i32], lambda w, d, i: ref.rank1_ref(w, i))

    subj, pred, obj, Bp, bwd, f = _bfs_inputs(rng, *HETERO, dev)
    layout = group_by_object(subj, pred, obj, HETERO[1], HETERO[3])
    scratch = new_scratch(layout, HETERO[0])
    edges = _host_copy((subj, pred, obj))

    def superstep(f, v, nxt, spare, flag, Bp, bwd):
        ops.packed_superstep(f, v, nxt, spare, flag, 1, Bp, bwd, layout,
                             scratch)
        return nxt, v, flag

    def plain(f, v, nxt, spare, flag, Bp, bwd):
        ref.packed_superstep_ref(f, v, nxt, spare, flag, 1, Bp, bwd, *edges)
        return nxt, v, flag

    audit(superstep, (f, f.clone(), torch.zeros_like(f),
                      torch.zeros_like(f), torch.zeros(1, dtype=i32,
                                                       device=dev), Bp, bwd),
          "kernels.ops.packed_superstep", [i32] * 3, plain)
    return findings


# R, V, S, L, E of the JAX package's ``_bfs_hetero`` audit
HETERO = (3, 16, 8, 4, 40)

# The dense loop's design without a deadline: supersteps queued in
# chunks of 1, 2, 4, ... up to this many, one flag read a chunk
FLAG_CHUNK_CAP = 16


def designed_chunks(supersteps: int) -> int:
    """The chunks the designed schedule takes to run ``supersteps``: the
    fewest whose sizes add up to at least that many."""
    chunks = done = 0
    while done < supersteps:
        done += min(FLAG_CHUNK_CAP, 1 << chunks)
        chunks += 1
    return chunks


def _bfs_inputs(rng, R: int, V: int, S: int, L: int, E: int, device):
    """Random ids, label tables (the inert row L zero), transition tables
    and start words of an R-row BFS, on ``device``."""
    subj, obj = (_on(rng.integers(0, V, E).astype(np.int32), device)
                 for _ in range(2))
    pred = _on(rng.integers(0, L + 1, E).astype(np.int32), device)
    Bp = _rand_words(rng, (R, L + 1, 1), S)
    Bp[:, L] = 0
    PRED = _rand_words(rng, (R, S, 1), S)
    start = np.zeros((R, V, 1), np.int32)
    start[np.arange(R), rng.integers(0, V, R)] = 1 << 1
    return subj, pred, obj, _on(Bp, device), _on(PRED, device), \
        _on(start, device)


def check_hetero_bfs(device, notes: Optional[List[str]] = None
                     ) -> List[Finding]:
    """The R-row BFS of the dense engine (``dense.bfs_rows``, the
    counterpart of the JAX package's ``_bfs_hetero``) at its sizes:
    int32 words in and out, equal to a run on host copies, and host
    reads only where the loop is designed to read: whether any row has
    a frontier, then the kernel's flag once a chunk of the designed
    schedule (:func:`designed_chunks` of the supersteps it ran)."""
    from ..core import dense

    dev = torch.device(device)
    R, V, S, L, E = HETERO
    subj, pred, obj, Bp, PRED, start = _bfs_inputs(
        np.random.default_rng(1), R, V, S, L, E, dev)
    edges = dense.Edges.build(subj, pred, obj, V, L)
    host_edges = dense.Edges.build(*_host_copy((subj, pred, obj)), V, L)
    ran = []

    def bfs(Bp, PRED, start):
        ran.append(dense.bfs_rows(edges, Bp, PRED, start, V * S + 1))
        return ran[-1]

    def allowed() -> int:
        return 1 + designed_chunks(ran[0][2])

    findings = audit_step(
        bfs, (Bp, PRED, start.clone()), label="dense.bfs_rows",
        file="src/repro_torch/core/dense.py",
        expect_out_dtypes=[torch.int32, torch.int32, None],
        allowed_syncs=allowed, device=dev, notes=notes,
        reference=lambda Bp, PRED, start: dense.bfs_rows(
            host_edges, Bp, PRED, start, V * S + 1))
    if ran and notes is not None:
        notes.append(f"dense.bfs_rows: {ran[0][2]} superstep(s) in "
                     f"{designed_chunks(ran[0][2])} chunk(s) of the "
                     f"designed 1, 2, 4, ... {FLAG_CHUNK_CAP}, "
                     f"{allowed()} host read(s) allowed")
    return findings


def _mesh(device, mesh_devices: int):
    """A ``("data",)`` mesh of ``mesh_devices`` devices of ``device``'s
    kind: ``cuda:0 .. N-1``, taking the visible cards in turn (one card
    stands for N, as the port's CUDA tests and ``chip_smoke.py`` run a
    mesh of 4 x one card), or N repeats of the host; one device when
    fewer than 2 are asked for."""
    from ..core.distributed import Mesh

    dev = torch.device(device)
    n = max(1, int(mesh_devices))
    if dev.type == "cuda" and n > 1:
        cards = torch.cuda.device_count()
        devs = [torch.device("cuda", i % cards) for i in range(n)]
    else:
        devs = [dev] * n
    return Mesh(devs, ("data",))


def _sharded_args(rng, n: int, R: int, Vp: int, S: int, L: int,
                  Emax: int, device):
    """int8 planes [R, Vp, S] (visited holds the frontier), [n, Emax/n]
    int32 edge arrays (subj local to its shard, L the inert label) and
    int8 tables [R, L+1, S] (row L zero) and [R, S, S]."""
    Vl, per = Vp // n, Emax // n
    f = (rng.random((R, Vp, S)) < 0.05).astype(np.int8)
    v = f | (rng.random((R, Vp, S)) < 0.05).astype(np.int8)
    subj = rng.integers(0, Vl, (n, per)).astype(np.int32)
    pred = rng.integers(0, L + 1, (n, per)).astype(np.int32)
    obj = rng.integers(0, Vp, (n, per)).astype(np.int32)
    B = (rng.random((R, L + 1, S)) < 0.5).astype(np.int8)
    B[:, L] = 0
    P = (rng.random((R, S, S)) < 0.3).astype(np.int8)
    return tuple(_on(a, device) for a in (f, v, subj, pred, obj, B, P))


def check_sharded_steps(device, mesh_devices: int = 0,
                        notes: Optional[List[str]] = None) -> List[Finding]:
    """The sharded superstep factories on a mesh (one device still runs
    the step, its dtypes and its reads; the collective-bytes check
    separately needs >= 2).  ``make_superstep_batched``'s superstep
    proper (``_PlaneBFS.run``) may read nothing; its plane read-back at
    exit reads the flags, one a device.  ``make_task_shard_step``
    returns host words: its one read-back is its result."""
    from ..core import distributed as dist

    dev = torch.device(device)
    mesh = _mesh(dev, mesh_devices)
    n = mesh.devices.size
    home = mesh.devices.reshape(-1)[0]
    file = "src/repro_torch/core/distributed.py"
    findings: List[Finding] = []
    rng = np.random.default_rng(2)

    R, Vp, S, L, Emax = 4, 32 * n, 8, 3, 64 * n
    step = dist.make_superstep_batched(mesh, ("data",))
    label = "distributed.make_superstep_batched"
    args = _sharded_args(rng, n, R, Vp, S, L, Emax, home)
    host_args = _host_copy(args)
    try:
        bfs = step.build(*args)
    except Exception as exc:  # noqa: BLE001 - any failure is T006
        return [Finding(file, 0, "T006",
                        f"{label}: the step's state does not build: "
                        f"{type(exc).__name__}: {exc}", "",
                        f"{label}:build-failure")]
    findings += audit_step(
        bfs.run, (1,), label=f"{label}: superstep", file=file, device=dev,
        notes=notes)
    findings += audit_step(
        bfs.planes, (), label=f"{label}: plane read-back", file=file,
        expect_out_dtypes=[torch.int8, torch.int8],
        allowed_syncs=len(bfs.flags), device=dev, notes=notes,
        reference=lambda: _one_device_superstep(*host_args, shards=n))

    task_step = dist.make_task_shard_step(mesh, ("data",))
    bwd = _rand_words(rng, (33, 2), 33)
    X = _rand_words(rng, (16 * n, 2), 33).view(np.uint32)
    findings += audit_step(
        task_step, (X, {d: _on(bwd, d) for d in task_step.devices}),
        label="distributed.make_task_shard_step", file=file,
        expect_out_dtypes=[np.uint32],
        allowed_syncs=0 if dev.type == "cpu" else 1, device=dev,
        notes=notes, reference=_task_step_plain)
    return findings


def _one_device_superstep(f, v, subj, pred, obj, B, P, *, shards: int):
    """One superstep of the sharded planes on one device, through the
    dense engine's ``bfs_rows`` over every shard's edges (subj made
    global): ``(frontier, visited)`` int8 [R, V_pad, S]."""
    from ..core import dense
    from ..kernels import ops

    R, Vp, S = f.shape
    offset = (torch.arange(shards, dtype=torch.int32,
                           device=subj.device) * (Vp // shards))[:, None]
    edges = dense.Edges.build((subj + offset).reshape(-1),
                              pred.reshape(-1), obj.reshape(-1), Vp,
                              B.shape[1] - 1)
    visited, frontier, _ = dense.bfs_rows(
        edges, ops.planes_to_words(B), ops.planes_to_words(P),
        ops.planes_to_words(f), 1, visited=ops.planes_to_words(v))
    return ops.words_to_planes(frontier, S), ops.words_to_planes(visited, S)


def _task_step_plain(X: np.ndarray, bwd) -> np.ndarray:
    """``make_task_shard_step``'s function on one device: the plain
    ``nfa_step`` of every row."""
    from ..kernels import ops, ref

    table = next(iter(bwd.values()))
    return ops.tensor_to_words(ref.nfa_step_ref(
        ops.words_to_tensor(X, table.device), table))


# ---------------------------------------------------------------------
# T003: pow2 bucket padding
# ---------------------------------------------------------------------

def check_pow2_padding() -> List[Finding]:
    from ..core.dense import DenseRPQ

    findings: List[Finding] = []
    for S in range(1, 129):
        w = DenseRPQ._pad_width(S)
        minimal = max(4, 1 << (S - 1).bit_length())
        if w != minimal:
            findings.append(Finding(
                "src/repro_torch/core/dense.py", 0, "T003",
                f"_pad_width({S}) = {w}; hetero buckets must pad to the "
                f"minimal power of two >= max(S, 4) (= {minimal}) to share "
                "launch shapes without waste",
                "restore next-pow2(min 4) padding in DenseRPQ._pad_width",
                f"_pad_width:{S}:{w}"))
    return findings


# ---------------------------------------------------------------------
# T004: retrace audit on a canonical workload
# ---------------------------------------------------------------------

def _run_canonical(kind: str, device) -> Tuple[int, int]:
    """(signatures after first pass, new signatures on replay)."""
    from ..core import fixtures
    from ..core.engines import eval_many, make_engine

    eng = make_engine(fixtures.metro_graph(), kind=kind, device=device)
    eval_many(eng, list(CANONICAL_QUERIES))
    first = eng.traces.retraces
    eval_many(eng, list(CANONICAL_QUERIES))
    return first, eng.traces.retraces - first


def check_retraces(device="cpu") -> List[Finding]:
    findings: List[Finding] = []
    anchors = {"dense": "src/repro_torch/core/dense.py",
               "ring": "src/repro_torch/core/rpq.py"}
    for kind, budget in RETRACE_BUDGET.items():
        first, replay_new = _run_canonical(kind, device)
        if first > budget:
            findings.append(Finding(
                anchors[kind], 0, "T004",
                f"{kind} engine: canonical workload produced {first} "
                f"distinct dispatch signatures (budget {budget}) — "
                "dispatch shapes are fragmenting",
                "bucket/pad dispatch shapes so mixed queries share "
                "launch signatures; see QueryStats.retraces",
                f"{kind}:retraces:{first}>{budget}"))
        if replay_new != 0:
            findings.append(Finding(
                anchors[kind], 0, "T004",
                f"{kind} engine: replaying the identical workload added "
                f"{replay_new} NEW dispatch signatures — signature keys "
                "are unstable (nondeterministic key material?)",
                "make dispatch signature keys a pure function of query "
                "shapes", f"{kind}:replay:{replay_new}"))
    return findings


# ---------------------------------------------------------------------
# T005: collective bytes vs the wire model
# ---------------------------------------------------------------------

def check_collective_bytes(notes: List[str], device="cpu",
                           mesh_devices: int = 0,
                           data: Optional[Dict] = None) -> List[Finding]:
    """T005: one superstep of ``make_superstep_batched`` under
    :class:`AuditMode`, which counts every byte copied into the gathered
    buffers or across devices; per participant (gathered buffer), held
    to the wire model.  ``data["t005"]`` gets the numbers."""
    from ..core import distributed as dist
    from ..launch.cost import wire_bytes

    n = max(1, int(mesh_devices))
    if n < 2:
        notes.append(
            "T005 collective-bytes check skipped: needs >= 2 devices "
            f"(have {n}); run with --mesh-devices 4")
        return []
    mesh = _mesh(device, n)
    R, S, L = 4, 8, 3
    Vp = COLLECTIVE_ROWS_PER_SHARD * n
    W = (S + 31) // 32
    step = dist.make_superstep_batched(mesh, ("data",))
    args = _sharded_args(np.random.default_rng(3), n, R, Vp, S, L, 64 * n,
                         mesh.devices.reshape(-1)[0])
    try:
        bfs = step.build(*args)
        mode = AuditMode(watch=list(bfs.gathered.values()))
        with mode:
            bfs.run(1)
        bfs.planes()
    except Exception as exc:  # noqa: BLE001
        return [Finding(
            "src/repro_torch/core/distributed.py", 0, "T006",
            f"sharded superstep failed for the collective audit: "
            f"{type(exc).__name__}: {exc}", "",
            "superstep:collective-failure")]
    gather = mode.copied / len(bfs.gathered) / bfs.it
    # the port's wire model (the dry run's), and the JAX package's
    # planner model over its int8 planes
    model = wire_bytes("all-gather", 4 * R * Vp * W, n)
    planes = R * Vp * S * (n - 1) / n
    limit = model * COLLECTIVE_TOLERANCE + COLLECTIVE_SLACK_BYTES
    if data is not None:
        data["t005"] = {
            "gathered_bytes_per_participant_per_superstep": gather,
            "port_wire_model_bytes": model, "limit_bytes": limit,
            "reference_int8_plane_model_bytes": planes,
            "participants": len(bfs.gathered), "mesh_devices": n,
            "R": R, "V_pad": Vp, "S": S}
    if gather > limit:
        return [Finding(
            "src/repro_torch/core/distributed.py", 0, "T005",
            f"sharded batched superstep moves {gather:.0f} all-gather "
            f"bytes/participant/superstep; the wire model predicts "
            f"{model:.0f} (limit {limit:.0f}, n={n}; the JAX package's "
            f"int8-plane model {planes:.0f}) — an extra or widened "
            "collective crept into the step",
            "the frontier gather must be the ONLY collective; check for "
            "accidental replication or dtype widening of gathered "
            "operands", f"superstep:all-gather:{n}")]
    notes.append(
        f"T005 OK: all-gather {gather:.0f} B/participant/superstep vs the "
        f"port's wire model {model:.0f} B (limit {limit:.0f}) and the JAX "
        f"package's int8-plane model {planes:.0f} B (n={n}, R={R}, "
        f"V_pad={Vp}, S={S}, tolerance {COLLECTIVE_TOLERANCE}x)")
    return []


# ---------------------------------------------------------------------
# entry point + result cache
# ---------------------------------------------------------------------

_AUDIT = "src/repro_torch/analysis/trace_audit.py"
_KERNELS = "src/repro_torch/kernels"


def checks(device, mesh_devices: int = 0):
    """(name, check(notes, data) -> findings, repo-relative source deps)
    of every check on ``device`` and a mesh of ``mesh_devices``; a check
    may put its numbers in ``data``.  The dep sets are what each check
    runs: editing any listed file (or any file under a listed directory)
    invalidates that check's cache entry only."""
    return (
        ("kernel_contracts",
         lambda notes, data: check_kernel_contracts(device, notes),
         (_AUDIT, _KERNELS)),
        ("hetero_bfs", lambda notes, data: check_hetero_bfs(device, notes),
         (_AUDIT, _KERNELS, "src/repro_torch/core/dense.py",
          "src/repro_torch/obs/trace.py")),
        ("sharded_steps",
         lambda notes, data: check_sharded_steps(device, mesh_devices,
                                                 notes),
         (_AUDIT, _KERNELS, "src/repro_torch/core/distributed.py",
          "src/repro_torch/core/dense.py")),
        ("pow2_padding", lambda notes, data: check_pow2_padding(),
         (_AUDIT, "src/repro_torch/core/dense.py")),
        ("retraces", lambda notes, data: check_retraces(device),
         (_AUDIT, "src/repro_torch/core", _KERNELS)),
        ("collective_bytes",
         lambda notes, data: check_collective_bytes(notes, device,
                                                    mesh_devices, data),
         (_AUDIT, _KERNELS, "src/repro_torch/core/distributed.py",
          "src/repro_torch/core/dense.py", "src/repro_torch/launch/cost.py")),
    )


DEFAULT_CACHE_DIR = Path(".cache/repro_torch-analysis")


def signature(device, mesh_devices: int = 0) -> str:
    """What a cached result depends on beyond the sources: the torch
    version, the device's name and the mesh size."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    return f"{torch.__version__}:{name}:{max(1, int(mesh_devices))}"


def cache_key(root: Path, name: str, deps: Sequence[str],
              sig: str = "") -> Optional[str]:
    """Content hash over a check's source dependencies plus ``sig``
    (:func:`signature`).  ``None`` when no dep file resolves (running
    outside a source checkout) — such a check is uncacheable."""
    h = hashlib.sha256()
    h.update(f"{name}:{sig}".encode())
    seen = 0
    for dep in deps:
        base = Path(root) / dep
        files = sorted(base.rglob("*.py")) if base.is_dir() else \
            [base] if base.is_file() else []
        for path in files:
            h.update(path.name.encode())
            h.update(path.read_bytes())
            seen += 1
    return h.hexdigest() if seen else None


def _run_checks_cached(
    root: Path,
    checks: Sequence[Tuple[str, Callable[[List[str], Dict], List[Finding]],
                           Sequence[str]]],
    cache_dir: Optional[Path],
    use_cache: bool,
    sig: str = "",
) -> Tuple[List[Finding], List[str], Dict[str, Dict]]:
    """Run ``checks`` through the result cache.  Returns (findings,
    notes, results): ``results[name]`` holds the check's finding count,
    its seconds (None when cached), whether it was cached and the data
    it gave; each check's result is also a note of its own."""
    cache_path = None
    cache: Dict[str, Dict] = {}
    if use_cache:
        cache_path = Path(cache_dir or Path(root) / DEFAULT_CACHE_DIR)
        cache_path = cache_path / "trace_audit.json"
        if cache_path.exists():
            try:
                cache = json.loads(cache_path.read_text())
            except (ValueError, OSError):
                cache = {}
    findings: List[Finding] = []
    notes: List[str] = []
    results: Dict[str, Dict] = {}
    dirty = False
    for name, fn, deps in checks:
        key = cache_key(root, name, deps, sig) if use_cache else None
        entry = cache.get(key) if key else None
        if entry is not None and entry.get("check") == name:
            got = [Finding(**f) for f in entry["findings"]]
            findings += got
            notes += list(entry["notes"])
            notes.append(f"trace check {name}: {len(got)} finding(s) "
                         "(cached)")
            results[name] = {"findings": len(got), "seconds": None,
                             "cached": True, "data": entry["data"]}
            continue
        local_notes: List[str] = []
        data: Dict = {}
        t0 = time.perf_counter()
        got = fn(local_notes, data)
        secs = time.perf_counter() - t0
        findings += got
        notes += local_notes
        notes.append(f"trace check {name}: {len(got)} finding(s) in "
                     f"{secs:.2f} s")
        results[name] = {"findings": len(got), "seconds": secs,
                         "cached": False, "data": data}
        if key:
            cache[key] = {"check": name, "signature": sig,
                          "findings": [asdict(f) for f in got],
                          "notes": local_notes, "data": data}
            dirty = True
    if dirty and cache_path is not None:
        # keep entries for other device/version signatures, but drop
        # superseded keys of the checks just re-run (under this
        # signature) so the file does not grow without bound as sources
        # churn
        fresh_names = {name for name, _, _ in checks}
        live_keys = {cache_key(root, name, deps, sig)
                     for name, _, deps in checks}
        cache = {k: v for k, v in cache.items()
                 if k in live_keys or v.get("check") not in fresh_names
                 or v.get("signature") != sig}
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        cache_path.write_text(json.dumps(cache, indent=1) + "\n")
    return findings, notes, results


def run_trace_audit(root: Path = Path("."), *,
                    cache_dir: Optional[Path] = None,
                    use_cache: bool = True,
                    device="cuda",
                    mesh_devices: int = 0,
                    ) -> Tuple[List[Finding], List[str], Dict]:
    """All trace-audit checks on ``device`` (``"cuda"`` raises without
    a card) and a mesh of ``mesh_devices``.  Returns (findings,
    human-readable notes, report): the report holds each check's result
    (``checks``: findings, seconds, cached) and T005's numbers
    (``t005``, None when skipped).  The audit runs against the
    *imported* package; ``root`` is only used to locate the source
    files that key (and the directory that stores) the result cache."""
    from ..kernels.ops import resolve_device

    dev = resolve_device(device)
    n = max(1, int(mesh_devices))
    findings, notes, results = _run_checks_cached(
        root, checks(dev, mesh_devices), cache_dir, use_cache,
        signature(dev, mesh_devices))
    hits = sum(r["cached"] for r in results.values())
    misses = len(results) - hits
    notes.append(f"trace-audit result cache: {hits} hit(s), "
                 f"{misses} miss(es)"
                 if use_cache else "trace-audit result cache: disabled")
    notes.append(f"trace audit ran on {n} {dev.type} device(s)")
    report = {
        "checks": {name: {k: r[k] for k in ("findings", "seconds",
                                            "cached")}
                   for name, r in results.items()},
        "t005": results.get("collective_bytes", {}).get("data", {})
        .get("t005")}
    return findings, notes, report
