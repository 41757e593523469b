"""Logical-axis sharding rules, and tensors sharded over a mesh of torch
devices — the JAX package's ``sharding.py`` without GSPMD.

Model code names array axes logically ('batch', 'heads', 'ffn', ...); a
rule table maps logical names to mesh axes (``make_rules``, ``spec``,
``sanitize_spec``: the reference's, as they are).  A spec is a plain
tuple with one entry a dimension: ``None`` (replicated), a mesh axis
name, or a tuple of names (the dimension split over their product,
row-major, the first axis major, as a ``PartitionSpec`` splits it).

Where the reference hands the specs to XLA, which partitions the
program, this package runs it by hand: one process drives every
coordinate of a :class:`~repro_torch.core.distributed.Mesh` (a device
may repeat), a :class:`Sharded` tensor holds one local tensor a
coordinate, and the collectives below move the parts between
coordinates.  Each collective is a ``torch.cat`` or a sum of
``.to(device)`` copies, so autograd derives its transpose (an
all-gather's is a reduce-scatter), and every sum runs in a fixed order
(by index on the reduced axes), so a run is deterministic.  The
collectives count the bytes a ring algorithm would move between
coordinates (:func:`collective_bytes`), and, inside
:func:`counting_transposes`, those of the transposes autograd runs for
them (:func:`transposed_bytes`).
"""
from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Entry = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Entry, ...]
Coord = Tuple[int, ...]
Local = Dict[Coord, torch.Tensor]


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_rules(mesh, cfg, small_batch: bool = False,
               serving: bool = False) -> Dict[str, Optional[Tuple[str, ...]]]:
    """``small_batch``: the global batch is smaller than the data axes
    (long-context decode) — batch stays replicated and the KV-cache
    sequence dim takes the data axes instead.  ``serving``: weights are
    bf16, TP-sharded and DP-replicated (no per-token FSDP gathers);
    training keeps fsdp weight sharding."""
    dp = data_axes(mesh)
    model = ("model",) if "model" in mesh.axis_names else None
    if small_batch or serving:
        rules = make_rules(mesh, cfg)
        if serving:
            rules["fsdp"] = None
        if small_batch:
            rules["batch"] = None
            rules["cache_batch"] = None
            rules["cache_seq"] = dp or None
        return rules
    rules: Dict[str, Optional[Tuple[str, ...]]] = {
        "batch": dp or None,
        "fsdp": dp or None,  # weight/optimizer-state sharding over data
                             # (ZeRO-3: per-layer all-gather, grads
                             # reduce-scatter)
        "seq": None,
        "seq_sp": model,  # sequence-parallel residual-stream shard points
        "d_model": None,
        "heads": model if cfg.shard_attn_heads else None,
        "kv_heads": model if cfg.shard_attn_heads else None,
        "head_dim": None,
        "ffn": model if cfg.shard_ffn else None,
        "vocab": model if cfg.shard_vocab else None,
        "experts": model if cfg.shard_experts else None,
        "expert_ffn": None,
        "layers": None,
        "ssm_heads": model,
        "ssm_state": None,
        "conv": None,
        "cache_batch": dp or None,
        "cache_heads": model if cfg.shard_attn_heads else None,
        "cache_seq": None if cfg.shard_attn_heads else model,
    }
    return rules


def spec(rules, *names: Optional[str]) -> Spec:
    """Spec from logical axis names (None = replicated axis)."""
    out = []
    for n in names:
        if n is None:
            out.append(None)
        else:
            r = rules[n]
            out.append(r if r is None else (r if len(r) > 1 else r[0]))
    return tuple(out)


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    n = 1
    for a in entry:
        n *= mesh.shape[a]
    return n


def sanitize_spec(sp: Spec, shape: Sequence[int], mesh) -> Spec:
    """Drop sharding on any dim the mesh axes don't divide evenly: the
    dimension is replicated instead."""
    entries = list(sp) + [None] * (len(shape) - len(sp))
    out = []
    for dim, entry in zip(shape, entries):
        n = _axes_size(mesh, entry)
        out.append(entry if (n > 1 and dim % n == 0) or n == 1 else None)
    return tuple(out)


def sanitize_spec_tree(spec_tree, struct_tree, mesh):
    """:func:`sanitize_spec` over a tree of dicts whose leaves are specs
    and, in ``struct_tree``, anything with a ``shape``."""
    if isinstance(spec_tree, dict):
        return {k: sanitize_spec_tree(v, struct_tree[k], mesh)
                for k, v in spec_tree.items()}
    return sanitize_spec(spec_tree, tuple(struct_tree.shape), mesh)


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: () when it is replicated."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def replicated_dims(sp: Spec, shape: Sequence[int], mesh) -> List[int]:
    """The dims :func:`sanitize_spec` replicates because their axes do not
    divide them."""
    return [i for i, (a, b) in enumerate(zip(
        list(sp) + [None] * (len(shape) - len(sp)),
        sanitize_spec(sp, shape, mesh))) if a != b]


# -- coordinates ---------------------------------------------------------------

def coords(mesh) -> List[Coord]:
    """Every coordinate of the mesh, row-major."""
    return list(np.ndindex(*mesh.devices.shape))


def device(mesh, c: Coord) -> torch.device:
    return mesh.devices[c]


def axes_size(mesh, axes: Sequence[str]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))


def index(mesh, c: Coord, axes: Sequence[str]) -> int:
    """``c``'s position along ``axes`` (row-major over them, the first
    axis major): the shard of a dimension split over ``axes`` that ``c``
    holds."""
    i = 0
    for a in axes:
        k = mesh.axis_names.index(a)
        i = i * mesh.devices.shape[k] + c[k]
    return i


def group(mesh, c: Coord, axes: Sequence[str]) -> List[Coord]:
    """The coordinates that agree with ``c`` off ``axes``, in
    :func:`index` order."""
    ks = [mesh.axis_names.index(a) for a in axes]
    out = []
    for idx in itertools.product(*[range(mesh.devices.shape[k])
                                   for k in ks]):
        g = list(c)
        for k, i in zip(ks, idx):
            g[k] = i
        out.append(tuple(g))
    return out


def _roots(mesh, axes: Sequence[str]) -> List[Coord]:
    """One coordinate of each group over ``axes``: its first member."""
    return [c for c in coords(mesh) if index(mesh, c, axes) == 0]


# -- sharded tensors -----------------------------------------------------------

def local_shape(shape: Sequence[int], sp: Spec, mesh) -> Tuple[int, ...]:
    entries = list(sp) + [None] * (len(shape) - len(sp))
    return tuple(d // _axes_size(mesh, e) for d, e in zip(shape, entries))


def spec_bytes(shape: Sequence[int], dtype: torch.dtype, sp: Spec,
               mesh) -> int:
    """Bytes one coordinate holds of a tensor of ``shape`` and ``dtype``
    laid out by ``sp`` (sanitized against the shape first)."""
    sp = sanitize_spec(sp, shape, mesh)
    n = 1
    for d in local_shape(shape, sp, mesh):
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _slices(shape, sp: Spec, mesh, c: Coord):
    entries = list(sp) + [None] * (len(shape) - len(sp))
    out = []
    for d, e in zip(shape, entries):
        axes = entry_axes(e)
        n = d // axes_size(mesh, axes)
        i = index(mesh, c, axes)
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


class Sharded:
    """A logical tensor of ``shape`` laid out on ``mesh`` by ``spec``:
    ``parts[c]`` is coordinate ``c``'s local tensor, on its device, of
    :func:`local_shape`.  Coordinates that hold the same slice (the
    spec replicates it over their axes) hold equal tensors, each its
    own."""

    def __init__(self, parts: Local, shape: Sequence[int], sp: Spec, mesh):
        self.parts = parts
        self.shape = tuple(int(d) for d in shape)
        self.spec = tuple(sp) + (None,) * (len(self.shape) - len(sp))
        self.mesh = mesh

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.parts.values())).dtype

    def __getitem__(self, i: int) -> "Sharded":
        """Index the leading dimension, which must be replicated (a stack
        of layers): each part is indexed alike."""
        if self.spec[0] is not None:
            raise IndexError("indexing a sharded leading dimension")
        return Sharded({c: t[i] for c, t in self.parts.items()},
                       self.shape[1:], self.spec[1:], self.mesh)

    def replica_axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec does not use: the parts are replicated
        over them."""
        used = {a for e in self.spec for a in entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def unique_parts(self) -> List[torch.Tensor]:
        """One part for each slice: together they hold every element
        once."""
        rep = self.replica_axes()
        return [t for c, t in self.parts.items()
                if index(self.mesh, c, rep) == 0]

    def map(self, fn) -> "Sharded":
        """``fn`` applied to every part; shape and spec unchanged."""
        return Sharded({c: fn(t) for c, t in self.parts.items()},
                       self.shape, self.spec, self.mesh)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")


def shard(tensor: torch.Tensor, mesh, sp: Spec,
          dtype: Optional[torch.dtype] = None) -> Sharded:
    """``tensor`` (on any device) laid out on ``mesh`` by ``sp`` (every
    entry must divide its dimension: sanitize first).  Each coordinate
    receives a copy of only its slice, in ``dtype`` if given."""
    shape = tuple(tensor.shape)
    sp = tuple(sp) + (None,) * (len(shape) - len(sp))
    if sanitize_spec(sp, shape, mesh) != sp:
        raise ValueError(f"spec {sp} does not divide shape {shape} on "
                         f"mesh {mesh.shape}")
    lshape = local_shape(shape, sp, mesh)
    parts = {}
    with torch.no_grad():
        for c in coords(mesh):
            parts[c] = torch.empty(lshape, dtype=dtype or tensor.dtype,
                                   device=device(mesh, c)).copy_(
                tensor[_slices(shape, sp, mesh, c)])
    return Sharded(parts, shape, sp, mesh)


def unshard(sh: Sharded, device_=None) -> torch.Tensor:
    """The logical tensor, on ``device_`` (the first coordinate's device
    by default), from one part of each slice; no gradient."""
    dev = device_ or device(sh.mesh, coords(sh.mesh)[0])
    out = torch.empty(sh.shape, dtype=sh.dtype, device=dev)
    with torch.no_grad():
        rep = sh.replica_axes()
        for c, t in sh.parts.items():
            if index(sh.mesh, c, rep) == 0:
                out[_slices(sh.shape, sh.spec, sh.mesh, c)] = t.to(dev)
    return out


def resident_bytes(*trees) -> Dict[str, object]:
    """Bytes of the :class:`Sharded` leaves of ``trees`` (nested dicts):
    what each coordinate holds (``per_coordinate``, row-major), what the
    specs give one coordinate (``from_specs``: the same for all), the
    logical total and the share of it a coordinate holds."""
    held: Dict[Coord, int] = {}
    want = logical = 0

    def walk(node):
        nonlocal want, logical
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
            return
        if not isinstance(node, Sharded):
            return
        for c, t in node.parts.items():
            held[c] = held.get(c, 0) + _nbytes(t)
        want += spec_bytes(node.shape, node.dtype, node.spec, node.mesh)
        logical += int(np.prod(node.shape, dtype=np.int64)) * \
            next(iter(node.parts.values())).element_size()

    for tree in trees:
        walk(tree)
    return {"per_coordinate": [held[c] for c in sorted(held)],
            "from_specs": want, "logical_total": logical,
            "share_of_total": want / logical if logical else 0.0}


# -- collectives ---------------------------------------------------------------

_BYTES: Dict[str, int] = {"all_gather": 0, "all_reduce": 0,
                          "reduce_scatter": 0}
_TRANSPOSED: Dict[str, int] = dict(_BYTES)
# collectives hook their outputs to count the transposes only inside
# counting_transposes(): elsewhere a step pays for no hook
_COUNT_TRANSPOSES = [False]


def collective_bytes() -> Dict[str, int]:
    """Bytes the collectives moved between coordinates since the last
    :func:`reset_collective_bytes`, by kind, as a ring algorithm moves
    them: an all-gather or a reduce-scatter over G coordinates moves
    (G - 1) shards into each, an all-reduce 2 (G - 1) / G of the
    tensor.  Forward calls only (a rematerialised forward counts
    again); autograd's transposes move as much again, transposed
    (:func:`transposed_bytes`)."""
    return dict(_BYTES)


def transposed_bytes() -> Dict[str, int]:
    """Bytes of the collectives autograd runs in a backward pass for the
    forward ones, by kind, since the last :func:`reset_collective_bytes`,
    for the collectives called inside :func:`counting_transposes`:
    counted when a gradient reaches a collective's output, one member at
    a time, by the same ring model.  An all-gather's transpose is a
    reduce-scatter of the gathered gradient, a reduce-scatter's an
    all-gather of the slices, a sum all-reduce's an all-reduce; a max
    all-reduce's is not counted (its gradient follows the maximum)."""
    return dict(_TRANSPOSED)


def reset_collective_bytes() -> None:
    for k in _BYTES:
        _BYTES[k] = 0
        _TRANSPOSED[k] = 0


@contextlib.contextmanager
def counting_transposes():
    """While the block runs, every collective hooks its outputs so that
    :func:`transposed_bytes` counts autograd's transposes of them (the
    backward may run inside the block or after it)."""
    before = _COUNT_TRANSPOSES[0]
    _COUNT_TRANSPOSES[0] = True
    try:
        yield
    finally:
        _COUNT_TRANSPOSES[0] = before


def _on_transpose(t: torch.Tensor, kind: str, n: int) -> None:
    """Count ``n`` bytes of ``kind`` when the backward reaches ``t``,
    inside :func:`counting_transposes`."""
    if _COUNT_TRANSPOSES[0] and t.requires_grad and torch.is_grad_enabled():
        def hook(grad):
            _TRANSPOSED[kind] += n
        t.register_hook(hook)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(x: Local, mesh, axes: Sequence[str], dim: int) -> Local:
    """Concatenate the parts of each group over ``axes`` along ``dim``,
    in index order; every member receives the whole."""
    G = axes_size(mesh, axes)
    if G == 1:
        return x
    out = {}
    for r in _roots(mesh, axes):
        members = group(mesh, r, axes)
        dev = device(mesh, r)
        full = torch.cat([x[g].to(dev) for g in members], dim)
        for g in members:
            out[g] = full.to(device(mesh, g))
            _BYTES["all_gather"] += (G - 1) * _nbytes(x[g])
            _on_transpose(out[g], "reduce_scatter", (G - 1) * _nbytes(x[g]))
    return out


def _reduce(x: Local, mesh, members, op: str) -> torch.Tensor:
    dev = device(mesh, members[0])
    acc = x[members[0]]
    for g in members[1:]:
        t = x[g].to(dev)
        acc = acc + t if op == "sum" else torch.maximum(acc, t)
    return acc


def all_reduce(x: Local, mesh, axes: Sequence[str], op: str = "sum"
               ) -> Local:
    """Sum (or ``op="max"``) the parts of each group over ``axes``, in
    index order and in their dtype (bf16 partials add in bf16); every
    member receives the result."""
    G = axes_size(mesh, axes)
    if G == 1:
        return x
    out = {}
    for r in _roots(mesh, axes):
        members = group(mesh, r, axes)
        total = _reduce(x, mesh, members, op)
        for g in members:
            out[g] = total.to(device(mesh, g))
            _BYTES["all_reduce"] += 2 * (G - 1) * _nbytes(x[g]) // G
            if op == "sum":
                _on_transpose(out[g], "all_reduce",
                              2 * (G - 1) * _nbytes(x[g]) // G)
    return out


def reduce_scatter(x: Local, mesh, axes: Sequence[str], dim: int) -> Local:
    """Sum the parts of each group over ``axes`` (in index order, in
    their dtype); member i receives the i-th of G equal slices of
    ``dim``."""
    G = axes_size(mesh, axes)
    if G == 1:
        return x
    out = {}
    for r in _roots(mesh, axes):
        members = group(mesh, r, axes)
        total = _reduce(x, mesh, members, "sum")
        n = total.shape[dim] // G
        for i, g in enumerate(members):
            out[g] = total.narrow(dim, i * n, n).to(device(mesh, g))
            _BYTES["reduce_scatter"] += (G - 1) * _nbytes(x[g]) // G
            _on_transpose(out[g], "all_gather", (G - 1) * _nbytes(x[g]) // G)
    return out


def split(x: Local, mesh, axes: Sequence[str], dim: int) -> Local:
    """Each coordinate keeps its slice of ``dim`` (the parts are equal
    over ``axes``): no data moves."""
    G = axes_size(mesh, axes)
    if G == 1:
        return x
    out = {}
    for c, t in x.items():
        n = t.shape[dim] // G
        out[c] = t.narrow(dim, index(mesh, c, axes) * n, n)
    return out


@dataclass(frozen=True)
class Placement:
    """Where a restored checkpoint leaf goes: ``mesh`` and a spec whose
    entries divide the leaf's dims (``checkpoint.restore(shardings=)``)."""

    mesh: object
    spec: Spec
