"""Per-op cost counting for the dry run: the port's counterpart of the JAX
package's ``launch/hlo_cost.py`` and ``launch/hlo_analysis.py``.

The JAX package walks the compiled HLO.  The port has no compiler
between its eager ops and the card, so it counts the ops themselves, on
meta or real tensors, with a ``TorchDispatchMode`` (:class:`CostMode`):

  * **FLOPs**: a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a
    convolution, a fused attention) by ``torch.utils.flop_counter``'s
    formulas, ``2·|out|·K``; a pointwise op (a cast included) or a
    ``_foreach_`` op as ``|out|``, and a reduction as the elements it
    reads, one FLOP an element, transcendentals too, as ``hlo_cost.py``
    counts an HLO elementwise op and an HLO ``reduce``;
  * **bytes**: the inputs plus the outputs of every op that is not a
    view or a bare allocation (an in-place op reads and writes its
    target).  That is the eager port's real, unfused traffic, op by op,
    not what a fusing compiler would move;
  * **collectives**: wire bytes a device by kind, from
    :mod:`repro_torch.sharding`'s counts of the forward collectives and
    of the transposes autograd runs for them
    (``sharding.collective_bytes``, ``sharding.transposed_bytes``), by
    the reference's ring model (:func:`wire_bytes`): all-reduce
    ``2·size·(n−1)/n``, all-gather and reduce-scatter ``size·(n−1)/n``.

A mesh runs every coordinate in turn in one process, so a count over a
step is the sum over the coordinates; the coordinates run the same ops
on the same local shapes, and a device's share is the sum over their
number.

On the meta device (shapes only) an op whose output is new (not a view,
not in place) is answered from a cache keyed by its arguments' shapes,
strides, dtypes and scalars: the coordinates repeat each other's ops,
and a meta kernel written in Python costs a few hundred microseconds a
call.  :func:`count_saved` counts the bytes autograd keeps for the
backward.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# the reference's names for the kinds (HLO's), by the port's
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter"}

# ops that read every element of their input and write fewer
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.prod, aten.norm, aten.linalg_vector_norm,
               aten.var, aten.std, aten.logsumexp, aten.any, aten.all,
               aten.argmax, aten.argmin, aten.cumsum, aten.var_mean,
               aten._log_softmax, aten._softmax}
# allocations: no element is read or written
_ALLOCATIONS = {aten.empty, aten.empty_strided, aten.empty_like,
                aten.new_empty, aten.new_empty_strided}


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Bytes a participant sends for one collective over ``n`` devices
    (``size``: the gathered output, the scattered input, the reduced
    tensor), the reference's model (``hlo_analysis.py``); ``kind`` in
    HLO's spelling or the port's."""
    kind = KINDS.get(kind, kind)
    n = max(2, n)
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2 * size * frac
    if kind == "collective-permute":
        return float(size)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return size * frac
    raise ValueError(f"unknown collective {kind!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _key(x):
    t = type(x)
    if t is tuple or t is list:
        return (t, tuple([_key(y) for y in x]))
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if t is dict:
        return (t, tuple([(k, _key(v)) for k, v in x.items()]))
    return (t, x)


def _meta_only(x) -> bool:
    return all(t.device.type == "meta" for t in _tensors(x))


def _kind(func) -> str:
    """How :class:`CostMode` treats an op: a view, an op that writes an
    argument, a list (``_foreach_``) op, or one whose outputs are new."""
    if func.is_view:
        return "view"
    if func._schema.is_mutable:
        return "mutable"
    if func._overloadpacket.__name__.startswith("_foreach_"):
        return "foreach"
    return "fresh"


def _describe(out):
    """What rebuilds ``out`` on the meta device."""
    if isinstance(out, torch.Tensor):
        return ("t", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return ("s", type(out), tuple(_describe(o) for o in out))
    return ("v", out)


def _rebuild(desc):
    if desc[0] == "t":
        return torch.empty_strided(desc[1], desc[2], dtype=desc[3],
                                   device="meta")
    if desc[0] == "s":
        return desc[1](_rebuild(d) for d in desc[2])
    return desc[1]


def _flops(func, args, kwargs, out) -> int:
    packet = func._overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    name = packet.__name__
    if name.startswith("_foreach_"):
        if name.startswith("_foreach_norm"):
            return sum(t.numel() for t in _tensors(args[0]))
        return sum(t.numel() for t in _tensors(
            out if out is not None else args[0]))
    if packet in _REDUCTIONS:
        return sum(t.numel() for t in _tensors(args[:1]))
    if packet is aten._to_copy:
        return out.numel() if out.dtype != args[0].dtype else 0
    if torch.Tag.pointwise in func.tags:
        return sum(t.numel() for t in _tensors(out))
    return 0


def _bytes(func, args, kwargs, out) -> int:
    if func._overloadpacket in _ALLOCATIONS:
        return 0
    read = sum(_nbytes(t) for t in _tensors((args, kwargs)))
    wrote = sum(_nbytes(t) for t in _tensors(out)) if out is not None \
        else sum(_nbytes(t) for t in _tensors(args[:1]))
    return read + wrote


@dataclass
class OpCounts:
    """What :class:`CostMode` counted: FLOPs (dots apart), bytes, ops;
    Python ints, exact at any size."""

    flops: int = 0
    dot_flops: int = 0
    bytes: int = 0
    ops: int = 0


class CostMode(TorchDispatchMode):
    """Counts FLOPs and bytes of every op dispatched under it (see the
    module note), into ``self.counts``.  Views count as ops of no
    cost."""

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()
        self._cost: Dict = {}      # key -> (flops, dot?, bytes)
        self._meta: Dict = {}      # key -> output description (meta)
        self._kinds: Dict = {}     # op -> _kind(op)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.counts
        c.ops += 1
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func)
        if kind == "view":
            return func(*args, **kwargs)
        try:        # the key holds every tensor's device: a hit is meta
            key = (func, _key(args), _key(kwargs) if kwargs else None)
            desc = self._meta.get(key)
        except TypeError:
            key = desc = None
        if desc is not None:
            out = _rebuild(desc)
        elif kind == "foreach" and args and args[0] and \
                _meta_only((args, kwargs)):
            # a list op on meta: each output like its input (a norm: a
            # scalar), built at once, not by the per-tensor meta kernels
            scalar = func._overloadpacket.__name__.startswith(
                "_foreach_norm")
            out = [torch.empty((), dtype=t.dtype, device="meta") if scalar
                   else torch.empty_strided(t.shape, t.stride(),
                                            dtype=t.dtype, device="meta")
                   for t in args[0]]
        else:
            out = func(*args, **kwargs)
            if key is not None and kind == "fresh" and _meta_only(out):
                self._meta[key] = _describe(out)
        cost = self._cost.get(key) if key is not None else None
        if cost is None:
            cost = (_flops(func, args, kwargs, out),
                    func._overloadpacket in flop_registry,
                    _bytes(func, args, kwargs, out))
            if key is not None:
                self._cost[key] = cost
        flops, dot, nbytes = cost
        c.flops += flops
        if dot:
            c.dot_flops += flops
        c.bytes += nbytes
        return out


@contextlib.contextmanager
def count_saved(exclude=()):
    """Counts the bytes autograd keeps for the backward while the block
    runs: every tensor a saved-tensors hook packs, and the arguments of
    every rematerialised block (``models.transformer.REMAT_OBSERVERS``:
    under ``torch.utils.checkpoint`` those are all it keeps).  Each
    storage counts once, at its full size; the storages of ``exclude``
    (the parameters, which are resident anyway) do not count.  Yields a
    dict whose ``"bytes"`` holds the total."""
    from ..models import transformer
    seen = {_storage(t) for t in _tensors(exclude)}
    total = {"bytes": 0, "tensors": 0}

    def add(t):
        if not isinstance(t, torch.Tensor):
            return
        s = _storage(t)
        if s in seen:
            return
        seen.add(s)
        total["bytes"] += t.untyped_storage().nbytes()
        total["tensors"] += 1

    def pack(t):
        add(t)
        return t

    def observe(args):
        for t in _tensors(args):
            add(t)

    transformer.REMAT_OBSERVERS.append(observe)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yield total
    finally:
        transformer.REMAT_OBSERVERS.remove(observe)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata
