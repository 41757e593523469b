"""Meshes for the LM, the JAX package's ``launch/mesh.py``: the production
mesh the dry run traces, and host meshes.

The JAX package forces N host devices with ``XLA_FLAGS`` before JAX
starts (its ``launch/env.py``); torch reads no such flag, and a
:class:`~repro_torch.core.distributed.Mesh` may name one device more
than once, so ``make_host_mesh(shards=N)`` is that: N coordinates on
one device, each with its own tensors (4 x the card on one H100, or 4
x the host in the CPU tests).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..core.distributed import Mesh
from ..kernels.ops import resolve_device


def make_production_mesh(multi_pod: bool = False, device="meta") -> Mesh:
    """The JAX package's production mesh: ``(data 16, model 16)`` = 256
    coordinates, or with ``multi_pod`` a leading ``pod`` axis of 2 = 512
    (``pod`` composes with ``data`` for hierarchical data parallelism),
    over one repeated ``device``, as ``make_host_mesh(shards=)`` builds a
    mesh.  The default ``"meta"`` holds shapes only: the dry run
    (``launch/dryrun.py``) traces a step on it with no allocation."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    return Mesh(np.full(shape, dev, dtype=object), axes)


def make_host_mesh(model: int = 1, shards: Optional[int] = None,
                   device=None) -> Mesh:
    """A ``("data", "model")`` mesh with a model axis of ``model``: over
    every visible device of ``device``'s kind (every CUDA card, or the
    one host), or over ``shards`` repeats of that one device.
    ``device=None`` means ``"cuda"`` and raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if shards is None:
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])
    else:
        devs = [dev] * shards
    if model < 1 or len(devs) % model:
        raise ValueError(f"a model axis of {model} does not divide "
                         f"{len(devs)} devices")
    data = len(devs) // model
    return Mesh([devs[i * model:(i + 1) * model] for i in range(data)],
                ("data", "model"))


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model-axis", type=int, default=None,
                    help="run on a (data, model) mesh with this model axis")
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh coordinates: repeats of the one device "
                         "(default: every visible card)")


def mesh_from_args(args):
    """``make_host_mesh``'s mesh when either mesh flag is given, else
    None (one device)."""
    if args.model_axis is None and args.shards is None:
        return None
    return make_host_mesh(model=args.model_axis or 1, shards=args.shards,
                          device=args.device)
