"""Hand-written CUDA kernels for Hopper, with their plain PyTorch
versions.

:mod:`.ops` is the public API; the module of each kernel holds its
wrapper (``<name>_cuda``), its plain version and its launch counter, and
``csrc/`` holds the CUDA sources that :mod:`._build` compiles on first
use.

``KERNELS`` names the kernel-backed entry points of :mod:`.ops`,
mirroring the JAX package's ``PALLAS_KERNELS``: each has a ``<name>_ref``
plain version in :mod:`.ref` and a parity test in
``tests/test_torch_kernels.py``.  ``KERNEL_MODULES`` maps each to the
module whose ``launches`` dict counts its CUDA launches.
"""
import importlib
from typing import Dict

KERNEL_MODULES = {
    "nfa_step": "nfa_step",
    "packed_superstep": "packed_superstep",
    "segment_or": "segment_or",
    "segmented_or_scan": "segment_or",
    "superblock_popcounts": "rank_popcount",
    "rank1": "rank_popcount",
}
KERNELS = tuple(KERNEL_MODULES)


def _counter(kernel: str) -> Dict[str, int]:
    return importlib.import_module(
        f"{__name__}.{KERNEL_MODULES[kernel]}").launches


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel since the last reset."""
    return {k: _counter(k)[k] for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        _counter(k)[k] = 0


def build_all() -> None:
    """Compile every kernel (one ``nvcc`` a source, all started together)
    and load its library, so that no later launch waits for the
    compiler."""
    from . import _build
    _build.build()
    for name in _build.SOURCES:
        _build.library(name)


__all__ = ["KERNELS", "KERNEL_MODULES", "build_all", "launch_counts",
           "reset_launch_counts"]
