"""Hand-written CUDA kernels for Hopper, with their plain PyTorch
versions.

:mod:`.ops` is the public API; the module of each kernel holds its
wrapper (``<name>_cuda``), its plain version and its launch counter, and
``csrc/`` holds the CUDA sources that :mod:`._build` compiles on first
use.

``KERNELS`` names the kernel-backed entry points of :mod:`.ops`,
mirroring the JAX package's ``PALLAS_KERNELS``: each has a ``<name>_ref``
plain version in :mod:`.ref` and a parity test in
``tests/test_torch_kernels.py``.
"""
import importlib
from typing import Dict

KERNELS = ("nfa_step",)


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel since the last reset."""
    return {k: importlib.import_module(f"{__name__}.{k}").launches
            for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        importlib.import_module(f"{__name__}.{k}").launches = 0


__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]
