"""Build the CUDA kernels from ``csrc/`` with ``nvcc`` and bind them
with ``ctypes``.

Each source is compiled on first use into a shared library with a plain
C interface under ``kernels/_build/`` (ignored by git).  The library's
name carries a digest of its source, so an edited kernel is rebuilt and
a stale one is never loaded.  :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them.  Nothing here runs at
import time: the CPU-only test environment has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# kernel name -> (source file, {C function: (argtypes, restype)})
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SOURCES = {
    "nfa_step": ("nfa_step.cu", {
        "nfa_step_launch": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    }),
    "packed_superstep": ("packed_superstep.cu", {
        "packed_superstep_launch": ([_P] * 6 + [_I] + [_P] * 7 + [_L]
                                    + [_I] * 7 + [_P], _I),
    }),
    "segment_or": ("segment_or.cu", {
        "segment_or_launch": ([_P, _P, _P, _L, _I, _I, _P], _I),
        "segmented_or_scan_scratch_words": ([_L, _I], _L),
        "segmented_or_scan_launch": ([_P, _P, _P, _P, _L, _I, ctypes.c_uint,
                                      _P], _I),
    }),
    "rank_popcount": ("rank_popcount.cu", {
        "superblock_popcounts_launch": ([_P, _P, _L, _P], _I),
        "rank_directory_scratch_words": ([_L], _L),
        "rank_directory_launch": ([_P, _P, _P, _L, ctypes.c_uint, _P], _I),
        "rank1_launch": ([_P, _P, _P, _P, _L, _L, _L, _P], _I),
    }),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name -> {"seconds": build wall time, "ptxas": compiler report}
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name][0]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together.  Returns name -> path."""
    names = list(SOURCES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[n][0])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        # atomic rename: a concurrent loader never sees a partial file
        os.replace(tmp, paths[n])
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0,
                        "ptxas": out.strip()}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (argtypes, restype) in SOURCES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib


# -- scratch of the one-launch scans ------------------------------------------

class SeqScratch:
    """Scratch of a kernel that chains its blocks by decoupled look-back
    through sequence-stamped descriptors: one zeroed int64 tensor per
    (device, stream), so two streams never share one, and the next
    launch's sequence number.  A new scratch is zero; the stamps spare
    every later launch a clear, until they wrap at ``LIMIT``, when the
    scratch is cleared once."""

    LIMIT = 1 << 31

    def __init__(self) -> None:
        self._entries: Dict[tuple, list] = {}

    def take(self, device: torch.device, stream: int, words: int):
        """(scratch of at least ``words`` int64 words, sequence number)."""
        key = (device.type, device.index, stream)
        entry = self._entries.get(key)
        if entry is None or entry[0].numel() < words:
            entry = self._entries[key] = [
                torch.zeros(words, dtype=torch.int64, device=device), 0]
        entry[1] += 1
        if entry[1] >= self.LIMIT:
            entry[0].zero_()
            entry[1] = 1
        return entry[0], entry[1]

    def drop(self, device: torch.device, stream: int) -> None:
        """Forget a scratch whose launch failed (its state is unknown)."""
        self._entries.pop((device.type, device.index, stream), None)


# -- checks the wrappers share ------------------------------------------------

def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors on a CUDA device (the wrappers
    check first that all are on one device)."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name} wants CUDA tensors, got "
                         f"{tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} wants contiguous tensors")


def check_cpu(name: str, t: torch.Tensor) -> None:
    """A plain version runs on CPU tensors only."""
    if t.device.type != "cpu":
        raise ValueError(f"{name} runs on CPU tensors, got {t.device}")


def check_launch(rc: int, name: str) -> None:
    """Raise on the cudaError_t a launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
