"""Checkpointing of engine state: msgpack + zlib (or zstd), atomic,
elastic — the JAX package's ``checkpoint.py`` format, written and read
without JAX.

Design (as in the JAX package):
  * checkpoints store *logical* (unsharded) arrays keyed by their path in
    the state tree, plus a manifest (step, codec, shapes, dtypes, content
    hashes) — restoring onto a DIFFERENT mesh is building the engine on
    that mesh and loading the restored state into it;
  * writes are atomic: tmp file + fsync + rename, manifest last, so a
    preemption mid-write can never corrupt the latest checkpoint;
  * retention: the ``keep_n`` newest checkpoints are kept, older are
    pruned.

The on-disk layout is the JAX package's, so each package restores the
other's checkpoints: ``step_XXXXXXXXXX/manifest.json`` and
``arrays.msgpack.zst``, a compressed msgpack map of array key -> raw
bytes.  Array keys are the JAX package's tree paths: dict keys in sorted
order, list and tuple indices, joined by ``/``.  The port carries its own
msgpack codec for that map (str keys, bin values), since the GPU
machine has no ``msgpack``; it writes ``zlib`` by default and reads
``zstd`` through ``zstandard`` when that is installed, raising a clear
error when it is not.  Neither module is imported unless a zstd
checkpoint is read or written.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .sharding import shard

DEFAULT_CODEC = "zlib"


def _zstandard():
    try:
        import zstandard
    except ImportError:
        raise RuntimeError(
            "checkpoint uses the zstd codec but zstandard is not installed "
            "in this environment (the port writes zlib by default)") from None
    return zstandard


def _compress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return _zstandard().ZstdCompressor(level=3).compress(blob)
    if codec == "zlib":
        return zlib.compress(blob, level=3)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return _zstandard().ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


# -- msgpack: a map of str -> bin, as ``msgpack.packb(use_bin_type=True)``
# writes it, and what the JAX package's files hold ---------------------------

# (fix form: (first type byte, its largest length + 1) or None; the type
# bytes of the 8/16/32-bit length forms, None where there is none)
_MAP = ((0x80, 16), (None, 0xDE, 0xDF))
_STR = ((0xA0, 32), (0xD9, 0xDA, 0xDB))
_BIN = (None, (0xC4, 0xC5, 0xC6))
_WIDTHS = ((">B", 1), (">H", 2), (">I", 4))


def _head(n: int, kind) -> bytes:
    """The msgpack header of a map, str or bin of length ``n``: the
    shortest form that holds it, as ``msgpack`` picks."""
    fix, codes = kind
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, (fmt, size) in zip(codes, _WIDTHS):
        if code is not None and n < 1 << (8 * size):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _read_head(blob: bytes, pos: int, kind) -> Tuple[int, int]:
    """(length, position after the header) of the header at ``pos``."""
    fix, codes = kind
    b = blob[pos]
    if fix is not None and fix[0] <= b < fix[0] + fix[1]:
        return b - fix[0], pos + 1
    for code, (fmt, size) in zip(codes, _WIDTHS):
        if code is not None and b == code:
            return struct.unpack_from(fmt, blob, pos + 1)[0], pos + 1 + size
    raise ValueError(f"unsupported msgpack type byte {b:#04x} at {pos}")


def packb(payload: Dict[str, bytes]) -> bytes:
    """``payload`` (str keys, bytes values) as msgpack, byte for byte
    what ``msgpack.packb(payload, use_bin_type=True)`` gives."""
    out = [_head(len(payload), _MAP)]
    for key, val in payload.items():
        k = key.encode("utf-8")
        out += [_head(len(k), _STR), k, _head(len(val), _BIN), bytes(val)]
    return b"".join(out)


def unpackb(blob: bytes) -> Dict[str, bytes]:
    """Read a msgpack map of str -> bin (or str) values, as :func:`packb`
    and ``msgpack`` write it."""
    n, pos = _read_head(blob, 0, _MAP)
    out: Dict[str, bytes] = {}
    for _ in range(n):
        size, pos = _read_head(blob, pos, _STR)
        key = blob[pos:pos + size].decode("utf-8")
        pos += size
        size, pos = _read_head(blob, pos,
                               _BIN if blob[pos] in _BIN[1] else _STR)
        out[key] = bytes(blob[pos:pos + size])
        pos += size
    if pos != len(blob):
        raise ValueError("trailing bytes after the msgpack map")
    return out


# -- state trees ----------------------------------------------------------------

def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's order: dict keys sorted,
    list and tuple items by index, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(tree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_unflatten(v, leaves, prefix + (str(i),))
                 for i, v in enumerate(tree)]
        return type(tree)(items) if isinstance(tree, list) else tuple(items)
    return leaves["/".join(prefix)]


def _leaf_bytes(leaf) -> Tuple[bytes, List[int], str]:
    """Raw bytes, shape and dtype name of a leaf: a tensor on any device,
    a numpy array or scalar, or a Python number."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return raw, list(t.shape), str(t.dtype).split(".")[-1]
    arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def _tensor(buf: bytes, shape: List[int], dtype: str,
            device: torch.device) -> torch.Tensor:
    dt = _torch_dtype(dtype)
    if not buf:
        return torch.empty(shape, dtype=dt, device=device)
    return torch.frombuffer(bytearray(buf), dtype=dt).reshape(shape) \
        .to(device)


# -- save / restore ----------------------------------------------------------------

def save(ckpt_dir: str, step: int, state, extra: Optional[Dict[str, Any]] = None,
         keep_n: int = 3, codec: Optional[str] = None) -> str:
    """Atomically write checkpoint ``step`` of ``state`` (a tree of dicts,
    lists and tuples over tensors, numpy arrays and numbers).  ``extra``:
    json-serializable (data-pipeline position, config fingerprint...).
    ``codec``: "zlib" (default) or "zstd" (needs ``zstandard``)."""
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:010d}"
    tmp = root / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    codec = codec or DEFAULT_CODEC
    manifest = {"step": step, "created": time.time(), "codec": codec,
                "arrays": {}, "extra": extra or {}}
    payload = {}
    for key, leaf in _flatten(state):
        buf, shape, dtype = _leaf_bytes(leaf)
        manifest["arrays"][key] = {
            "shape": shape, "dtype": dtype,
            "sha256": hashlib.sha256(buf).hexdigest(),
        }
        payload[key] = buf
    blob = _compress(packb(payload), codec)
    with open(tmp / "arrays.msgpack.zst", "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    # manifest LAST — its presence marks the checkpoint complete
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    # retention
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_n]:
        shutil.rmtree(root / f"step_{s:010d}", ignore_errors=True)
    return str(final)


def all_steps(ckpt_dir: str) -> List[int]:
    root = Path(ckpt_dir)
    if not root.exists():
        return []
    out = []
    for p in root.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            out.append(int(p.name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, target_state, step: Optional[int] = None,
            device=None, verify: bool = False, shardings=None):
    """Restore into the structure of ``target_state`` (a tree whose leaves
    have a ``shape``: tensors, numpy arrays, or any stand-in).  Returns
    (state, extra), the state's leaves tensors on ``device`` (``None``
    means ``"cuda"``, see :func:`repro_torch.kernels.ops.resolve_device`).
    ``shardings``: optional matching tree of
    :class:`~repro_torch.sharding.Placement` (mesh, spec) or ``None``: a
    placed leaf comes back :class:`~repro_torch.sharding.Sharded` on that
    mesh, each coordinate given its slice of the bytes read (elastic
    resharding: the mesh and layout are a restore-time choice).  Elastic
    restore of an engine is building it on the mesh and loading this
    state into it (``GraphStats.from_state``, ``load_overlay``)."""
    from .kernels.ops import resolve_device
    dev = resolve_device(device)
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    # pre-codec manifests were always zstd-compressed
    codec = manifest.get("codec", "zstd")
    payload = unpackb(_decompress((d / "arrays.msgpack.zst").read_bytes(),
                                  codec))
    leaves = {}
    for key, tgt in _flatten(target_state):
        meta = manifest["arrays"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing array {key!r}")
        buf = payload[key]
        if verify and hashlib.sha256(buf).hexdigest() != meta["sha256"]:
            raise IOError(f"checksum mismatch for {key!r}")
        shape = list(meta["shape"])
        want = list(tgt.shape) if hasattr(tgt, "shape") else \
            list(np.shape(tgt))
        if shape != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(shape)} != "
                             f"target {tuple(want)}")
        at = placed.get(key)
        if at is None:
            leaves[key] = _tensor(buf, shape, meta["dtype"], dev)
        else:
            leaves[key] = shard(_tensor(buf, shape, meta["dtype"],
                                        torch.device("cpu")), at.mesh,
                                at.spec)
    return _unflatten(target_state, leaves), manifest["extra"]
