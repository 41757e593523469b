"""Flight recorder: an always-on bounded ring buffer of settled-query
records, plus a versioned JSONL workload format for capture & replay.

Every ticket the :class:`repro_torch.core.scheduler.SlotScheduler` settles —
completed, timed out, failed, or shed at admission — appends one compact
dict here.  The buffer is a fixed-capacity ring: appends are O(1), old
records are overwritten (and counted in :attr:`dropped`) once the
capacity is reached, so leaving the recorder on in production costs a
bounded, small amount of memory and no I/O.

``dump()`` serializes the buffer as a **versioned JSONL workload file**:

    line 1    — header object ``{"version": 1, "kind": "rpq-flight",
                "capacity": ..., "appended": ..., "dropped": ...,
                "records": N, "graph": {...}?}``
    lines 2.. — one record per line, keys sorted (byte-stable)

``benchmarks/replay.py`` re-executes such a capture open-loop against
either engine and asserts result-count parity — any production capture
becomes a benchmark.  The optional ``graph`` header field carries a
fixture spec (``{"fixture": name, "args": [...], "seed": ...}``) so the
replay harness can rebuild the graph the workload ran against.

Stdlib-only on purpose: the recorder must import cleanly in the
minimal-dependency CI leg and add nothing to the serving hot path
beyond one method call and one dict per settled ticket.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["RECORD_VERSION", "RECORD_KIND", "REQUIRED_KEYS",
           "FlightRecorder", "load", "validate_header", "validate_record"]

RECORD_VERSION = 1
RECORD_KIND = "rpq-flight"

# Every record carries this exact key set regardless of status — replay
# and downstream tooling never need per-status schemas.
REQUIRED_KEYS = frozenset({
    "ts",             # scheduler-clock timestamp of the settle
    "key",            # canonical regex key (normalized expr); None when shed
    "expr",           # raw query expression
    "subject",        # bound subject node id, or None
    "obj",            # bound object node id, or None
    "limit",          # result limit, or None
    "plan",           # planner mode ("forward"/"reverse"/"split"/...), "" if unplanned
    "epoch",          # graph epoch pinned at admission, or None
    "status",         # "ok" | "timeout" | "error" | "shed"
    "results",        # result-pair count (pre-limit), or None
    "supersteps",     # superstep count, or None
    "queue_wait_s",   # latency attribution: submit -> admit
    "service_s",      # admit -> settle
    "supersteps_s",   # time inside engine supersteps
    "preempted",      # deadline preemption flag
    "backpressure",   # shed at admission (queue full)
    "cache_hit",      # settled from the result cache without execution
})


class FlightRecorder:
    """Bounded ring buffer of settled-query records.

    ``capacity <= 0`` disables retention entirely (every append counts
    as a drop) — used to price the recorder's overhead in
    ``benchmarks/serving.py``.
    """

    __slots__ = ("capacity", "appended", "dropped", "_buf", "_head")

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self.appended = 0            # total appends ever
        self.dropped = 0             # records lost to overwrite (or capacity<=0)
        self._buf: List[Dict[str, Any]] = []
        self._head = 0               # index of the oldest record once full

    def append(self, record: Dict[str, Any]) -> None:
        self.appended += 1
        if self.capacity <= 0:
            self.dropped += 1
            return
        if len(self._buf) < self.capacity:
            self._buf.append(record)
            return
        self._buf[self._head] = record
        self._head = (self._head + 1) % self.capacity
        self.dropped += 1

    @property
    def occupancy(self) -> int:
        return len(self._buf)

    def records(self) -> List[Dict[str, Any]]:
        """Records oldest-first (unwinds the ring)."""
        return self._buf[self._head:] + self._buf[:self._head]

    def clear(self) -> None:
        self._buf = []
        self._head = 0
        self.appended = 0
        self.dropped = 0

    # -- serialization -------------------------------------------------------
    def header(self, graph: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        h: Dict[str, Any] = {
            "version": RECORD_VERSION,
            "kind": RECORD_KIND,
            "capacity": self.capacity,
            "appended": self.appended,
            "dropped": self.dropped,
            "records": len(self._buf),
        }
        if graph is not None:
            h["graph"] = graph
        return h

    def dumps(self, graph: Optional[Dict[str, Any]] = None) -> str:
        lines = [json.dumps(self.header(graph), sort_keys=True)]
        lines.extend(json.dumps(r, sort_keys=True) for r in self.records())
        return "\n".join(lines) + "\n"

    def dump(self, path: str, graph: Optional[Dict[str, Any]] = None) -> str:
        with open(path, "w") as f:
            f.write(self.dumps(graph))
        return path


def validate_header(header: Dict[str, Any]) -> None:
    if header.get("kind") != RECORD_KIND:
        raise ValueError(f"not a flight-recorder file: kind={header.get('kind')!r}")
    if header.get("version") != RECORD_VERSION:
        raise ValueError(f"unsupported workload version {header.get('version')!r} "
                         f"(this reader handles {RECORD_VERSION})")
    for k in ("capacity", "appended", "dropped", "records"):
        if k not in header:
            raise ValueError(f"workload header missing {k!r}")


def validate_record(record: Dict[str, Any]) -> None:
    missing = REQUIRED_KEYS - record.keys()
    if missing:
        raise ValueError(f"workload record missing keys {sorted(missing)}")
    if record["status"] not in ("ok", "timeout", "error", "shed"):
        raise ValueError(f"bad record status {record['status']!r}")


def load(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Read and schema-validate a workload file -> (header, records)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"empty workload file: {path}")
    header = json.loads(lines[0])
    validate_header(header)
    records = [json.loads(ln) for ln in lines[1:]]
    if len(records) != header["records"]:
        raise ValueError(f"workload header says {header['records']} records, "
                         f"file has {len(records)}")
    for r in records:
        validate_record(r)
    return header, records
