#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each (plus the raw ``nvidia-smi`` name/power line):

  0. device + build: the card, and the seconds ``nvcc`` took to build
     every kernel from ``src/repro_torch/kernels/csrc`` (into the
     git-ignored ``kernels/_build/``), with the compiler's register report;
  1. every kernel against its plain PyTorch version, bit for bit, on a
     sweep of shapes, each timed with CUDA events (median of 20 runs);
  2. the main path at full size: ``make_engine`` over
     ``scale_free_graph(200_000, 64, 2_000_000, seed=7)`` answers a batch
     of 2,048 one-endpoint requests through ``eval_many`` on the card;
     the answers and work counters must equal a host run of the same
     engine with the kernel's plain version, and the answers a host run
     with scalar tables; a profiled rerun gives the card's busy share;
     two of the hub closures left out of the batch are timed under a
     1 s deadline, to show how far past it they run;
  3. serving: a ``SlotScheduler`` over a CUDA engine on the same ring,
     launching the kernel from one task up, answers 16 requests admitted
     one at a time with a live ``add_edges`` in between; each answer
     must equal ``eval_many`` at its ticket's epoch, and the kernel must
     have launched;
  4. oracle: a smaller graph's answers on the card must equal the
     brute-force product-graph oracle.

Each of phases 2-4 sets the launch counts to 0 just before it and
prints them just after.

Then the ``kernels`` line (launches on the main path, times at the
largest main-path launch) and, last, the ``ok`` line, right after it.  Any mismatch or
exception exits non-zero before the ``ok`` line.  Without a CUDA device,
or without the ``repro_torch`` package beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks at 700 W.  HBM bytes/s: NVIDIA's data sheet.  32-bit
# ORs/s: 64 results per clock per SM for 32-bit AND/OR/XOR at compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of native
# arithmetic instructions), times 132 SMs at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

SWEEP = [(1, 1), (5, 4), (700, 33), (1024, 64), (513, 32), (2048, 7)]
MAIN_N = (64, 1_000, 16_384)
MAIN_S = (11, 700, 4_096)
# wide tables (213 KB and 246 KB, W = 41 and 44 words): past a block's
# 227 KB of shared memory, and several 8-word output chunks per row
EDGE_S = (1_300, 1_400)

# Requests per eval_many batch.  On this graph the one-endpoint requests
# that finish at all are tiny (a handful of activations each), so only a
# log-sized batch merges supersteps of >= 64 tasks, the kernel's
# threshold; 32 requests never launch it (see PERF.md).
BATCH = 2048
BATCH_DEADLINE_S = 60.0              # the paper's per-query timeout
SCAN_CAP = 2_000                     # triples one probe superstep may scan
# skipped hub closures rerun under a short deadline, to time its overrun
OVERRUN_PROBES = 2
OVERRUN_DEADLINE_S = 1.0
OVERRUN_CAP_S = 60.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def time_ms(fn, runs: int = 20) -> float:
    """Median device time of ``fn`` over ``runs`` runs, CUDA events.  A
    sleep kernel queued first keeps the card busy while the host
    enqueues the events and the work, so host latency stays out."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def nfa_bound(X, S: int):
    """(bound_ms, bound_by) of one nfa_step call on these inputs.  Bytes:
    X read once, Y written once, and once each table row that a set bit
    of X below S selects: (2*N*W + rows*W) * 4.  Operations: the 32-bit
    ORs this data needs, W per set bit below S."""
    import torch
    from repro_torch.kernels.ref import widen
    N, W = X.shape
    x = widen(X[:, :(S + 31) // 32])
    shifts = torch.arange(32, device=x.device)
    selects = ((x.unsqueeze(-1) >> shifts) & 1).bool().reshape(N, -1)[:, :S]
    set_bits = int(selects.sum())
    rows = int(selects.any(0).sum())
    t_bytes = (2 * N * W + rows * W) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = set_bits * W / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    from repro_torch.kernels.ref import widen
    return int((widen(a) - widen(b)).abs().max()) if a.numel() else 0


# -- phase 0 -----------------------------------------------------------------
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": v["seconds"],
                          "ptxas": v["ptxas"].splitlines()[-6:]}
                      for n, v in _build.BUILD_LOG.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})


# -- phase 1 -----------------------------------------------------------------
def _words(rng, N, S, density=None):
    """uint32 words [N, ceil(S/32)] with bits >= S clear: uniformly random,
    or with about ``density`` set bits per row (main-path task masks
    D & B[p] are sparse)."""
    import numpy as np
    W = (S + 31) // 32
    if density is None:
        arr = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    else:
        arr = np.zeros((N, W), dtype=np.uint32)
        for _ in range(density):
            j = rng.integers(0, S, N)
            np.bitwise_or.at(arr, (np.arange(N), j // 32),
                             (np.uint32(1) << (j % 32).astype(np.uint32)))
    if S % 32:
        arr[:, -1] &= np.uint32((1 << (S % 32)) - 1)
    return arr


def phase_kernels(errs: list):
    import numpy as np
    from repro_torch.kernels import nfa_step as knfa
    from repro_torch.kernels.ops import words_to_tensor
    from repro_torch.kernels.ref import nfa_step_ref
    rng = np.random.default_rng(2024)
    shapes = [(N, S, None) for N, S in SWEEP]
    shapes += [(N, S, 3) for N in MAIN_N for S in MAIN_S]
    shapes += [(1_000, S, 3) for S in EDGE_S]
    for N, S, density in shapes:
        X = words_to_tensor(_words(rng, N, S, density), "cuda")
        bwd = words_to_tensor(_words(rng, S, S), "cuda")
        err = max_abs_err(knfa.nfa_step_cuda(X, bwd), nfa_step_ref(X, bwd))
        errs.append(err)
        if err:
            fail(f"nfa_step differs from its plain version at N={N} S={S}")
        bound, by = nfa_bound(X, S)
        emit({"phase": "kernel_check", "kernel": "nfa_step", "N": N, "S": S,
              "W": X.shape[1], "set_bits_per_row": density or "uniform",
              "max_abs_err": err,
              "ms": time_ms(lambda: knfa.nfa_step_cuda(X, bwd)),
              "plain_ms": time_ms(lambda: nfa_step_ref(X, bwd)),
              "bound_ms": bound, "bound_by": by})


# -- phase 2 -----------------------------------------------------------------
WORK_COUNTERS = ("node_state_activations", "kernel_batches", "kernel_tasks")


def select_requests(host, graph, count: int, scan_cap: int,
                    backstop_s: float):
    """The first ``count`` requests of ``generate_workload(..., seed=13)``
    with exactly one endpoint bound whose host traversal never queues
    more than ``scan_cap`` triples of object ranges for one superstep.

    On this graph the workload is bimodal: a request either dies within
    a few supersteps or its closure reaches a hub and runs for minutes
    of host Python.  A time deadline does not stop those in time: it is
    probed only in part 1 of a superstep, every 64 frontier entries, so
    a hub superstep's parts 2-3 run past it (``deadline_overrun``
    measures by how much).  Bounding the queued scan between supersteps
    skips the hub closures at a bounded cost, so the batch leaves out
    the kernel's heaviest traffic.  Each request is probed alone through
    a one-slot ``SlotScheduler`` on ``host`` (scalar tables), whose
    answers are returned as the host reference.  Returns (queries,
    answers, skipped queries, report).
    """
    from repro_torch.core import patterns
    from repro_torch.core.engines import Query
    from repro_torch.core.scheduler import SlotScheduler
    wl = patterns.generate_workload(4 * count, graph.num_preds,
                                    graph.num_nodes, seed=13)
    C_o = host.ring.C_o
    picked, answers, tried, skipped = [], [], 0, []
    t0 = time.perf_counter()
    for expr, s, o, _pattern in wl.queries:
        if (s is None) == (o is None):
            continue
        tried += 1
        sched = SlotScheduler(host, max_slots=1, recorder_capacity=0)
        q = Query(expr, s, o)
        ticket = sched.submit(q, deadline_s=backstop_s)
        bounded = True
        while bounded and sched.step():
            scan = sum(int(C_o[v + 1] - C_o[v])
                       for _j, v, _d in sched.slots.stepper.queue)
            bounded = scan <= scan_cap
        if not bounded or ticket.state != "done":
            skipped.append(q)
            continue
        picked.append(q)
        answers.append(ticket.result())
        if len(picked) == count:
            break
    if len(picked) < count:
        fail(f"only {len(picked)} of {count} requests stay bounded")
    return picked, answers, skipped, {
        "tried": tried, "skipped": len(skipped), "scan_cap": scan_cap,
        "seconds": time.perf_counter() - t0}


def deadline_overrun(host, queries, deadline_s: float, cap_s: float):
    """Seconds each of ``queries`` takes on ``host``'s ring under a
    ``deadline_s`` per-query deadline: how far past it the
    ``TimeoutError`` comes.  A ``SIGALRM`` stops a probe at ``cap_s``
    (status "capped")."""
    import signal
    from repro_torch.core.rpq import RingRPQ

    class Capped(Exception):
        pass

    def on_alarm(_signum, _frame):
        raise Capped()

    out = []
    previous = signal.signal(signal.SIGALRM, on_alarm)
    try:
        for q in queries:
            engine = RingRPQ(host.ring, device="cpu", stats=host.graph_stats)
            status = "capped"
            t0 = time.perf_counter()
            try:
                signal.setitimer(signal.ITIMER_REAL, cap_s)
                try:
                    engine.eval(q.expr, q.subject, q.obj,
                                deadline_s=deadline_s)
                    status = "finished"
                except TimeoutError:
                    status = "timeout"
                finally:
                    signal.setitimer(signal.ITIMER_REAL, 0)
            except Capped:
                pass
            out.append({"query": [q.expr, q.subject, q.obj],
                        "status": status,
                        "seconds": time.perf_counter() - t0})
    finally:
        signal.signal(signal.SIGALRM, previous)
    return {"deadline_s": deadline_s, "cap_s": cap_s, "probes": out}


def run_main_path(graph, device: str, count: int, deadline_s: float,
                  capture=None):
    """Build the engine, select the requests, answer them on ``device``
    and hold the answers and counters to two host runs."""
    from repro_torch import kernels
    from repro_torch.core.engines import make_engine
    from repro_torch.core.rpq import RingRPQ
    from repro_torch.kernels import ops as kops
    t0 = time.perf_counter()
    engine = make_engine(graph, device=device)
    ring_s = time.perf_counter() - t0
    host = RingRPQ(engine.ring, device="cpu")          # scalar tables
    queries, host_answers, skipped, sel = select_requests(
        host, graph, count, SCAN_CAP, deadline_s / 4)

    original = kops.nfa_step

    def recording(X, bwd):     # keep the largest launch's inputs
        if capture is not None and X.shape[0] > capture.get("N", -1):
            capture.update(N=X.shape[0], X=X, bwd=bwd)
        return original(X, bwd)

    kops.nfa_step = recording
    try:
        kernels.reset_launch_counts()
        stats = []
        t0 = time.perf_counter()
        answers = engine.eval_many(queries, deadline_s=deadline_s,
                                   stats_out=stats)
        batch_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        kops.nfa_step = original

    plain = RingRPQ(engine.ring, device="cpu", kernel_threshold=64)
    plain_stats = []
    t0 = time.perf_counter()
    plain_answers = plain.eval_many(queries, stats_out=plain_stats)
    plain_s = time.perf_counter() - t0
    for i, q in enumerate(queries):
        if answers[i] != plain_answers[i]:
            fail(f"answer of {q} differs from the plain-kernel host run")
        if answers[i] != host_answers[i]:
            fail(f"answer of {q} differs from the scalar-table host run")
        for f in WORK_COUNTERS:
            if getattr(stats[i], f) != getattr(plain_stats[i], f):
                fail(f"{f} of {q} differs from the plain-kernel host run")
    if engine.bundle_kernel_batches != plain.bundle_kernel_batches:
        fail("bundle_kernel_batches differs from the plain-kernel host run")
    task_counts = [k[1] for k in engine.traces.signatures
                   if k[0] == "nfa_step"]
    busy = device_busy(engine.ring, device, queries, deadline_s)
    overrun = deadline_overrun(host, skipped[:OVERRUN_PROBES],
                               OVERRUN_DEADLINE_S, OVERRUN_CAP_S)
    report = {
        "graph": {"nodes": graph.num_nodes, "preds": graph.num_preds,
                  "edges": int(graph.s.size),
                  "ring_triples": int(engine.ring.n)},
        "cut": None,
        "ring_build_s": ring_s, "selection": sel,
        "requests": len(queries), "batch_s": batch_s,
        "plain_kernel_host_batch_s": plain_s,
        "kernel_launches": launches.get("nfa_step", 0),
        "kernel_batches": sum(s.kernel_batches for s in stats),
        "kernel_tasks": sum(s.kernel_tasks for s in stats),
        "bundle_kernel_batches": engine.bundle_kernel_batches,
        "max_tasks_per_launch": max(task_counts, default=0),
        "answers": sum(len(a) for a in answers),
        "activations": sum(s.node_state_activations for s in stats),
        **busy,
        "skipped_hub_deadline_overrun": overrun,
    }
    return engine, queries, answers, report


def device_busy(ring, device, queries, deadline_s):
    """Rerun the batch on a fresh engine under ``torch.profiler``: the
    card's kernel and copy time against the batch's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.rpq import RingRPQ
    engine = RingRPQ(ring, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.eval_many(queries, deadline_s=deadline_s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"profiled_batch_s": wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall}


# -- phase 3 -----------------------------------------------------------------
def phase_serving(ring, queries, answers_epoch0, seed: int = 5):
    """A ``SlotScheduler`` over a CUDA engine on the main path's ring.
    The engine launches the kernel from one task up: at the default 64,
    slots of these small requests never merge enough tasks.  So every
    superstep goes through the kernel, on a dynamic bundle whose padded
    width changes as slots churn."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.rpq import RingRPQ
    from repro_torch.core.scheduler import SlotScheduler
    engine = RingRPQ(ring, device="cuda", kernel_threshold=1)
    sched = SlotScheduler(engine, max_slots=8)
    rng = np.random.default_rng(seed)
    V, P = ring.num_nodes, ring.num_preds
    adds = [(int(rng.integers(V)), int(rng.integers(min(P, 4))),
             int(rng.integers(V))) for _ in range(16)]
    reqs = queries[:16]
    tickets = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i, q in enumerate(reqs):
        tickets.append(sched.submit(q))
        sched.step()
        if i == len(reqs) // 2 - 1:
            sched.submit_update(add=adds)      # live add_edges
    sched.drain()
    serve_s = time.perf_counter() - t0
    launches = kernels.launch_counts()["nfa_step"]
    if launches <= 0:
        fail("serving launched no nfa_step kernel")
    ref = RingRPQ(ring, device="cpu")
    ref.add_edges(adds)
    want = {0: answers_epoch0[:16], ref.epoch: ref.eval_many(reqs)}
    epochs = []
    for i, (q, t) in enumerate(zip(reqs, tickets)):
        epochs.append(t.epoch)
        if t.result() != want[t.epoch][i]:
            fail(f"slot answer of {q} at epoch {t.epoch} differs "
                 f"from eval_many")
    return {"phase": "serving", "requests": len(reqs),
            "epochs": epochs, "admitted": sched.admitted,
            "peak_in_flight": sched.peak_in_flight,
            "kernel_launches": launches,
            "words_per_launch": sorted({k[2] for k in engine.traces.signatures
                                        if k[0] == "nfa_step"}),
            "serve_s": serve_s}


# -- phase 4 -----------------------------------------------------------------
def phase_oracle(device: str, num_queries: int = 8):
    from repro_torch import kernels
    from repro_torch.core import fixtures, oracle, patterns
    from repro_torch.core.engines import make_engine
    graph = fixtures.scale_free_graph(2_000, 8, 15_000, seed=3)
    engine = make_engine(graph, device=device, kernel_threshold=1)
    wl = patterns.generate_workload(num_queries, graph.num_preds,
                                    graph.num_nodes, seed=17)
    qs = [(e, s, o) for e, s, o, _ in wl.queries]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.eval_many(qs)
    launches = kernels.launch_counts()["nfa_step"]
    if launches <= 0:
        fail("the oracle phase launched no nfa_step kernel")
    every_pair = {}   # expr -> all pairs: one oracle pass per expression
    for (e, s, o), res in zip(qs, got):
        if s is not None:
            want = oracle.eval_oracle(graph, e, s, o)
        else:
            if e not in every_pair:
                every_pair[e] = oracle.eval_oracle(graph, e)
            want = {(a, b) for a, b in every_pair[e] if o is None or b == o}
        if res != want:
            fail(f"answer of {(e, s, o)} differs from the oracle")
    return {"phase": "oracle", "queries": len(qs),
            "answers": sum(len(r) for r in got),
            "kernel_batches": engine.bundle_kernel_batches,
            "kernel_launches": launches,
            "seconds": time.perf_counter() - t0}


# -- the kernels line ----------------------------------------------------------
def kernels_line(capture, launches: int, errs: list):
    from repro_torch.kernels import nfa_step as knfa
    from repro_torch.kernels.ref import nfa_step_ref
    X, bwd = capture["X"], capture["bwd"]
    got, want = knfa.nfa_step_cuda(X, bwd), nfa_step_ref(X, bwd)
    errs.append(max_abs_err(got, want))
    if errs[-1]:
        fail("nfa_step differs from its plain version on main-path input")
    bound, by = nfa_bound(X, bwd.shape[0])
    return {"kernels": [{
        "name": "nfa_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nfa_step.cu",
        "replaces": "src/repro/kernels/nfa_step.py:54",
        "launches": launches, "max_abs_err": max(errs),
        "ms": time_ms(lambda: knfa.nfa_step_cuda(X, bwd)),
        "plain_ms": time_ms(lambda: nfa_step_ref(X, bwd)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "shape": {"N": int(X.shape[0]), "S": int(bwd.shape[0]),
                  "W": int(X.shape[1])},
    }]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    from repro_torch.core import fixtures
    t_start = time.perf_counter()
    phase_device()
    errs: list = []
    phase_kernels(errs)
    graph = fixtures.scale_free_graph(200_000, 64, 2_000_000, seed=7)
    capture: dict = {}
    engine, queries, answers, report = run_main_path(
        graph, "cuda", BATCH, BATCH_DEADLINE_S, capture)
    torch.cuda.synchronize()
    emit({"phase": "main_path", **report})
    if report["kernel_launches"] <= 0:
        fail("the main path launched no nfa_step kernel")
    emit(phase_serving(engine.ring, queries, answers))
    emit(phase_oracle("cuda"))
    kernels = kernels_line(capture, report["kernel_launches"], errs)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit(kernels)                      # the line before the last
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
