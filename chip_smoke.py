#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

or with ``--parent DIR``, a checkout of the parent commit, to load that
tree's own ``ops.packed_superstep``, ``ops.rank1``,
``ops.build_rank_directory``, ``ops.segment_or`` and
``ops.segmented_or_scan`` too and time each in turns with this tree's at
every superstep, rank and segment timing point (``parent_ms``,
``turns_ms``).

Phases, one JSON line each (plus the raw ``nvidia-smi`` name/power line):

  0. device + build: the card, and the seconds ``nvcc`` took to build
     every kernel from ``src/repro_torch/kernels/csrc`` (into the
     git-ignored ``kernels/_build/``), with the compiler's register report;
  1. every kernel against its plain PyTorch version, bit for bit, on a
     sweep of shapes up to the packed path's full size, each timed with
     CUDA events (median of 20 runs; of fewer, at least 5, where 20
     would take over a second); ``nfa_step`` in both its layouts
     (a thread or a warp per row), and ``packed_superstep`` at the full
     size with 1% and 100% of the frontier rows live, beside the
     unfused superstep it replaced (``unfused_ms``), and with R = 16 BFS
     rows (the dense engine's batch), each held to the plain version on
     the epoch's raw edge arrays, with its bound over the grouped inputs
     beside the edge pass's bound and the bytes its design moves; the
     rank kernels on random bitvectors up to the ring's level size: the
     popcounts, the one-launch directory (beside the plain popcounts,
     ``cumsum`` and ``cat``),
     ``rank1`` at random and at the same offsets sorted, with the L2
     sector bytes its design reads, and each kernel's launch floor (one
     query, one superblock); ``segment_or`` and ``segmented_or_scan``
     at one row, their launch floors;
  2. the main path at full size: ``make_engine`` over
     ``scale_free_graph(200_000, 64, 2_000_000, seed=7)`` answers a batch
     of 2,048 one-endpoint requests through ``eval_many`` on the card;
     the answers and work counters must equal a host run of the same
     engine with the kernel's plain version, and the answers a host run
     with scalar tables (the selection's, in a process of its own beside
     phase 1); a profiled rerun of the first 512 requests gives the
     card's busy share;
     the line names the layout of the batch's ``nfa_step`` launch;
     two of the hub closures left out of the batch run on the card under
     a 1 s deadline, and each ``TimeoutError`` must come within
     ``serve.OVERRUN_BOUND_S`` of it;
  3. serving: a ``SlotScheduler`` over a CUDA engine on the same ring,
     launching the kernel from one task up, answers 16 requests admitted
     one at a time with a live ``add_edges`` in between; each answer
     must equal ``eval_many`` at its ticket's epoch, and the kernel must
     have launched;
  4. oracle: a smaller graph's answers on the card, from the ring engine
     and from the packed BFS, must equal the host's product-graph
     oracle (``eval_oracle_by_label``);
  5. packed path: ``packed_bfs`` (one ``packed_superstep`` launch and
     one flag read each superstep, every edge swept) on a ``DenseGraph``
     on the card over phase 2's graph answers (a) phase 2's requests,
     which must equal the ring engine's answers, and (b) the hub
     closures phase 2 left out, with their supersteps and seconds; (c)
     the first hub closures rerun on the host with the plain version
     must give the same visited words and supersteps; a profiled rerun
     of (b)'s first 64 hub closures gives the card's idle share and
     ``cudaLaunchKernel`` calls a superstep; ``packed_superstep``
     (beside the unfused superstep), and ``nfa_step`` and ``segment_or``
     on its transition, are held to
     their plain versions at the superstep of (a) and (b) with the most
     non-zero words; the path must launch ``packed_superstep`` and
     neither of the other two (phase 4's packed BFS too);
  6. rank: every level of the ring's wavelet trees through the rank
     kernels: the directory (one launch) must equal the level's
     ``sb_rank``, and 1,048,576 random ranks the host
     ``BitVector.rank1``;
  7. dense path: ``make_engine(graph, kind="dense")`` on phase 2's graph
     answers phase 2's requests through ``eval_many`` (equal to the
     ring's) and the hub closures, the first 64 one request a call and
     all 605 in one batch (equal to phase 5's); two hub closures under a
     1 s deadline; a mixed batch again on the host with the plain
     version (equal answers and supersteps); ANALYZE of one hub closure;
     a profiled rerun of the first 512 requests (idle share,
     ``cudaLaunchKernel`` and flag reads a superstep); a
     rerun that records the heaviest R = 16 launch; a ``SlotScheduler``
     over the engine as phase 3, and the seconds its live update's edge
     epoch takes to group by object on the card.  The path must launch
     ``packed_superstep`` and neither ``nfa_step`` nor ``segment_or``;
  8. mesh: both engines sharded over a mesh of 4 x the card on phase 2's
     graph (its ``Ring`` and phase 7's statistics reused): the ring on
     phase 2's requests (``nfa_step`` once a shard per sharded batch),
     the dense engine on them and 32 hub closures, with a profiled rerun
     and the all-gather bytes a superstep beside ANALYZE's model of
     them; the dense engine on a 2 x 2 data x model mesh on a subset;
     phase 7's statistics and overlay saved with
     ``repro_torch.checkpoint``, restored onto the card and loaded into
     a new 4-shard engine.  Every answer equals phases 2, 5 and 7;
  9. serving front: ``repro_torch.serve`` (``AsyncServer`` over a
     ``SlotScheduler`` of 64 slots, a closed-loop client with 64
     requests in flight, phase 3's live ``add_edges`` after half are
     submitted, ``/metrics``, ``/flight`` and ``/explain`` scraped over
     HTTP) on every request phase 2 tried, hub closures included, on (a)
     the ring under a 1 s deadline (each timeout settles within
     ``serve.OVERRUN_BOUND_S`` of it), (b) the dense engine and (c) the
     dense engine on a mesh of 4 x the card under 60 s (no timeout; each
     the regular requests and the first ``SERVE_HUBS`` hub closures);
     every ``ok`` answer equals ``eval_many`` at its ticket's epoch, and
     each run's ``/flight`` capture replays on a fresh engine with count
     parity 1.0; (a)'s line names where its worst overrun settled and
     the tick that held it, and its longest tick;
 10. the LM (``repro_torch.launch``), smollm-135m at its published
     widths: (a) ``launch.train`` at B = 8, T = 2,048 for 20 steps on
     ``SyntheticLM`` (losses finite and falling; median step seconds,
     tokens/s, model TFLOP/s beside the bf16 peak, peak memory, one
     layer's attention timed, a profiled step); (b) ``launch.path_lm
     --full --steps 40``; (c) a 2-layer cut failing at step 2 and
     resuming against an uninterrupted run under deterministic
     algorithms, and (a)'s full state saved and restored once, bit for
     bit, on a thread beside (b)-(e) and phases 11-12 (its line,
     ``lm_full_checkpoint``, after phase 12's); (d) ``launch.serve`` at
     B = 4, prompt 2,048, 32 tokens, and decode consistency at full
     width; (e) the tiny config's loss and gradients on the card against
     the CPU.  The LM must launch none of the RPQ kernels;
 11. the LM families (``repro_torch.launch.serve``, ``train.step``): (a)
     olmoe-1b-7b (moe), (b) paligemma-3b (vlm), (c) mamba2-2.7b (ssm), (d)
     zamba2-7b (hybrid), (e) seamless-m4t-medium (encdec), each served at
     its published size (B = 2, 1,024 positions, 32 greedy tokens; decode
     consistency, olmoe's at B = 1, T = 256 where its capacity drops
     nothing, with the pairs its served prefill dropped), trained 10
     steps at B = 4, T = 512 at its published widths, depth cut (losses
     finite and falling), and its smoke variant, then qwen2-moe's, on the
     card against the CPU.  None of the RPQ kernels may launch;
 12. the LM on a (data 2, model 2) mesh of 4 x the card
     (``launch.mesh.make_host_mesh(model=2, shards=4)``, the
     ``train.step`` entry points with ``mesh=``): (a) smollm-135m at its
     published size trains 10 steps at B = 8, T = 1,024 against a
     one-device run from the same state and batches (step 1's loss
     within 2e-3, its gradient within 1e-2 relative L2 and every leaf
     within 5e-2, every loss within 1e-2, falling); serves B = 4
     (prefill T = 1,024, 16 greedy tokens) and B = 1 (``small_batch``),
     the prefill logits against one device and decode consistency on
     the mesh within ``0.1 * max|ref| + 0.06``; its 2-layer copy trains
     6 steps under the same gates, its step-3 state saved on a thread,
     and, last, that checkpoint is restored onto the mesh (bit for bit)
     and resumed, equal to the uninterrupted run (``rtol=1e-5,
     atol=1e-6``, deterministic algorithms from step 4);
     (b) qwen3-4b serves at its published size (B = 2, T = 1,024, 8
     tokens) and trains 5 steps at B = 4, T = 512 at its published
     widths, depth cut to 2 layers, under the same gates, then profiles
     one more mesh step (the card's busy and idle share); (c) each of
     phase 11's five families at its published widths and phase 11's
     depth trains 5 steps at B = 4, T = 512 beside one device under the
     same gates and serves B = 2 (512 positions: a vlm's 256 patches +
     256 tokens, an encdec's 512 frames and 512 tokens; 8 tokens), one
     line a family; mamba2's and zamba2's step-1 gradient also at one
     mamba layer (zamba2's shared block after it) within 1e-2, and at
     depth within what perturbed weights move one device (capped);
     olmoe's serving comparisons replay the other side's experts; its
     MoE block drops, on the mesh, exactly the (token, slot) pairs one
     device drops from the same input (one capacity group across both
     data coordinates).  Each line gives
     step seconds, tokens/s, model TFLOP/s, resident bytes a coordinate
     against the specs, collective bytes a step by kind, the replicated
     dims and peak memory.  None of the RPQ kernels may launch;
 13. the dry run (``repro_torch.launch.dryrun``): (a) ``make_bfs`` at
     the ring-rpq config's own size (V = 2**25, E = 2**29 drawn on the
     card, hub objects, Zipf predicates; L = 1,024; a 15-position regex
     compiled by the port's ``glushkov``; 65,536 start nodes; 8
     supersteps) on a mesh of 4 x the card: the frontier live at every
     superstep, the planes bit for bit the one-device
     ``dense.bfs_rows``'s on the same edges, ``packed_superstep`` once a
     shard a superstep, and the bytes held and gathered equal to the dry
     run's record of that mesh (``dryrun.lower_rpq``); (b) the dry run
     of phase 12 (a)'s training on the meta device: its resident bytes
     and forward collective bytes by kind equal what phase 12 (a)
     measured; (c) the ring-rpq and smollm-135m ``train_4k`` cells on the
     16 x 16 production mesh, with their trace seconds;
 14. the port's static analyzer (``python -m repro_torch.analysis``),
     all three layers, the trace layer with ``--device cuda
     --mesh-devices 4 --no-trace-cache``: T001 launches every
     ``KERNELS`` entry at the JAX package's shapes, T002 counts the host
     reads of the R-row BFS and the sharded superstep on 4 x the card,
     T005 measures that superstep's all-gather bytes against the port's
     wire model and the JAX package's int8-plane model.  Any finding
     the baseline does not hold fails; the line gives the new and
     baselined findings, each check's result, T005's bytes, the B001
     proof note and the seconds;
 15. examples: ``python -m repro_torch.examples.quickstart`` and
     ``.wikidata_style_queries`` through their ``main`` on the card at
     the JAX package's defaults (the metro graph; 5,000 nodes, 40,000
     edges, 16 predicates, 25 queries), every answer of the ring and
     dense engines held to the host oracle; the line gives each
     engine's ms per pattern beside the card's name and power limit.

Each of phases 2-13 and 15 sets the launch counts to 0 just before its
path (in phase 9, before each run; in phase 15, before each example) and
prints them just after; phase 14 counts
its launches apart, as the ``audit`` point of each kernel.

Then the ``kernels`` line (each kernel's launches on its path and its
times at its path's largest launch, the heaviest superstep for
``packed_superstep`` and ``segment_or``; for ``nfa_step`` and
``packed_superstep`` also a shard's launch on the mesh, for
``packed_superstep`` the dense path's heaviest R = 16 launch, for
``nfa_step`` the serving ring's largest launch, for the rank kernels
the directory, the sorted offsets and the launch floors, for
``segment_or`` and ``segmented_or_scan`` the launch floors and the
``cudaLaunchKernel`` calls of one call, and for ``segment_or`` the
heaviest superstep's values with their ids permuted and that input's
longest runs of equal ids)
and, last, the ``ok`` line, right after it.  Any mismatch or exception
exits non-zero before the ``ok`` line.  Without a CUDA device,
or without the ``repro_torch`` package beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T_SCRIPT = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks at 700 W.  HBM bytes/s: NVIDIA's data sheet.  32-bit
# ORs/s: 64 results per clock per SM for 32-bit AND/OR/XOR at compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of native
# arithmetic instructions), times 132 SMs at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit population counts: 16 results per clock per SM at compute
# capability 9.0 (same table), same SMs and clock
POPC_PER_S = 16 * 132 * 1.98e9

SWEEP = [(1, 1), (5, 4), (700, 33), (1024, 64), (513, 32), (2048, 7)]
MAIN_N = (64, 1_000, 16_384)
MAIN_S = (11, 700, 4_096)
# wide tables (213 KB and 246 KB, W = 41 and 44 words): past a block's
# 227 KB of shared memory, and several 8-word output chunks per row
EDGE_S = (1_300, 1_400)
# row widths between the sweep's W = 2 and W = 22, where nfa_step's two
# layouts (a thread or a warp per row) may cross: W = 3, 5, 8, 12, 16
LAYOUT_S = (96, 160, 256, 384, 512)

# segment_or: the JAX package's test shapes (E, W, V), then the packed
# path's full size, the completed triples and nodes of phase 2's graph
SEG_SWEEP = [(1, 1, 1), (10, 1, 4), (3000, 2, 50), (2050, 1, 2000),
             (1024, 3, 7)]
FULL_E, FULL_V = 3_954_840, 200_000
FULL_W = (1, 2, 4)
# share of non-zero words in the sparse values; the packed path's own
# launches, whose heaviest phase 5 times, run at 5-8.5%
SPARSE_WORDS = 0.01
SCAN_SHAPES = [(2_500, 2), (FULL_E, 1)]
# packed_superstep at the full size: (R rows, S, share of live frontier
# rows, law of the objects), with the 2P = 128 labels of phase 2's graph;
# R = 16 is the dense engine's batch of rows (source_batch), S = 8 and 16
# the state widths its padded buckets take on phase 7's requests
SUPERSTEP_SHAPES = [(1, 20, 0.01, "hub"), (1, 20, 1.0, "hub"),
                    (1, 40, 0.01, "hub"), (1, 40, 1.0, "hub"),
                    (1, 20, 0.01, "uniform"), (1, 20, 0.0, "hub"),
                    (16, 8, 0.01, "hub"), (16, 16, 0.01, "hub"),
                    (16, 8, 0.0, "hub")]
ROWS_TIMED = 16           # the kernels line's entry at R rows: the first
FULL_L = 128
RANK_BITS = (100, 515, 8_192, 40_000, FULL_E)
RANK_QUERIES = (4_096, 1_048_576)
# each rank kernel's launch floor: one query, one superblock
RANK_FLOOR_Q = 1
RANK_FLOOR_NW = 16
# a 32-byte sector, the unit in which L2 serves the SMs
SECTOR_BYTES = 32

# phase 5: hub closures rerun on the host with the plain versions
HOST_CHECKS = 8

# Requests per eval_many batch.  On this graph the one-endpoint requests
# that finish at all are tiny (a handful of activations each), so only a
# log-sized batch merges supersteps of >= 64 tasks, the kernel's
# threshold; 32 requests never launch it (see PERF.md).
BATCH = 2048
# phase 2's graph: scale_free_graph(nodes, preds, edges, seed=)
MAIN_GRAPH = ((200_000, 64, 2_000_000), 7)
BATCH_DEADLINE_S = 60.0              # the paper's per-query timeout
SCAN_CAP = 2_000                     # triples one probe superstep may scan
# the requests phase 2's profiled rerun answers (cut from all 2,048 for
# the script's time limit: the profile's event processing took most of the
# rerun)
PROFILED_REQUESTS = 512
# skipped hub closures rerun under a short deadline, to time its overrun
OVERRUN_PROBES = 2
OVERRUN_DEADLINE_S = 1.0
OVERRUN_CAP_S = 60.0          # a safety net: a probe that reaches it fails


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase's line also gets
    ``script_s``, the seconds since the script began, so that the lines
    place each phase in the run."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - T_SCRIPT}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


class Stamps:
    """Seconds between the named points of a phase, its line's
    ``substep_s``: ``mark(name)`` adds the time since the previous mark
    (or since the stamps were made) to ``seconds[name]``."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: dict = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


TIMING_BUDGET_MS = 1_000.0   # a slow function's runs: about this in all
TIMING_MIN_RUNS = 5


def time_ms(fn, runs: int = 20, setup=None) -> float:
    """Median device time of ``fn`` over ``runs`` runs, CUDA events.  A
    sleep kernel queued first keeps the card busy while the host
    enqueues the events and the work, so host latency stays out.
    ``setup``, if given, runs before each run, outside the events.  A
    function whose first timed run shows that ``runs`` of them would
    take over ``TIMING_BUDGET_MS`` (a plain version, tens to hundreds
    of ms) gets that budget's worth of runs, at least
    ``TIMING_MIN_RUNS``."""
    import torch
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    out = []
    while len(out) < runs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if setup is not None:
            setup()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
        if len(out) == 1 and out[0] * runs > TIMING_BUDGET_MS:
            runs = max(min(runs, TIMING_MIN_RUNS),
                       int(TIMING_BUDGET_MS / out[0]))
    return statistics.median(out)


def bound(n_bytes: float, n_ops: float = 0.0, ops_per_s: float = 1.0):
    """(bound_ms, bound_by): the larger of bytes over HBM's rate and
    operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    return bound((2 * N * W + rows * W) * 4, set_bits * W, INT32_OPS_PER_S)


def max_abs_err(a, b) -> int:
    from repro_torch.kernels.ref import widen
    return int((widen(a) - widen(b)).abs().max()) if a.numel() else 0


def segment_or_bound(vals, num_segments: int):
    """Each value read once, the segment id of each row that has a
    non-zero word read once (a zero word ORs nothing in, so its id is
    not needed), the output written once: 4*E*W + 4*rows + 4*V*W bytes,
    ids counted at 4 bytes, not at whole 32-byte sectors.  One OR per
    non-zero word."""
    E, W = vals.shape
    nonzero = vals != 0
    rows = int(nonzero.any(1).sum()) if E else 0
    return bound(4 * E * W + 4 * rows + 4 * num_segments * W,
                 int(nonzero.sum()), INT32_OPS_PER_S)


def longest_run(ids) -> int:
    """The most consecutive rows that share one id (0 for no rows)."""
    import torch
    n = ids.shape[0]
    if n == 0:
        return 0
    change = torch.nonzero(ids[1:] != ids[:-1]).flatten()
    ends = torch.cat([change.new_tensor([-1]), change,
                      change.new_tensor([n - 1])])
    return int((ends[1:] - ends[:-1]).max())


def cuda_launches_per_call(fn, runs: int = 10) -> float:
    """``cudaLaunchKernel`` calls one call of ``fn`` makes, as
    ``torch.profiler`` counts them (a kernel's own launch, a fill)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "cudaLaunchKernel") / runs


def edge_pass_bound(f, v, Bp, bwd, subj, pred, obj, gathered=None):
    """What one edge pass (the kernel before the grouped layout: a thread
    an edge) of R rows must move and do on these inputs, over the card's
    rates: ``kernels/packed_superstep.py`` ``edge_pass_cost``, the byte
    model the dry run's all-live case shares."""
    from repro_torch.kernels.packed_superstep import edge_pass_cost
    n_bytes, n_ops = edge_pass_cost(f, v, Bp, bwd, subj, pred, obj,
                                    gathered=gathered)
    return bound(n_bytes, n_ops, INT32_OPS_PER_S)


def scan_bound(vals):
    """Values and flags read once, the scan written once; one OR per
    word."""
    E, W = vals.shape
    return bound(8 * E * W + 4 * E, E * W, INT32_OPS_PER_S)


def popcounts_bound(words):
    """Words read once, one int32 per superblock written; one popcount a
    word."""
    NW = words.shape[0]
    return bound(4 * NW + 4 * (NW // 16), NW, POPC_PER_S)


def directory_bound(words):
    """Words read once, the directory (one int32 per superblock and a
    leading 0) written once; one popcount a word."""
    NW = words.shape[0]
    return bound(4 * NW + 4 * (NW // 16 + 1), NW, POPC_PER_S)


def rank1_sector_bytes(words, i) -> dict:
    """The bytes the L2 serves for one rank1 call, in whole 32-byte
    sectors and counting no reuse between queries: each query's
    directory sector and the sectors of the words it needs, plus its
    offset and rank at 4 bytes each (a warp's are contiguous).
    ``design``: this kernel, which reads a window's needed quarters as
    16-byte vectors (its 64-byte-aligned window spans two sectors, one
    past its eighth word; a window past the words reads one clamped
    word); ``word_walk``: a load a needed word, a sector each, as one
    thread walking the window word by word requests them."""
    import torch
    i64 = i.to(torch.int64)
    kq = (i64 >> 5) & 15
    # the last word with a non-zero mask (-1: none)
    last = kq - ((i64 & 31) == 0).to(torch.int64)
    sb = i64 >> 9
    inside = (sb >= 0) & (sb < words.shape[0] // 16)
    sectors = torch.where(inside, (last >= 0).to(torch.int64)
                          + (last >= 8).to(torch.int64),
                          (last >= 0).to(torch.int64))
    per_query = SECTOR_BYTES + 8            # directory sector, offset, rank
    return {"design": int(SECTOR_BYTES * sectors.sum())
            + per_query * i.shape[0],
            "word_walk": int(SECTOR_BYTES * (last + 1).sum())
            + per_query * i.shape[0]}


def rank1_bound(words, directory, i):
    """Each offset read and each rank written once, and once each word
    and directory entry that some query needs: the words of its
    superblock below its bit.  One popcount per word a query needs."""
    import torch
    i64 = i.to(torch.int64)
    lo = (i64 >> 9) * 16                           # first word of the window
    hi = (i64 >> 5) + ((i64 & 31) != 0).to(torch.int64)   # past its last
    NW = words.shape[0]
    marks = torch.zeros(NW + 1, dtype=torch.int64, device=i.device)
    marks.index_add_(0, lo.clamp(0, NW), torch.ones_like(lo))
    marks.index_add_(0, hi.clamp(0, NW), -torch.ones_like(hi))
    words_needed = int((torch.cumsum(marks, 0)[:NW] > 0).sum())
    dir_needed = int(torch.unique(i64 >> 9).numel())
    return bound(4 * (2 * i.shape[0] + words_needed + dir_needed),
                 int((hi - lo).clamp(min=0).sum()), POPC_PER_S)


# -- the parent's kernel ------------------------------------------------------
# the parent tree's packed_superstep, when ``--parent DIR`` names one
PARENT = None


class ParentSuperstep:
    """The parent tree's own ``ops``, loaded from ``DIR/src/repro_torch``
    as the package ``parent_repro_torch`` (its kernels built into that
    tree's ``kernels/_build/``), for timing in turns with this tree's
    kernels on the same card and inputs: its ``packed_superstep``, which
    takes the edge inputs its signature names (the epoch's ``(subj,
    pred, obj)`` arrays, or a ``layout`` and ``scratch`` that its own
    ``group_by_object`` and ``new_scratch`` build from them), its rank
    entry points ``rank1`` and ``build_rank_directory`` and its
    ``segment_or`` and ``segmented_or_scan`` (:meth:`turns_of`)."""

    NAME = "parent_repro_torch"

    def __init__(self, root: str):
        import importlib
        import importlib.util
        import inspect
        self.src = os.path.join(root, "src", "repro_torch")
        spec = importlib.util.spec_from_file_location(
            self.NAME, os.path.join(self.src, "__init__.py"),
            submodule_search_locations=[self.src])
        package = importlib.util.module_from_spec(spec)
        sys.modules[self.NAME] = package
        spec.loader.exec_module(package)
        self.ops = importlib.import_module(self.NAME + ".kernels.ops")
        self.sup = importlib.import_module(
            self.NAME + ".kernels.packed_superstep")
        params = inspect.signature(self.ops.packed_superstep).parameters
        self.raw = "obj" in params
        if not self.raw and "layout" not in params:
            fail(f"{self.src}: ops.packed_superstep takes neither edge "
                 f"arrays nor a layout")
        self.seconds = 0.0

    def build(self) -> None:
        from importlib import import_module
        t0 = time.perf_counter()
        import_module(self.NAME + ".kernels._build").build(
            ["packed_superstep", "rank_popcount", "segment_or"])
        self.seconds = time.perf_counter() - t0

    def bind(self, args, gathered):
        """(run(state), reset()) for the parent's pass on a superstep case
        ``args``: ``reset`` zeroes its worklist counters, if it has any."""
        f, stamp, Bp, bwd, edges = args[0], args[5], args[6], args[7], \
            args[8]
        tail, reset = (edges.subj, edges.pred, edges.obj), (lambda: None)
        if not self.raw:
            g = f if gathered is None else gathered
            # the inert label: a last table row that is zero in every row
            inert = Bp.shape[1] - (0 if bool(Bp[:, -1].any()) else 1)
            layout = self.sup.group_by_object(*tail, g.shape[1], inert)
            scratch = self.sup.new_scratch(layout, f.shape[0])
            tail, reset = (layout, scratch), scratch.counters.zero_

        def run(state):
            self.ops.packed_superstep(*state, stamp, Bp, bwd, *tail,
                                      gathered=gathered)
        return run, reset

    def turns_of(self, name: str, args, want, kernel) -> dict:
        """The parent's ``ops.<name>`` on ``args``, held to ``want``, then
        timed in turns with ``kernel``: parent, kernel, kernel, parent."""
        import torch
        fn = getattr(self.ops, name)

        def run():
            return fn(*args)

        equal = bool(torch.equal(run(), want))
        t = [time_ms(run), time_ms(kernel), time_ms(kernel), time_ms(run)]
        return {"parent_ms": (t[0] + t[3]) / 2, "turns_ms": t,
                "parent_equal": equal}

    def turns(self, args, gathered, want, kernel, fresh) -> dict:
        """The parent's pass on ``args``, held to ``want``, then timed in
        turns with ``kernel``: parent, kernel, kernel, parent, nxt (and
        each pass's worklist counters) zeroed before each run."""
        import torch
        run, reset = self.bind(args, gathered)
        once = [t.clone() for t in args[:5]]
        run(once)
        equal = all(torch.equal(a, b) for a, b in zip(once, want))
        copy = [t.clone() for t in args[:5]]

        def parent_fresh():
            copy[2].zero_()
            reset()

        t = [time_ms(lambda: run(copy), setup=parent_fresh),
             time_ms(kernel, setup=fresh), time_ms(kernel, setup=fresh),
             time_ms(lambda: run(copy), setup=parent_fresh)]
        return {"parent_ms": (t[0] + t[3]) / 2, "turns_ms": t,
                "parent_equal": equal}


# -- phase 0 -----------------------------------------------------------------
def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else "nvidia-smi: no output")


def phase_device():
    import torch
    print(smi_line(), flush=True)
    from repro_torch.kernels import _build, build_all
    t0 = time.perf_counter()
    build_all()
    if PARENT is not None:
        PARENT.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "parent": None if PARENT is None else
          {"source": PARENT.src, "seconds": PARENT.seconds},
          "kernels": {n: {"seconds": v["seconds"],
                          "ptxas": [ln for ln in v["ptxas"].splitlines()
                                    if "Used" in ln or "spill" in ln]}
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


def check_and_time(errs: dict, name: str, kernel, plain, args,
                   where) -> dict:
    """``kernel`` against ``plain`` (its plain version, run on the same
    card tensors), bit for bit, then both timed."""
    err = max_abs_err(kernel(*args), plain(*args))
    errs.setdefault(name, []).append(err)
    if err:
        fail(f"{name} differs from its plain version at {where}")
    return {"max_abs_err": err, "ms": time_ms(lambda: kernel(*args)),
            "plain_ms": time_ms(lambda: plain(*args))}


def superstep_bounds(args, gathered=None) -> dict:
    """The bounds of one superstep on a case ``(f, v, nxt, spare, flag,
    stamp, Bp, bwd, edges)``, ``edges`` an ``Edges`` epoch, from this
    run's data.  ``bound_ms``: what the function must move over its
    grouped inputs: the frontier it indexes read once (4*R*Vg*W; on a
    mesh also the shard's own f, 4*R*V*W, that v |= f reads), spare
    written (4*R*V*W), v read and written at each non-zero word of f
    (8), once each offset of an object live in some row (4), the pred of
    each edge of such an object (4), the subj of each edge whose
    transition is non-zero in some row (4), at each word a row's
    transition reaches v read (4) and, where the mask leaves bits, nxt
    written (4), and the tables once; no worklist.  Operations: W ORs
    per set bit of X below S, over the rows.  ``edge_pass_bound_ms``:
    :func:`edge_pass_bound` on the epoch's raw arrays, the yardstick of
    the edge pass this design replaced.  ``design_bytes_ms``: what the frontier scan and the tile
    expansion move on the same data: the state terms above, and per row
    two offsets a live (row, object) pair, 16 bytes a worklist entry
    (written, then read), the pred of each edge of a live object, the
    subj where its transition is non-zero, and v and nxt read at each
    word a transition reaches (nxt written where the mask leaves
    bits)."""
    import torch
    from repro_torch.kernels import packed_superstep as ksup
    from repro_torch.kernels.ref import nfa_step_ref, segment_or_ref
    f, v, Bp, bwd, edges = args[0], args[1], args[6], args[7], args[8]
    lay = edges.grouped
    g = f if gathered is None else gathered
    (R, V, W), Vg, S, L = f.shape, g.shape[1], bwd.shape[1], Bp.shape[1]
    deg = (lay.offsets[1:] - lay.offsets[:-1]).to(torch.int64)
    tiles = (deg + ksup.TILE - 1) // ksup.TILE
    objs = lay.objects().to(torch.int64)
    any_live = torch.zeros(Vg, dtype=torch.bool, device=f.device)
    edge_live = torch.zeros(objs.shape[0], dtype=torch.bool,
                            device=f.device)
    edge_y = torch.zeros_like(edge_live)
    pairs = entries = row_edges = row_y = targets = written = set_bits = 0
    for r in range(R):
        live = (g[r][:, :(S + 31) // 32] != 0).any(1) & (deg > 0)
        any_live |= live
        pairs += int(live.sum())
        entries += int(tiles[live].sum())
        on = live[objs].nonzero().squeeze(1)
        edge_live[on] = True
        X = g[r].index_select(0, objs[on]) & \
            Bp[r].index_select(0, lay.pred[on].clamp(0, L - 1))
        Y = nfa_step_ref(X, bwd[r])
        y = (Y != 0).any(1)
        edge_y[on[y]] = True
        row_edges += int(on.numel())
        row_y += int(y.sum())
        reach = segment_or_ref(Y, lay.subj[on], V)
        targets += int((reach != 0).sum())
        written += int(((reach & ~(v[r] | f[r])) != 0).sum())
        set_bits += ksup.set_bits_below(X, S)
    offsets = torch.zeros(Vg + 1, dtype=torch.bool, device=f.device)
    offsets[:-1] |= any_live
    offsets[1:] |= any_live
    state = (4 * g.numel() + (0 if gathered is None else 4 * f.numel())
             + 4 * R * V * W + 8 * int((f != 0).sum()) + 4 * R * (L + S) * W)
    need = state + 4 * (int(offsets.sum()) + int(edge_live.sum())
                        + int(edge_y.sum()) + targets + written)
    design = state + 8 * pairs + 16 * entries + 4 * (row_edges + row_y) \
        + 8 * targets + 4 * written
    b_ms, b_by = bound(need, set_bits * W, INT32_OPS_PER_S)
    edge_ms, edge_by = edge_pass_bound(f, v, Bp, bwd, edges.subj,
                                       edges.pred, edges.obj,
                                       gathered=gathered)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "edge_pass_bound_ms": edge_ms, "edge_pass_bound_by": edge_by,
            "design_bytes_ms": design / HBM_BYTES_PER_S * 1e3,
            "live_pairs": pairs, "worklist_entries": entries,
            "live_edges": row_edges}


def superstep_check_and_time(errs: dict, args, where,
                             gathered=None) -> dict:
    """``packed_superstep`` against its plain version on the epoch's raw
    edge arrays (``ref.packed_superstep_ref`` over ``edges.subj``,
    ``.pred`` and ``.obj``, so the grouped layout the card built is held
    to the edges it came from), bit for bit, each on its own copy of the
    state (it works in place): visited, nxt, spare and the flag after.
    Then both timed on a further copy, nxt and the worklist counters
    zeroed before each run (outside the timed events), so each run does
    the superstep's whole work again.  With a parent tree (``--parent``),
    the parent's pass on the same inputs is checked against the same
    result and timed in turns with the kernel: parent, kernel, kernel,
    parent.  Beside them, for one unsharded row, the unfused composition
    the pass replaced (``unfused_ms``), and the bounds
    (:func:`superstep_bounds`).  ``args``: ``(f, v, nxt, spare, flag,
    stamp, Bp, bwd, edges)``, ``edges`` an ``Edges`` epoch; ``gathered``:
    a shard's superstep, over the frontier gathered over the mesh."""
    import torch
    from repro_torch.kernels import packed_superstep as ksup
    from repro_torch.kernels.ref import packed_superstep_ref
    state, stamp, Bp, bwd, edges = args[:5], args[5], args[6], args[7], \
        args[8]
    layout = edges.grouped
    scratch = ksup.new_scratch(layout, state[0].shape[0])
    raw = (edges.subj, edges.pred, edges.obj)

    def run(step, *tail):
        copy = [t.clone() for t in state]
        step(*copy, stamp, Bp, bwd, *tail, gathered=gathered)
        return copy

    got = run(ksup.packed_superstep_cuda, layout, scratch)
    want = run(packed_superstep_ref, *raw)
    err = max_abs_err(*(torch.cat([t.reshape(-1) for t in c])
                        for c in (got, want)))
    errs.setdefault("packed_superstep", []).append(err)
    if err:
        fail(f"packed_superstep differs from its plain version at {where}")
    copy = [t.clone() for t in state]

    def fresh():
        copy[2].zero_()
        scratch.counters.zero_()

    def kernel():
        ksup.packed_superstep_cuda(*copy, stamp, Bp, bwd, layout, scratch,
                                   gathered=gathered)

    out = {"max_abs_err": err, "ms": time_ms(kernel, setup=fresh),
           "plain_ms": time_ms(lambda: packed_superstep_ref(
               *copy, stamp, Bp, bwd, *raw, gathered=gathered),
               setup=fresh),
           "grouped_edges": int(layout.subj.numel()),
           **superstep_bounds(args, gathered)}
    if PARENT is not None:
        out.update(PARENT.turns(args, gathered, want, kernel, fresh))
    if state[0].shape[0] == 1 and gathered is None:
        out["unfused_ms"] = unfused_ms(args, want[2][0], where)
    return out


def unfused_ms(args, want_next, where) -> float:
    """Card time of the superstep as the packed path ran it before
    ``packed_superstep`` fused it, on the same state: the gathers
    ``f[obj]`` and ``Bp[pred]``, the AND, ``nfa_step``, ``segment_or``
    into a zeroed buffer, the and-not, the OR into visited, and the stop
    test's reduction (its host sync left out, as the fused pass's flag
    read is).  Its next frontier must equal ``want_next``."""
    import torch
    from repro_torch.kernels import nfa_step as knfa
    from repro_torch.kernels import segment_or as kseg
    f, v = args[0][0], args[1][0]
    Bp, bwd = args[6][0], args[7][0]
    subj, pred, obj = args[8].subj, args[8].pred, args[8].obj
    visited = v | f                  # the unfused loop's visited holds f

    def step():
        X = f.index_select(0, obj) & Bp.index_select(0, pred)
        Y = knfa.nfa_step_cuda(X, bwd)
        new = kseg.segment_or_cuda(Y, subj, f.shape[0]) & ~visited
        visited.bitwise_or_(new)
        return new, (new != 0).any()

    new, _ = step()
    if not torch.equal(new, want_next):
        fail(f"the unfused superstep differs from packed_superstep at "
             f"{where}")
    return time_ms(step)


def kernel_check(errs: dict, name: str, kernel, plain, args, bound_ms,
                 **shape) -> dict:
    """:func:`check_and_time` at one shape; one JSON line, returned."""
    line = {"phase": "kernel_check", "kernel": name, **shape,
            **check_and_time(errs, name, kernel, plain, args, shape),
            "bound_ms": bound_ms[0], "bound_by": bound_ms[1]}
    emit(line)
    return line


def directory_plain(words):
    """The directory composed as the parent tree composed it on the
    card, with the plain popcounts: popcounts, ``cumsum``, ``cat``."""
    import torch
    from repro_torch.kernels import ref
    pc = ref.superblock_popcounts_ref(words)
    return torch.cat([pc.new_zeros(1), torch.cumsum(pc, 0,
                                                    dtype=torch.int32)])


def directory_check(errs: dict, words, **shape):
    """The popcount kernel's directory mode (one launch) against
    :func:`directory_plain`, bit for bit, then both timed and, with
    ``--parent``, the parent's own ``build_rank_directory`` (popcounts,
    ``cumsum``, ``cat``) in turns.  One JSON line; returns (directory,
    line)."""
    from repro_torch.kernels import rank_popcount as krank

    def kernel():
        return krank.rank_directory_cuda(words)

    got, want = kernel(), directory_plain(words)
    err = max_abs_err(got, want)
    errs.setdefault("superblock_popcounts", []).append(err)
    if err:
        fail(f"the rank directory differs from its plain version at {shape}")
    b = directory_bound(words)
    line = {"phase": "kernel_check", "kernel": "superblock_popcounts",
            "mode": "directory", **shape, "max_abs_err": err,
            "ms": time_ms(kernel), "plain_ms": time_ms(
                lambda: directory_plain(words)),
            "bound_ms": b[0], "bound_by": b[1]}
    if PARENT is not None:
        line.update(PARENT.turns_of("build_rank_directory", (words,), want,
                                    kernel))
    emit(line)
    return got, line


def rank1_check(errs: dict, words, directory, q, **shape) -> dict:
    """``rank1`` against its plain version, bit for bit, and timed, with
    its bound, the L2 sector bytes its design reads and the rate they
    imply (``l2_sector_bytes``, ``l2_tb_s``; ``word_walk_sector_bytes``
    for a load a word) and, with ``--parent``, the parent's ``rank1`` in
    turns.  One JSON line, returned."""
    from repro_torch.kernels import rank_popcount as krank
    from repro_torch.kernels import ref
    args = (words, directory, q)
    b = rank1_bound(*args)
    line = {"phase": "kernel_check", "kernel": "rank1", **shape,
            **check_and_time(errs, "rank1", krank.rank1_cuda,
                             ref.rank1_window_ref, args, shape),
            "bound_ms": b[0], "bound_by": b[1]}
    sectors = rank1_sector_bytes(words, q)
    line.update(l2_sector_bytes=sectors["design"],
                l2_tb_s=sectors["design"] / line["ms"] / 1e9,
                word_walk_sector_bytes=sectors["word_walk"])
    if PARENT is not None:
        line.update(PARENT.turns_of("rank1", args, krank.rank1_cuda(*args),
                                    lambda: krank.rank1_cuda(*args)))
    emit(line)
    return line


def nfa_layouts(X, bwd) -> dict:
    """Both of nfa_step's layouts on the same input, each bit-exact with
    the wrapper's launch, and timed: the times behind the wrapper's
    rule, and the layout it picks."""
    import torch
    from repro_torch.kernels import nfa_step as knfa
    want = knfa.nfa_step_cuda(X, bwd)
    times = {}
    for rows in ("thread_per_row", "warp_per_row"):
        if not torch.equal(knfa.launch_layout(X, bwd, rows), want):
            fail(f"nfa_step's {rows} layout differs at {tuple(X.shape)}")
        times[rows] = time_ms(lambda: knfa.launch_layout(X, bwd, rows))
    return {"layout": knfa.layout(X.shape[1]), "layout_ms": times}


def gather_ms(args) -> float:
    """Time of torch's ``index_select`` of the frontier rows every edge
    reads (``f[r][obj]`` for every row r) on a superstep's arguments: a
    yardstick for the part of the edge pass no design that reads every
    edge's frontier word avoids."""
    f, obj = args[0], args[8].obj
    return time_ms(lambda: f.index_select(1, obj))


def _superstep_state(rng, S: int, live: float, hubs, objects: str,
                     rows: int = 1):
    """packed_superstep arguments at the packed path's full size, with
    ``rows`` BFS rows: hub-law subjects (sorted, as ``DenseGraph`` keeps
    them), objects by the same law (``"hub"``) or uniform, uniform
    labels (an ``Edges`` epoch, grouped on the card, no inert label),
    frontiers with ``live`` of their rows non-zero, sparse visited sets,
    random tables (each row its own)."""
    import numpy as np
    import torch
    from repro_torch.core.dense import Edges
    from repro_torch.kernels.ops import words_to_tensor
    W = (S + 31) // 32

    def words(shape, keep):
        a = rng.integers(0, 2**32, shape, dtype=np.uint32)
        a[rng.random(shape[0]) >= keep] = 0
        if S % 32:
            a[:, -1] &= np.uint32((1 << (S % 32)) - 1)
        return words_to_tensor(a, "cuda")

    def ids(a):
        return torch.from_numpy(a.astype(np.int32)).to("cuda")

    f = words((rows * FULL_V, W), live).reshape(rows, FULL_V, W)
    v = words((rows * FULL_V, W), 0.2).reshape(rows, FULL_V, W) & ~f
    nxt = torch.zeros_like(f)
    spare = words((rows * FULL_V, W), 1.0).reshape(rows, FULL_V, W)
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    return (f, v, nxt, spare, flag, 1,
            words((rows * FULL_L, W), 1.0).reshape(rows, FULL_L, W),
            words((rows * S, W), 1.0).reshape(rows, S, W),
            Edges.build(ids(hubs), ids(rng.integers(0, FULL_L, FULL_E)),
                        ids(rng.permutation(hubs) if objects == "hub"
                            else rng.integers(0, FULL_V, FULL_E)),
                        FULL_V, FULL_L))


def _hub_ids(rng, E: int, V: int):
    """[E] sorted int32 segment ids drawn with the graph fixture's node
    law (weight rank**-0.8), so a few hub segments hold many rows."""
    import numpy as np
    wn = 1.0 / np.arange(1, V + 1, dtype=np.float64) ** 0.8
    return np.sort(rng.choice(V, size=E, p=wn / wn.sum())).astype(np.int32)


def _bitvector(rng, n_bits: int):
    """Packed uint32 words of ``n_bits`` random bits, padded to whole
    superblocks plus one, as the JAX package's rank tests pad them."""
    import numpy as np
    nw = ((n_bits + 511) // 512) * 16 + 16
    bits = np.zeros(nw * 32, dtype=bool)
    bits[:n_bits] = rng.random(n_bits) < 0.5
    return np.packbits(bits.reshape(nw, 32), axis=1,
                       bitorder="little").view(np.uint32).ravel()


def phase_kernels(errs: dict, capture: dict):
    import numpy as np
    import torch
    from repro_torch.kernels import nfa_step as knfa
    from repro_torch.kernels import rank_popcount as krank
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_or as kseg
    from repro_torch.kernels.ops import words_to_tensor
    rng = np.random.default_rng(2024)
    shapes = [(N, S, None) for N, S in SWEEP]
    shapes += [(N, S, 3) for N in MAIN_N for S in MAIN_S]
    shapes += [(1_000, S, 3) for S in EDGE_S]
    shapes += [(N, S, 3) for N in MAIN_N[1:] for S in LAYOUT_S]
    for N, S, density in shapes:
        X = words_to_tensor(_words(rng, N, S, density), "cuda")
        bwd = words_to_tensor(_words(rng, S, S), "cuda")
        kernel_check(errs, "nfa_step", knfa.nfa_step_cuda, ref.nfa_step_ref,
                     (X, bwd), nfa_bound(X, S), N=N, S=S, W=X.shape[1],
                     set_bits_per_row=density or "uniform",
                     **nfa_layouts(X, bwd))

    def ids(a):
        return torch.from_numpy(a).to("cuda")

    seg_shapes = [(E, W, V, "uniform", np.sort(rng.integers(0, V, E)))
                  for E, W, V in SEG_SWEEP]
    hubs = _hub_ids(rng, FULL_E, FULL_V)
    seg_shapes += [(FULL_E, W, FULL_V, values, hubs)
                   for W in FULL_W for values in ("uniform", "sparse")]
    for E, W, V, values, seg in seg_shapes:
        vals = rng.integers(0, 2**32, (E, W), dtype=np.uint32)
        if values == "sparse":
            vals[rng.random((E, W)) >= SPARSE_WORDS] = 0
        vals = words_to_tensor(vals, "cuda")
        kernel_check(errs, "segment_or", kseg.segment_or_cuda,
                     ref.segment_or_ref, (vals, ids(seg.astype(np.int32)), V),
                     segment_or_bound(vals, V), E=E, W=W, V=V, values=values)

    for R, S, live, objects in SUPERSTEP_SHAPES:
        args = _superstep_state(rng, S, live, hubs, objects, rows=R)
        line = {"phase": "kernel_check", "kernel": "packed_superstep",
                "R": R, "E": FULL_E, "V": FULL_V, "L": FULL_L, "S": S,
                "W": int(args[0].shape[2]), "live_rows": live,
                "objects": objects,
                **superstep_check_and_time(errs, args,
                                           (R, S, live, objects)),
                "gather_ms": gather_ms(args)}
        emit(line)
        if R == ROWS_TIMED and "rows" not in capture:
            capture["rows"] = line

    for E, W in SCAN_SHAPES:
        vals = words_to_tensor(
            rng.integers(0, 2**32, (E, W), dtype=np.uint32), "cuda")
        if E == FULL_E:        # segments of the packed path's edges
            starts = np.concatenate([[1], hubs[1:] != hubs[:-1]])
        else:
            starts = rng.random(E) < 0.1
            starts[0] = True
        flags = ids(starts.astype(np.int32))
        kernel_check(errs, "segmented_or_scan", kseg.segmented_or_scan_cuda,
                     ref.segmented_or_scan_ref, (vals, flags),
                     scan_bound(vals), E=E, W=W)
        capture["segmented_or_scan"] = (vals, flags)
    # both kernels' launch floors: one row, timed as the kernels themselves
    one = words_to_tensor(np.ones((1, 1), dtype=np.uint32), "cuda")
    zero = ids(np.zeros(1, dtype=np.int32))
    capture["segment_floor_ms"] = {
        "segment_or": kernel_check(
            errs, "segment_or", kseg.segment_or_cuda, ref.segment_or_ref,
            (one, zero, 1), segment_or_bound(one, 1), floor=True, E=1, W=1,
            V=1)["ms"],
        "segmented_or_scan": kernel_check(
            errs, "segmented_or_scan", kseg.segmented_or_scan_cuda,
            ref.segmented_or_scan_ref, (one, zero), scan_bound(one),
            floor=True, E=1, W=1)["ms"]}

    rank_kernels(errs, capture, rng)


def rank_kernels(errs: dict, capture: dict, rng) -> None:
    """Phase 1's rank points: at each of ``RANK_BITS`` the popcounts, the
    one-launch directory and ``rank1`` at ``RANK_QUERIES`` random and
    sorted offsets, then each kernel's launch floor."""
    import numpy as np
    import torch
    from repro_torch.kernels import rank_popcount as krank
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import words_to_tensor
    for n_bits in RANK_BITS:
        words = words_to_tensor(_bitvector(rng, n_bits), "cuda")
        kernel_check(errs, "superblock_popcounts",
                     krank.superblock_popcounts_cuda,
                     ref.superblock_popcounts_ref, (words,),
                     popcounts_bound(words), n_bits=n_bits,
                     NW=words.shape[0])
        directory, _line = directory_check(errs, words, n_bits=n_bits,
                                           NW=words.shape[0])
        for Q in RANK_QUERIES:
            q = torch.from_numpy(np.concatenate([[0, n_bits], rng.integers(
                0, n_bits + 1, Q - 2)]).astype(np.int32)).to("cuda")
            # random offsets, then the same sorted: the backward search
            # asks for ranks at range ends that lie close together
            for order, qo in (("random", q), ("sorted", torch.sort(q)[0])):
                rank1_check(errs, words, directory, qo, n_bits=n_bits, Q=Q,
                            order=order)
                want = ref.rank1_ref(words, qo)   # no directory, no window
                if not torch.equal(krank.rank1_cuda(words, directory, qo),
                                   want):
                    fail(f"rank1 differs from the prefix-sum rank at "
                         f"n_bits={n_bits} Q={Q} ({order})")
    # each kernel's launch floor, timed as the kernel itself
    w = words[:RANK_FLOOR_NW]
    floors = {
        "superblock_popcounts": kernel_check(
            errs, "superblock_popcounts", krank.superblock_popcounts_cuda,
            ref.superblock_popcounts_ref, (w,), popcounts_bound(w),
            floor=True, NW=RANK_FLOOR_NW)["ms"],
        "directory": directory_check(errs, w, floor=True,
                                     NW=RANK_FLOOR_NW)[1]["ms"],
        "rank1": rank1_check(errs, words, directory, q[2:2 + RANK_FLOOR_Q],
                             floor=True, NW=int(words.shape[0]),
                             Q=RANK_FLOOR_Q)["ms"]}
    capture["rank_floor_ms"] = floors


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


def deadline_overrun(ring, stats, queries, deadline_s: float, cap_s: float,
                     bound_s: float):
    """Seconds each of ``queries`` takes on a card engine over ``ring``
    under a ``deadline_s`` per-query deadline: how far past it the
    ``TimeoutError`` comes.  Each must come within ``bound_s`` of the
    deadline.  A ``SIGALRM`` stops a probe at ``cap_s`` (status
    "capped"), which fails too."""
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
            engine = RingRPQ(ring, device="cuda", stats=stats)
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
    for p in out:
        if p["status"] == "capped" or p["seconds"] > deadline_s + bound_s:
            fail(f"a {deadline_s} s deadline on hub closure {p['query']} "
                 f"ended after {p['seconds']:.3f} s ({p['status']}), more "
                 f"than {bound_s} s past it")
    return {"deadline_s": deadline_s, "cap_s": cap_s, "bound_s": bound_s,
            "probes": out}


def select_beside():
    """:func:`select_requests` in a process of its own (``spawn``: the
    parent holds a CUDA context), started before phase 1 so the host's
    one-request-at-a-time selection runs beside the kernels' checks.
    Returns the executor's future; the process ends with it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    future = pool.submit(_selection, BATCH, SCAN_CAP, BATCH_DEADLINE_S / 4)
    pool.shutdown(wait=False)
    return future


def _selection(count: int, scan_cap: int, backstop_s: float):
    """The selection on phase 2's graph and ring, both built again from
    their seed (the index ``make_engine`` builds), scalar tables on the
    host; the report adds the ring's build seconds."""
    from repro_torch.core import fixtures
    from repro_torch.core.ring import Ring
    from repro_torch.core.rpq import RingRPQ
    sizes, seed = MAIN_GRAPH
    graph = fixtures.scale_free_graph(*sizes, seed=seed)
    t0 = time.perf_counter()
    host = RingRPQ(Ring(graph), device="cpu")          # scalar tables
    ring_s = time.perf_counter() - t0
    queries, answers, skipped, report = select_requests(
        host, graph, count, scan_cap, backstop_s)
    return queries, answers, skipped, {**report, "ring_build_s": ring_s}


def run_main_path(graph, device: str, deadline_s: float, selection,
                  capture=None):
    """Build the engine, take the requests ``selection`` (the future of
    :func:`select_beside`) selected, answer them on ``device`` and hold
    the answers and counters to two host runs."""
    from repro_torch import kernels
    from repro_torch.core.engines import make_engine
    from repro_torch.core.rpq import RingRPQ
    from repro_torch.kernels import nfa_step as knfa
    from repro_torch.kernels import ops as kops
    stamps = Stamps()
    t0 = time.perf_counter()
    engine = make_engine(graph, device=device)
    ring_s = time.perf_counter() - t0
    stamps.mark("ring_build")
    queries, host_answers, skipped, sel = selection.result()
    stamps.mark("selection_wait")

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
    stamps.mark("card_batch")

    plain = RingRPQ(engine.ring, device="cpu", kernel_threshold=64)
    plain_stats = []
    t0 = time.perf_counter()
    plain_answers = plain.eval_many(queries, stats_out=plain_stats)
    plain_s = time.perf_counter() - t0
    stamps.mark("plain_kernel_host_batch")
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
    stamps.mark("compare")
    busy = device_busy(engine.ring, device, queries[:PROFILED_REQUESTS],
                       deadline_s)
    stamps.mark("profiled_rerun")
    # how far past its deadline a timed-out ring request may settle: these
    # probes and phase 9 (a) fail beyond it (PERF.md §6)
    from repro_torch.serve import OVERRUN_BOUND_S
    overrun = deadline_overrun(engine.ring, engine.graph_stats,
                               skipped[:OVERRUN_PROBES], OVERRUN_DEADLINE_S,
                               OVERRUN_CAP_S, OVERRUN_BOUND_S)
    stamps.mark("overrun_probes")
    report = {
        "graph": {"nodes": graph.num_nodes, "preds": graph.num_preds,
                  "edges": int(graph.s.size),
                  "ring_triples": int(engine.ring.n)},
        "cut": f"the profiled rerun: the first {PROFILED_REQUESTS} of "
               f"{len(queries)} requests",
        "ring_build_s": ring_s, "selection": sel,
        "requests": len(queries), "batch_s": batch_s,
        "plain_kernel_host_batch_s": plain_s,
        "kernel_launches": launches.get("nfa_step", 0),
        "kernel_batches": sum(s.kernel_batches for s in stats),
        "kernel_tasks": sum(s.kernel_tasks for s in stats),
        "bundle_kernel_batches": engine.bundle_kernel_batches,
        "max_tasks_per_launch": max(task_counts, default=0),
        "nfa_step_layout": knfa.layout(capture["X"].shape[1])
        if capture and "X" in capture else None,
        "answers": sum(len(a) for a in answers),
        "activations": sum(s.node_state_activations for s in stats),
        **busy,
        "skipped_hub_deadline_overrun": overrun,
        "substep_s": stamps.seconds,
    }
    return engine, queries, answers, skipped, report


def device_busy(ring, device, queries, deadline_s):
    """Rerun ``queries`` (the batch's first) on a fresh engine under
    ``torch.profiler``: the card's kernel and copy time against the
    rerun's wall time."""
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
    return {"profiled_batch_s": wall, "profiled_requests": len(queries),
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall}


# -- phase 3 -----------------------------------------------------------------
def phase_serving(ring, queries, answers_epoch0, adds):
    """A ``SlotScheduler`` over a CUDA engine on the main path's ring.
    The engine launches the kernel from one task up: at the default 64,
    slots of these small requests never merge enough tasks.  So every
    superstep goes through the kernel, on a dynamic bundle whose padded
    width changes as slots churn."""
    from repro_torch import kernels
    from repro_torch.core.rpq import RingRPQ
    from repro_torch.core.scheduler import SlotScheduler
    engine = RingRPQ(ring, device="cuda", kernel_threshold=1)
    sched = SlotScheduler(engine, max_slots=8)
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
# launch counts the packed path reports: its kernel, and the two it
# replaced, which it must no longer launch
PACKED_PATH_COUNTS = ("packed_superstep", "nfa_step", "segment_or")


def check_packed_launches(launches: dict, path: str) -> None:
    if launches["packed_superstep"] <= 0:
        fail(f"{path} launched no packed_superstep kernel")
    for k in ("nfa_step", "segment_or"):
        if launches[k]:
            fail(f"{path} launched {k}, which packed_superstep replaces")

def phase_oracle(device: str, num_queries: int = 8):
    """A smaller graph's answers, from the ring engine and from the packed
    BFS, both on the card, against the host oracle
    (``eval_oracle_by_label``, held to the JAX package's brute-force
    ``eval_oracle`` in ``tests/test_torch_core.py``)."""
    from repro_torch import kernels
    from repro_torch.core import fixtures, oracle, patterns
    from repro_torch.core.dense import DenseGraph
    from repro_torch.core.engines import make_engine
    from repro_torch.core.packed import packed_eval
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
    ring_s = time.perf_counter() - t0
    dg = DenseGraph.from_graph(graph, device=device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    packed = [packed_eval(dg, graph, e, s, o)[0] for e, s, o in qs]
    packed_launches = kernels.launch_counts()
    packed_s = time.perf_counter() - t0
    check_packed_launches(packed_launches, "the oracle phase's packed BFS")
    for (e, s, o), res, res_packed in zip(qs, got, packed):
        want = oracle.eval_oracle_by_label(graph, e, s, o)
        if res != want:
            fail(f"answer of {(e, s, o)} differs from the oracle")
        if res_packed != want:
            fail(f"packed BFS answer of {(e, s, o)} differs from the oracle")
    return {"phase": "oracle", "queries": len(qs),
            "answers": sum(len(r) for r in got),
            "kernel_batches": engine.bundle_kernel_batches,
            "kernel_launches": launches, "ring_s": ring_s,
            "packed_kernel_launches": {k: packed_launches[k] for k in
                                       PACKED_PATH_COUNTS},
            "packed_s": packed_s}


# -- phase 5 -----------------------------------------------------------------
# the hub closures phase 5's profiled rerun of (b) and phase 7's
# one-request-a-call pass answer (cut from all 605 for the script's time
# limit: the profile's event processing, not the run, took most of phase
# 5; the one-batch pass of phase 7 answers all 605)
HUB_SUBSET = 64


class HeaviestLaunch:
    """``packed_bfs``'s ``on_step`` hook: keeps the superstep whose
    transition has the most non-zero words (among those of the largest
    size), with copies of the state it read.  The superstep's ``nfa_step``
    input and ``segment_or`` values are not materialised on the path, so
    the hook builds them: two gathers and an ``nfa_step`` launch, then a
    count and a host sync.  Only the recorder's runs pay that, and they
    come after phase 5 has read its launch counts."""

    def __init__(self, dg):
        self.dg = dg
        self.key = (-1, -1)
        self.largest_E = 0
        self.nfa_step = self.segment_or = self.superstep = None

    def __call__(self, frontier, visited, Bp, bwd):
        import torch
        from repro_torch.kernels import nfa_step as knfa
        dg = self.dg
        X = frontier.index_select(0, dg.edges.obj) & \
            Bp.index_select(0, dg.edges.pred)
        Y = knfa.nfa_step_cuda(X, bwd)
        self.largest_E = max(self.largest_E, int(X.shape[0]))
        key = (Y.numel(), int((Y != 0).sum()))
        if key > self.key:
            self.key = key
            self.nfa_step = (X, bwd)
            self.segment_or = (Y, dg.edges.subj, dg.num_nodes)
            f = frontier[None].clone()          # one row
            self.superstep = (f, visited[None].clone(), torch.zeros_like(f),
                              torch.zeros_like(f),
                              torch.zeros(1, dtype=torch.int32,
                                          device=f.device),
                              1, Bp[None], bwd[None], dg.edges)


def phase_packed(graph, queries, ring_answers, skipped, errs: dict,
                 capture: dict, hub_answers: list):
    """The packed BFS on the card over phase 2's graph: (a) the batch's
    requests, held to the ring engine's answers; (b) the hub closures
    the batch left out, through ``packed_eval`` as a user calls it, then
    through ``packed_bfs`` alone (``in_packed_bfs_s``: apart from the
    answer sets ``packed_eval`` builds); (c) the first of those again on
    the card and on the host, with the plain versions, held word for
    word.  A profiled rerun of (b)'s first ``HUB_SUBSET`` hub closures
    gives the card's idle share, the host ops and kernels that take its
    time, and the ``cudaLaunchKernel`` calls a superstep.  The launch
    counts cover (a) and (b) through ``packed_eval``.  Then (a) and (b)
    run once more through ``packed_bfs`` with the recorder, untimed, and
    ``packed_superstep`` is checked and timed on the superstep with the
    most non-zero transition words, and ``nfa_step`` and ``segment_or``
    on that superstep's transition input and values.  (b)'s answer sets are
    appended to ``hub_answers``, for phase 7."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import regex as rx
    from repro_torch.core.dense import DenseGraph
    from repro_torch.core.packed import (one_endpoint_bfs, packed_bfs,
                                         packed_eval)
    from repro_torch.kernels import nfa_step as knfa
    from repro_torch.kernels import ref
    stamps = Stamps()
    t0 = time.perf_counter()
    dg = DenseGraph.from_graph(graph, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stamps.mark("dense_graph_build")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    steps_a = 0
    for q, want in zip(queries, ring_answers):
        got, steps = packed_eval(dg, graph, q.expr, q.subject, q.obj)
        steps_a += steps
        if got != want:
            fail(f"packed answer of {q} differs from the ring engine's")
    batch_s = time.perf_counter() - t0
    stamps.mark("a_batch")

    hub = []
    t0 = time.perf_counter()
    for q in skipped:
        t1 = time.perf_counter()
        got, steps = packed_eval(dg, graph, q.expr, q.subject, q.obj)
        hub.append((time.perf_counter() - t1, steps, len(got)))
        hub_answers.append(got)
    torch.cuda.synchronize()
    hub_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_packed_launches(launches, "the packed path")
    stamps.mark("b_hub_closures")

    def bfs(q):
        return one_endpoint_bfs(graph, rx.parse(q.expr), q.subject, q.obj)

    t0 = time.perf_counter()
    for q, (_s, steps, _n) in zip(skipped, hub):
        _vis, it = packed_bfs(dg, *bfs(q))
        if it != steps:
            fail(f"packed_bfs of {q} took {it} supersteps, packed_eval "
                 f"{steps}")
    in_bfs_s = time.perf_counter() - t0
    stamps.mark("b_in_packed_bfs")

    # (c) the first hub closures on the card and on the host
    host = DenseGraph.from_graph(graph, device="cpu")
    checked, t0 = [], time.perf_counter()
    for q in skipped[:HOST_CHECKS]:
        auto, start = bfs(q)
        vis, it = packed_bfs(dg, auto, start)
        t1 = time.perf_counter()
        want_vis, want_it = packed_bfs(host, auto, start)
        checked.append({"query": [q.expr, q.subject, q.obj],
                        "supersteps": it, "words": int(vis.size),
                        "host_s": time.perf_counter() - t1})
        if it != want_it or not np.array_equal(vis, want_vis):
            fail(f"packed BFS of {q} on the card differs from the host's")
    if len(checked) < HOST_CHECKS:
        fail(f"only {len(checked)} of {HOST_CHECKS} hub closures were "
             f"checked on the host")
    host_s = time.perf_counter() - t0
    stamps.mark("c_host_checks")

    # the recorder's runs, and the three kernels at the heaviest superstep
    heaviest = HeaviestLaunch(dg)
    t0 = time.perf_counter()
    for q in list(queries) + list(skipped):
        packed_bfs(dg, *bfs(q), on_step=heaviest)
    record_s = time.perf_counter() - t0
    stamps.mark("recorder_rerun")
    X, bwd = heaviest.nfa_step
    vals, _ids, V = capture["segment_or"] = heaviest.segment_or
    sup = capture["packed_superstep"] = heaviest.superstep
    at_launch = {
        "packed_superstep": {
            **superstep_check_and_time(errs, sup, "the heaviest superstep"),
            "gather_ms": gather_ms(sup),
            "E": int(X.shape[0]), "V": V, "S": int(bwd.shape[0]),
            "W": int(X.shape[1]),
            "live_rows": int((sup[0][0].index_select(0, dg.edges.obj) != 0)
                             .any(1).sum())},
        "nfa_step": {**check_and_time(errs, "nfa_step", knfa.nfa_step_cuda,
                                      ref.nfa_step_ref, (X, bwd),
                                      "the packed path's superstep"),
                     "bound": nfa_bound(X, bwd.shape[0]),
                     "layout": knfa.layout(X.shape[1])},
        "segment_or": {"nonzero_words": heaviest.key[1],
                       "nonzero_rows": int((vals != 0).any(1).sum()),
                       "bound": segment_or_bound(vals, V)}}
    stamps.mark("kernel_checks")
    busy = packed_busy(dg, graph, skipped[:HUB_SUBSET],
                       sum(h[1] for h in hub[:HUB_SUBSET]))
    stamps.mark("profiled_rerun")

    secs = np.array([h[0] for h in hub])
    steps = np.array([h[1] for h in hub])
    return {"phase": "packed_path",
            "graph": {"nodes": dg.num_nodes,
                      "edges": int(dg.edges.subj.numel()),
                      "labels": dg.num_labels},
            "dense_graph_build_s": build_s,
            "batch": {"requests": len(queries), "equal_to_ring": True,
                      "seconds": batch_s, "supersteps": steps_a},
            "hub_closures": {
                "requests": len(skipped), "seconds": hub_s,
                "in_packed_bfs_s": in_bfs_s,
                "answers": sum(h[2] for h in hub),
                "supersteps_total": int(steps.sum()),
                "supersteps_min_median_max": [int(steps.min()),
                                              float(np.median(steps)),
                                              int(steps.max())],
                "request_s_median_p99_max": [float(np.median(secs)),
                                             float(np.quantile(secs, 0.99)),
                                             float(secs.max())]},
            "host_checks": {"ran": len(checked), "seconds": host_s,
                            "runs": checked},
            "kernel_launches": {k: launches[k] for k in PACKED_PATH_COUNTS},
            "recorder_s": record_s,
            "largest_E_per_launch": heaviest.largest_E,
            "kernels_at_heaviest_superstep": at_launch,
            "cut": f"the profiled rerun: the first {HUB_SUBSET} of "
                   f"{len(skipped)} hub closures",
            **busy, "substep_s": stamps.seconds}


def packed_busy(dg, graph, skipped, supersteps: int, top: int = 8):
    """Rerun the hub closures ``skipped`` (of (b)), which took
    ``supersteps``, under ``torch.profiler``: the card's kernel and copy
    time against the rerun's wall time, the ``top`` host ops (self CPU
    time) and device kernels (self device time) of the rerun, and its
    CUDA runtime launch and copy calls, per superstep too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.packed import packed_eval
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in skipped:
            packed_eval(dg, graph, q.expr, q.subject, q.obj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    host = [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]

    def rows(evs, attr):
        evs = sorted(evs, key=lambda e: getattr(e, attr), reverse=True)
        return [[e.key[:60], e.count, getattr(e, attr) / 1e3]
                for e in evs[:top]]

    runtime = {e.key: e.count for e in host
               if e.key.startswith(("cudaLaunch", "cudaMemcpy"))}
    return {"profiled_hub_s": wall, "profiled_hubs": len(skipped),
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "runtime_calls": runtime,
            "cudaLaunchKernel_per_superstep":
                runtime.get("cudaLaunchKernel", 0) / max(supersteps, 1),
            "top_host_ops_count_ms": rows(host, "self_cpu_time_total"),
            "top_kernels_count_ms": rows(device, "self_device_time_total")}


# -- phase 6 -----------------------------------------------------------------
def phase_rank(ring, capture: dict, queries: int = 1_048_576, seed: int = 9):
    """The rank kernels on the ring's own wavelet bitvectors: every level
    of ``wt_s`` and ``wt_p``, its uint64 words viewed as uint32 (same bit
    order, same 512-bit superblocks).  The card's directory must equal
    the level's ``sb_rank``, and its ranks at random positions (and 0
    and n) the host ``BitVector.rank1`` and the plain version."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import rank1_window_ref
    rng = np.random.default_rng(seed)
    levels = [("wt_s", l, bv) for l, bv in enumerate(ring.wt_s.bvs)]
    levels += [("wt_p", l, bv) for l, bv in enumerate(ring.wt_p.bvs)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for tree, level, bv in levels:
        words = kops.words_to_tensor(bv.words.view(np.uint32), "cuda")
        directory = kops.build_rank_directory(words)
        if not np.array_equal(directory.cpu().numpy().astype(np.int64),
                              bv.sb_rank.astype(np.int64)):
            fail(f"rank directory of {tree} level {level} differs from "
                 f"sb_rank")
        pos = np.concatenate([[0, bv.n], rng.integers(0, bv.n + 1, queries)])
        q = torch.from_numpy(pos.astype(np.int32)).to("cuda")
        got = kops.rank1(words, directory, q)
        if not np.array_equal(got.cpu().numpy().astype(np.int64),
                              bv.rank1(pos)):
            fail(f"rank1 of {tree} level {level} differs from the host "
                 f"BitVector.rank1")
        if not torch.equal(got, rank1_window_ref(words, directory, q)):
            fail(f"rank1 of {tree} level {level} differs from its plain "
                 f"version")
        if words.numel() > capture.get("rank_words", -1):
            capture.update(rank_words=words.numel(),
                           rank=(words, directory, q))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for k in ("superblock_popcounts", "rank1"):
        if launches[k] <= 0:
            fail(f"the rank phase launched no {k} kernel")
    return {"phase": "rank", "levels": {"wt_s": len(ring.wt_s.bvs),
                                        "wt_p": len(ring.wt_p.bvs)},
            "bits_per_level": int(ring.wt_s.bvs[0].n),
            "queries_per_level": queries + 2,
            "equal_to_host_rank1": True,
            "kernel_launches": {k: launches[k] for k in
                                ("superblock_popcounts", "rank1")},
            "seconds": time.perf_counter() - t0}


# -- phase 7 -----------------------------------------------------------------
# requests and hub closures rerun with the plain version on the host, in
# one heterogeneous batch (R > 1 rows)
DENSE_HOST_REQUESTS = 14
DENSE_HOST_HUBS = 2
HOST_DEADLINE_S = 3_600.0   # a deadline, so supersteps count; never hit


def _dense_shapes(engine):
    """The engine's distinct dispatch shapes: (kind, R, S or S_pad)."""
    out = []
    for key in sorted(engine.traces.signatures, key=str):
        if key[0] in ("bfs_hetero", "bfs_chunk_hetero"):
            out.append([key[0], key[1], key[2]])
        elif key[0] in ("bfs_batched", "bfs_chunk_batched"):
            out.append([key[0], key[1], key[3]])
        else:
            out.append([key[0], 1, key[2]])
    return out


def _timed_dense_batch(engine, queries, deadline_s):
    """eval_many on a cleared result cache: (answers, seconds,
    supersteps, dispatches, packed_superstep launches)."""
    import torch
    from repro_torch import kernels
    engine.results.clear()
    acc0, disp0 = engine._superstep_acc, engine.hetero_dispatches
    n0 = kernels.launch_counts()["packed_superstep"]
    t0 = time.perf_counter()
    answers = engine.eval_many(queries, deadline_s=deadline_s)
    torch.cuda.synchronize()
    return (answers, time.perf_counter() - t0,
            engine._superstep_acc - acc0, engine.hetero_dispatches - disp0,
            kernels.launch_counts()["packed_superstep"] - n0)


def phase_dense(graph, queries, ring_answers, skipped, hub_answers,
                adds, capture: dict):
    """The dense engine (``make_engine(kind="dense")``) on the card over
    phase 2's graph: (1) phase 2's requests through ``eval_many``,
    answers equal to the ring's; (2) the hub closures, the first
    ``HUB_SUBSET`` one ``eval_many`` a request and then all in one batch,
    answers equal to phase 5's packed path; (3) two hub closures under a
    1 s deadline; (4) a few requests and hub closures in one batch again
    on the host with the plain version (R > 1): equal answers and
    supersteps; (6) ANALYZE of one hub closure: a timeline row a
    superstep; (7) a profiled rerun of (1)'s first ``PROFILED_REQUESTS``
    without a deadline; (8) a rerun of (1) with a recorder that keeps
    the heaviest R = 16 launch, for the kernels line.  The launch counts
    cover (1) and (2).  Then (5), serving: a ``SlotScheduler`` over the
    engine, as phase 3, with its own counts, and the seconds the grouped
    edge layout takes to build after its live update.  Every batch runs under a deadline, so the engine
    counts its supersteps (the JAX package's rule).  (1) runs twice: with
    its plans and planner decisions cold, then warm; the planner's
    statistics are harvested before it and timed apart."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.engines import make_engine
    stamps = Stamps()
    t0 = time.perf_counter()
    engine = make_engine(graph, kind="dense")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stamps.mark("engine_build")

    t0 = time.perf_counter()
    engine.graph_stats             # the planner's statistics, harvested once
    stats_s = time.perf_counter() - t0
    stamps.mark("planner_stats")
    kernels.reset_launch_counts()
    answers, batch_s, steps, dispatches, launches_a = _timed_dense_batch(
        engine, queries, BATCH_DEADLINE_S)
    for q, got, want in zip(queries, answers, ring_answers):
        if got != want:
            fail(f"dense answer of {q} differs from the ring engine's")
    shapes_a = _dense_shapes(engine)
    stamps.mark("1_batch_cold")
    again, warm_s, *_ = _timed_dense_batch(engine, queries,
                                           BATCH_DEADLINE_S)
    if again != answers:
        fail("the dense engine's warm rerun differs from its first run")
    del again
    stamps.mark("1_batch_warm")

    per_request, hub_steps = [], []
    for q, want in zip(skipped[:HUB_SUBSET], hub_answers):
        got, secs, st, _d, _n = _timed_dense_batch(engine, [q],
                                                   BATCH_DEADLINE_S)
        per_request.append(secs)
        hub_steps.append(st)
        if got[0] != want:
            fail(f"dense answer of hub closure {q} differs from the packed "
                 f"path's")
    stamps.mark("2_hubs_one_a_call")
    got, hub_batch_s, hub_batch_steps, hub_dispatches, _n = \
        _timed_dense_batch(engine, skipped, BATCH_DEADLINE_S)
    if got != hub_answers:
        fail("the batched hub closures differ from the packed path's")
    del got
    launches = kernels.launch_counts()
    check_packed_launches(launches, "the dense path")
    stamps.mark("2_hubs_one_batch")

    overrun = []
    for q in skipped[:OVERRUN_PROBES]:
        t1, status = time.perf_counter(), "finished"
        try:
            engine.eval(q.expr, q.subject, q.obj,
                        deadline_s=OVERRUN_DEADLINE_S)
        except TimeoutError:
            status = "timeout"
        overrun.append({"query": [q.expr, q.subject, q.obj],
                        "status": status,
                        "seconds": time.perf_counter() - t1})
    stamps.mark("3_overrun_probes")

    mixed = list(queries[:DENSE_HOST_REQUESTS]) + \
        list(skipped[:DENSE_HOST_HUBS])
    # the card engine's statistics, so the host's planner decides alike
    # without harvesting them again
    host = make_engine(graph, kind="dense", device="cpu",
                       stats=_stats_copy(engine.graph_stats))
    card_mixed = _timed_dense_batch(engine, mixed, HOST_DEADLINE_S)
    t1 = time.perf_counter()
    host_mixed = host.eval_many(mixed, deadline_s=HOST_DEADLINE_S)
    host_s = time.perf_counter() - t1
    if host_mixed != card_mixed[0]:
        fail("the dense engine's answers on the card differ from the host's")
    if host._superstep_acc != card_mixed[2] or \
            host.hetero_dispatches != card_mixed[3]:
        fail("the dense engine's supersteps on the card differ from the "
             "host's")
    host_check = {"requests": DENSE_HOST_REQUESTS, "hub_closures":
                  DENSE_HOST_HUBS, "supersteps": card_mixed[2],
                  "dispatches": card_mixed[3], "card_s": card_mixed[1],
                  "host_s": host_s, "shapes": _dense_shapes(host)}
    del host, host_mixed, card_mixed
    stamps.mark("4_host_plain_check")

    q = skipped[0]
    from repro_torch.core.engines import Query
    report = engine.explain(Query(q.expr, q.subject, q.obj), analyze=True)
    ex = report["execution"]
    if not ex["supersteps"] == len(ex["timeline"]) == \
            ex["stats"]["supersteps"] > 0:
        fail("the ANALYZE timeline's length differs from its supersteps")
    analyze = {"query": [q.expr, q.subject, q.obj],
               "supersteps": ex["supersteps"],
               "kernel_ms": sum(r["kernel_ms"] for r in ex["timeline"]),
               "elapsed_ms": ex["elapsed_ms"]}
    stamps.mark("6_analyze")

    # the profiled requests' own supersteps (counted under a deadline)
    profiled_steps = _timed_dense_batch(
        engine, queries[:PROFILED_REQUESTS], BATCH_DEADLINE_S)[2]
    profiled = dense_busy(engine, queries[:PROFILED_REQUESTS],
                          profiled_steps)
    stamps.mark("7_profiled_rerun")
    recorded = record_dense_launch(engine, queries, capture)
    if recorded.pop("answers") != ring_answers:
        fail("the dense engine's recorded rerun differs from the ring's")
    stamps.mark("8_recorded_rerun")
    serving = dense_serving(engine, queries, ring_answers, adds)
    stamps.mark("5_serving")

    secs = np.array(per_request)
    return {"phase": "dense_path", "dense_engine_build_s": build_s,
            "planner_stats_s": stats_s,
            "cut": f"the hub closures one request a call: the first "
                   f"{len(per_request)} of {len(skipped)} (the one-batch "
                   f"pass answers all {len(skipped)}); the profiled rerun: "
                   f"the first {PROFILED_REQUESTS} of {len(queries)} "
                   f"requests",
            "batch": {"requests": len(queries), "equal_to_ring": True,
                      "seconds": batch_s, "warm_seconds": warm_s,
                      "supersteps": steps,
                      "dispatches": dispatches, "launches": launches_a,
                      "launches_after_empty_superstep": launches_a - steps,
                      "shapes": shapes_a},
            "hub_closures": {
                "requests": len(skipped), "equal_to_packed_path": True,
                "one_a_call": len(per_request),
                "request_s_median_p99_max": [float(np.median(secs)),
                                             float(np.quantile(secs, 0.99)),
                                             float(secs.max())],
                "supersteps_total": int(sum(hub_steps)),
                "one_a_call_s": float(secs.sum()),
                "one_batch_s": hub_batch_s,
                "one_batch_supersteps": hub_batch_steps,
                "one_batch_dispatches": hub_dispatches},
            "kernel_launches": {k: launches[k] for k in PACKED_PATH_COUNTS},
            "hub_deadline_overrun": {"deadline_s": OVERRUN_DEADLINE_S,
                                     "probes": overrun},
            "host_plain_check": host_check, "analyze": analyze,
            **profiled, "recorded_rerun": recorded,
            "serving": serving, "substep_s": stamps.seconds}, engine, stats_s


def dense_busy(engine, queries, supersteps: int,
               chunk_span: str = "dense.bfs_chunk"):
    """Rerun ``queries``, which took ``supersteps`` under a deadline,
    without one (so the loop's chunks grow 1, 2, 4, ... 16) under
    ``torch.profiler`` and a tracer: the card's busy time against the
    rerun's wall time, its CUDA runtime calls, the ``packed_superstep``
    launches and the flag reads (one a ``chunk_span`` span), per
    superstep too: the same rows run the same supersteps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.obs import trace as otrace
    engine.results.clear()
    tracer = otrace.Tracer().enable()
    n0 = kernels.launch_counts()["packed_superstep"]
    with otrace.use(tracer), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        engine.eval_many(queries)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()["packed_superstep"] - n0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    runtime = {e.key: e.count for e in events
               if e.key.startswith(("cudaLaunch", "cudaMemcpy"))}
    reads = sum(1 for e in tracer.events if e["name"] == chunk_span)
    return {"profiled_batch_s": wall, "profiled_requests": len(queries),
            "profiled_supersteps": supersteps,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "runtime_calls": runtime,
            "cudaLaunchKernel_per_superstep":
                runtime.get("cudaLaunchKernel", 0) / max(supersteps, 1),
            "cudaMemcpyAsync_per_superstep":
                runtime.get("cudaMemcpyAsync", 0) / max(supersteps, 1),
            "launches_no_deadline": launches,
            "launches_after_empty_superstep_no_deadline":
                launches - supersteps,
            "flag_reads": reads,
            "flag_reads_per_superstep": reads / max(supersteps, 1)}


def dense_serving(engine, queries, ring_answers, adds):
    """Phase 3 on the dense engine: a ``SlotScheduler`` over it on the
    card answers 16 requests admitted one at a time with phase 3's live
    ``add_edges`` in between; each answer must equal ``eval_many`` at its
    ticket's epoch (epoch 0: the ring's answers)."""
    from repro_torch import kernels
    from repro_torch.core.scheduler import SlotScheduler
    engine.results.clear()          # every request takes a slot
    sched = SlotScheduler(engine, max_slots=8)
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
    launches = kernels.launch_counts()
    check_packed_launches(launches, "dense serving")
    build = grouped_layout_build(engine)
    engine.results.clear()
    want = {0: ring_answers[:16], engine.epoch: engine.eval_many(reqs)}
    epochs = []
    for i, (q, t) in enumerate(zip(reqs, tickets)):
        epochs.append(t.epoch)
        if t.result() != want[t.epoch][i]:
            fail(f"dense slot answer of {q} at epoch {t.epoch} differs "
                 f"from eval_many")
    return {"requests": len(reqs), "epochs": epochs,
            "admitted": sched.admitted,
            "peak_in_flight": sched.peak_in_flight,
            "kernel_launches": {k: launches[k] for k in PACKED_PATH_COUNTS},
            "serve_s": serve_s, "grouped_layout_after_update": build}


def grouped_layout_build(engine, runs: int = 3) -> dict:
    """Seconds to group the engine's effective edges (the epoch its live
    update built) by object on the card, as the mutation did: the
    median of ``runs`` builds, each ended by its host read of the tile
    count."""
    import torch
    from repro_torch.core.dense import Edges
    eff = engine._edges()
    if eff is engine.dg.edges:
        fail("dense serving's update left no effective edge epoch")
    secs = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Edges.build(eff.subj, eff.pred, eff.obj, engine.dg.num_nodes,
                    engine.dg.num_labels)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"seconds_median": statistics.median(secs), "runs": secs,
            "edges": int(eff.subj.numel()),
            "grouped_edges": int(eff.grouped.subj.numel()),
            "tiles": eff.grouped.tiles}


# -- phase 8 -----------------------------------------------------------------
MESH_SHARDS = 4          # shards of one card, as a 4-device mesh would have
MESH_HUBS = 32           # hub closures phase 8 (b) answers, one call each
MODEL_SUBSET = (256, 8)  # phase 8 (c): requests, hub closures


def _card_mesh(shape, names):
    """A mesh naming the one card at every position of ``shape``."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import Mesh
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [torch.device("cuda", 0)] * devices.size
    return Mesh(devices.reshape(shape), names)


def _launch_delta(before: dict) -> dict:
    from repro_torch import kernels
    now = kernels.launch_counts()
    return {k: now[k] - before[k] for k in PACKED_PATH_COUNTS}


def _mesh_batch(engine, queries, deadline_s):
    """eval_many of the sharded dense engine on a cleared result cache:
    (answers, seconds, counters): dispatches, counted supersteps,
    launches per kernel, the shards' launched supersteps (launches over
    shards) and the all-gather bytes, in all and per launched superstep."""
    import torch
    from repro_torch import kernels
    engine.results.clear()
    sh = engine.sharded
    d0, s0, g0 = sh.dispatches, sh.supersteps, sh.gather_bytes
    n0 = kernels.launch_counts()
    t0 = time.perf_counter()
    answers = engine.eval_many(queries, deadline_s=deadline_s)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launch_delta(n0)
    launched = launches["packed_superstep"] // (sh.num_shards *
                                               sh._pad_multiple)
    moved = sh.gather_bytes - g0
    return answers, secs, {
        "dispatches": sh.dispatches - d0, "supersteps": sh.supersteps - s0,
        "launches": launches, "launched_supersteps": launched,
        "gather_bytes": moved,
        "gather_bytes_per_launched_superstep": moved / max(launched, 1)}


def phase_mesh(graph, ring, stats, stats_s, queries, ring_answers, skipped,
               hub_answers, source, capture):
    """Both engines sharded over a mesh of 4 x the card (``Mesh``, a
    device named once per shard; each shard its own tensors and one
    launch a superstep over the all-gathered frontier) on phase 2's
    graph, nothing cut, with phase 2's ``Ring`` and phase 7's
    ``GraphStats`` passed in through ``stats=``: (a) the ring,
    ``RingRPQ(ring, mesh=...)``, on phase 2's requests, answers equal to
    phase 2's, ``nfa_step`` launched once a shard per sharded batch; (b)
    the dense engine on the same mesh, on phase 2's requests (equal to
    the ring's) and the first 32 hub closures one call each (equal to
    phases 5 and 7), then a profiled rerun of the requests; (c) the
    dense engine on a 2 x 2 data x model mesh on a subset; (d) phase 7's
    statistics and overlay (after its live ``add_edges``) saved with
    ``repro_torch.checkpoint``, restored onto the card and loaded into a
    new 4-shard dense engine, whose answers must equal the phase-7
    engine's at its epoch (taken before the phase's counts start).  Each
    part resets nothing: its launches are the counts' growth over it, and
    the phase's are reset just before (a) and read after (d)."""
    import tempfile
    import torch
    from repro_torch import checkpoint, kernels
    from repro_torch.core.engines import Query, make_engine
    from repro_torch.core.rpq import RingRPQ
    from repro_torch.core.stats import GraphStats
    from repro_torch.kernels import ops as kops
    mesh = _card_mesh((MESH_SHARDS,), ("data",))
    out = {"phase": "mesh", "mesh": {"shape": mesh.shape, "devices": sorted(
        {str(d) for d in mesh.devices.flat})}}
    nq, nh = MODEL_SUBSET
    # (d)'s yardstick, phase 7's engine at its epoch, answers before the
    # phase's counts start: its launches are not the mesh's
    restore_reqs = list(queries[:nq]) + list(skipped[:4])
    source.results.clear()
    restore_want = source.eval_many(restore_reqs)
    kernels.reset_launch_counts()

    # (a) the ring: one nfa_step launch a shard per sharded batch
    original = kops.nfa_step

    def recording(X, bwd):     # keep the largest shard launch's inputs
        if X.shape[0] > capture.get("shard_N", -1):
            capture.update(shard_N=X.shape[0], shard_X=X, shard_bwd=bwd)
        return original(X, bwd)

    n0 = kernels.launch_counts()
    engine = RingRPQ(ring, mesh=mesh, stats=stats)
    kops.nfa_step = recording
    try:
        t0 = time.perf_counter()
        answers = engine.eval_many(queries, deadline_s=BATCH_DEADLINE_S)
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t0
    finally:
        kops.nfa_step = original
    launches = _launch_delta(n0)
    if answers != ring_answers:
        fail("the sharded ring's answers differ from phase 2's")
    batches = engine.sharded_kernel_batches
    if batches <= 0 or launches["nfa_step"] < MESH_SHARDS * batches:
        fail(f"the sharded ring launched nfa_step {launches['nfa_step']} "
             f"times over {batches} sharded batches of {MESH_SHARDS} shards")
    out["ring"] = {"requests": len(queries), "equal_to_phase_2": True,
                   "seconds": ring_s, "sharded_kernel_batches": batches,
                   "tasks_per_shard": capture.get("shard_N"),
                   "kernel_launches": launches}
    del engine, answers

    # (b) the dense engine on the same mesh
    t0 = time.perf_counter()
    engine = make_engine(graph, kind="dense", mesh=mesh, stats=stats)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    answers, batch_s, batch = _mesh_batch(engine, queries, BATCH_DEADLINE_S)
    if answers != ring_answers:
        fail("the sharded dense engine's answers differ from the ring's")
    again, warm_s, _warm = _mesh_batch(engine, queries, BATCH_DEADLINE_S)
    if again != answers:
        fail("the sharded dense engine's warm rerun differs from its first")
    del answers, again
    hub = []
    for q, want in zip(skipped[:MESH_HUBS], hub_answers):
        got, secs, info = _mesh_batch(engine, [q], BATCH_DEADLINE_S)
        if got[0] != want:
            fail(f"the sharded dense answer of hub closure {q} differs from "
                 f"phases 5 and 7")
        hub.append((secs, info))
    if len(hub) < MESH_HUBS:
        fail(f"only {len(hub)} hub closures ran on the mesh")
    total = {k: sum(h[1]["launches"][k] for h in hub) + batch["launches"][k]
             for k in PACKED_PATH_COUNTS}
    check_packed_launches(total, "the sharded dense path")
    recorded = record_shard_launch(engine, queries, skipped[:MESH_HUBS],
                                   capture)
    if recorded["answers"] != (ring_answers, hub_answers[:MESH_HUBS]):
        fail("the sharded dense engine's recorded rerun differs")
    del recorded["answers"]
    model = {}
    for name, q in (("request", queries[0]), ("hub_closure", skipped[0])):
        col = engine.explain(Query(q.expr, q.subject, q.obj))["collective"]
        model[name] = {"query": [q.expr, q.subject, q.obj], **col}
    first = hub[0][1]
    sh = engine.sharded
    gather = {
        "measured_bytes_per_launched_superstep": {
            "batch": batch["gather_bytes_per_launched_superstep"],
            "rows_per_dispatch": engine.source_batch,
            "hub_closure": first["gather_bytes_per_launched_superstep"]},
        "analyze_model_bytes_per_superstep": model,
        "note": ("measured: every shard's [R, V_pad/n, W] int32 words "
                 "copied into one [R, V_pad, W] buffer of the card, R rows "
                 "a dispatch; ANALYZE: int8 planes [V_pad, S] of one query, "
                 "(n-1)/n of them per device")}
    profiled = dense_busy(engine, queries, batch["supersteps"],
                          chunk_span="dense.sharded_chunk")
    secs = [h[0] for h in hub]
    out["dense"] = {
        "build_s": build_s, "num_shards": sh.num_shards,
        "nodes_per_shard": sh.sg.nodes_per_shard,
        "edges_per_shard": int(sh.sg.subj_local.shape[1]),
        "batch": {"requests": len(queries), "equal_to_ring": True,
                  "seconds": batch_s, "warm_seconds": warm_s, **batch},
        "hub_closures": {"requests": len(hub), "equal_to_phases_5_7": True,
                         "seconds": sum(secs),
                         "request_s_median_max": [statistics.median(secs),
                                                  max(secs)],
                         "supersteps": sum(h[1]["supersteps"] for h in hub),
                         "launches": sum(h[1]["launches"]["packed_superstep"]
                                         for h in hub)},
        "all_gather": gather, "profiled": profiled,
        "recorded_rerun": recorded}
    del engine

    # (c) 2 x 2 data x model: each data shard's edges split over 2 replicas
    mesh22 = _card_mesh((2, 2), ("data", "model"))
    n0 = kernels.launch_counts()
    t0 = time.perf_counter()
    engine = make_engine(graph, kind="dense", mesh=mesh22,
                         model_axis="model", stats=stats)
    answers, sub_s, sub = _mesh_batch(engine, queries[:nq], BATCH_DEADLINE_S)
    if answers != ring_answers[:nq]:
        fail("the 2 x 2 mesh's answers differ from the ring's")
    got, hubs_s, hubs = _mesh_batch(engine, skipped[:nh], BATCH_DEADLINE_S)
    if got != hub_answers[:nh]:
        fail("the 2 x 2 mesh's hub closures differ from phases 5 and 7")
    launches = _launch_delta(n0)
    check_packed_launches(launches, "the 2 x 2 mesh")
    out["data_model"] = {"mesh": mesh22.shape,
                         "seconds": time.perf_counter() - t0,
                         "requests": {"count": nq, "seconds": sub_s, **sub},
                         "hub_closures": {"count": nh, "seconds": hubs_s,
                                          **hubs},
                         "kernel_launches": launches}
    del engine, answers, got

    # (d) checkpoint phase 7's state, restore it onto a 4-shard engine
    state = {"overlay": source.overlay_state(),
             "stats": source.graph_stats.to_state()}
    if state["overlay"] is None:
        fail("phase 7's engine has no overlay to checkpoint")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = checkpoint.save(d, source.epoch, state)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        t0 = time.perf_counter()
        got, _extra = checkpoint.restore(d, state, verify=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    n0 = kernels.launch_counts()
    t0 = time.perf_counter()
    restored_stats = GraphStats.from_state(got["stats"])
    engine = make_engine(graph, kind="dense", mesh=mesh, stats=restored_stats)
    build_s = time.perf_counter() - t0
    # the restored statistics plan epoch 0 without a harvest
    answers, base_s, base = _mesh_batch(engine, queries[:nq],
                                        BATCH_DEADLINE_S)
    if answers != ring_answers[:nq]:
        fail("the restored 4-shard engine's answers differ from the ring's")
    if engine._stats is not restored_stats:
        fail("the restored engine rebuilt its statistics")
    # then the overlay: the engine takes phase 7's epoch, and (the JAX
    # package's rule) drops statistics priced before it and harvests anew
    t0 = time.perf_counter()
    engine.load_overlay(got["overlay"])
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.graph_stats
    reharvest_s = time.perf_counter() - t0
    if engine.epoch != source.epoch:
        fail("the restored engine's epoch differs from phase 7's")
    reqs = restore_reqs
    answers, ans_s, info = _mesh_batch(engine, reqs, BATCH_DEADLINE_S)
    if answers != restore_want:
        fail("the restored 4-shard engine's answers differ from phase 7's")
    launches = _launch_delta(n0)
    check_packed_launches(launches, "the restored mesh engine")
    out["checkpoint"] = {
        "epoch": engine.epoch, "bytes": size,
        "codec": checkpoint.DEFAULT_CODEC,
        "arrays": sum(len(v) for v in state.values()),
        "save_s": save_s, "restore_s": restore_s,
        "stats_from_graph_s": stats_s, "engine_build_s": build_s,
        "epoch_0": {"requests": nq, "equal_to_ring": True,
                    "stats_harvested": False, "seconds": base_s, **base},
        "load_overlay_s": load_s, "stats_reharvest_after_overlay_s":
            reharvest_s,
        "at_epoch": {"requests": len(reqs), "equal_to_phase_7": True,
                     "seconds": ans_s, **info},
        "kernel_launches": launches}
    phase_launches = kernels.launch_counts()
    out["kernel_launches"] = {k: phase_launches[k]
                              for k in PACKED_PATH_COUNTS}
    if not phase_launches["packed_superstep"] or \
            not phase_launches["nfa_step"]:
        fail("the mesh phase launched no packed_superstep or nfa_step")
    return out


def _recorder(capture: dict, key: str, epochs, keep):
    """A stand-in for ``ops.packed_superstep`` that keeps, in
    ``capture[key]``, a copy of the inputs of the launch with the most
    non-zero transition inputs ``X = g[obj] & Bp[pred]`` over its rows
    (the epoch's whole edge arrays: padding and tombstones, inert, give
    no X) among those ``keep(f, gathered)`` accepts, and runs the launch.
    ``epochs()`` lists the ``Edges`` epochs a launch's grouped layout may
    belong to.  Returns (recording function, launches seen)."""
    import torch
    from repro_torch.kernels import ops as kops
    original = kops.packed_superstep
    seen = [0]

    def recording(f, v, nxt, spare, flag, stamp, Bp, bwd, layout, scratch,
                  gathered=None):
        seen[0] += 1
        if keep(f, gathered):
            edges = next(e for e in epochs() if e.grouped is layout)
            g = f if gathered is None else gathered
            live = int(torch.count_nonzero(g.index_select(1, edges.obj) &
                                           Bp.index_select(1, edges.pred)))
            if live > capture.get(key + "_live", -1):
                state = tuple(t.clone() for t in (f, v, nxt, spare, flag))
                capture[key + "_live"] = live
                capture[key] = ((*state, stamp, Bp, bwd, edges),
                                None if gathered is None
                                else gathered.clone())
        original(f, v, nxt, spare, flag, stamp, Bp, bwd, layout, scratch,
                 gathered=gathered)

    return recording, seen


def record_shard_launch(engine, queries, hubs, capture: dict) -> dict:
    """Rerun (b)'s requests (one ``eval_many``) and hub closures (one call
    each) on the sharded dense engine with a recorder (:func:`_recorder`)
    on ``ops.packed_superstep``: it keeps the shard launch with the most
    non-zero transition inputs over its rows, as phase 5 keeps its
    heaviest superstep, in ``capture["shard_superstep"]``: the launch's
    arguments (its ``Edges``: the shard's padded arrays and their grouped
    view) and its gathered [R, V_pad, W] buffer, for the kernels line.
    Returns the answers, the seconds and the launches recorded."""
    import torch
    from repro_torch.kernels import ops as kops
    original = kops.packed_superstep
    edges = engine.sharded._edges
    recording, seen = _recorder(
        capture, "shard_superstep",
        lambda: [e for row in edges for e in row],
        lambda f, gathered: gathered is not None)
    engine.results.clear()
    kops.packed_superstep = recording
    try:
        t0 = time.perf_counter()
        answers = engine.eval_many(queries)
        hub_answers = []
        for q in hubs:
            engine.results.clear()
            hub_answers.append(engine.eval_many([q])[0])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        kops.packed_superstep = original
    if not seen[0]:
        fail("the recorded rerun reached no shard launch")
    lay = capture["shard_superstep"][0][8]
    capture["shard_of"] = next(k for k, row in enumerate(edges)
                               for e in row if e is lay)
    return {"answers": (answers, hub_answers), "seconds": secs,
            "launches_recorded": seen[0],
            "heaviest_transition_words": capture["shard_superstep_live"],
            "heaviest_shard": capture["shard_of"]}


def record_dense_launch(engine, queries, capture: dict) -> dict:
    """Rerun phase 7 (1)'s requests (one ``eval_many``, no deadline) with
    a recorder (:func:`_recorder`) on ``ops.packed_superstep`` that keeps
    the real R = 16 launch with the most non-zero transition inputs, in
    ``capture["dense_superstep"]``, for the kernels line (phase 1's R =
    16 state is synthetic).  Returns the answers, the seconds and the
    launches recorded."""
    import torch
    from repro_torch.kernels import ops as kops
    original = kops.packed_superstep
    recording, seen = _recorder(
        capture, "dense_superstep",
        lambda: [e for e in (engine.dg.edges, engine._eff) if e is not None],
        lambda f, gathered: f.shape[0] == ROWS_TIMED and gathered is None)
    engine.results.clear()
    kops.packed_superstep = recording
    try:
        t0 = time.perf_counter()
        answers = engine.eval_many(queries)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        kops.packed_superstep = original
    if "dense_superstep" not in capture:
        fail(f"the dense path's rerun made no launch of {ROWS_TIMED} rows")
    return {"answers": answers, "seconds": secs,
            "launches_recorded": seen[0],
            "heaviest_transition_words": capture["dense_superstep_live"]}


# -- phase 9 -----------------------------------------------------------------
SERVE_SLOTS = 64             # max_slots, and the requests the client keeps out
# the ring's per-request deadline, cut from the paper's 60 s: a hub closure
# does not finish on the ring in 17 s, and 605 of them at 60 s do not fit
RING_SERVE_DEADLINE_S = 1.0
# (b), the dense engine, and (c), the mesh, serve the regular requests and
# only the first hub closures (cut from all 605, to leave phase 10 its time:
# phase 7 answers all 605 on the dense engine in one batch)
SERVE_HUBS = 64


def _stats_copy(stats):
    """A private copy: a live update refreshes an engine's statistics in
    place, and each engine here takes its own update."""
    from repro_torch.core.stats import GraphStats
    return GraphStats.from_state(stats.to_state())


def phase_serving_front(graph, ring, stats, tried: int, queries, answers,
                        skipped, hub_answers, capture):
    """The serving front (``repro_torch.serve``) on phase 2's graph and
    the ``tried`` requests phase 2 tried, in workload order (its 2,048
    and the hub closures it left out): ``AsyncServer`` over a
    ``SlotScheduler`` of 64 slots, a closed-loop client with 64 in
    flight, 16 edges added after half are submitted, ``/metrics``,
    ``/flight`` and ``/explain`` scraped over HTTP; on (a) the ring under
    a 1 s deadline, every timeout settling within
    ``serve.OVERRUN_BOUND_S`` of its deadline, (b) the dense engine and
    (c) the dense engine on a mesh of 4 x the card under 60 s, with no
    timeout.  Every ``ok`` answer equals ``eval_many`` at its ticket's
    epoch: phases 2, 5 and 7 at epoch 0, and at epoch 1 a fresh dense
    engine with the update applied, on which (b)'s ``/flight`` capture
    replays first; (a)'s and (c)'s replay on fresh engines of their own
    (a ring, a 4-shard dense engine), each with count parity 1.0.  Each
    run resets the launch counts just before it serves and reads them
    just after; (a) keeps its largest ``nfa_step`` launch in
    ``capture`` for the kernels line."""
    import gc
    from repro_torch import kernels, serve
    from repro_torch.core.engines import make_engine
    from repro_torch.core.rpq import RingRPQ
    from repro_torch.kernels import ops as kops
    gc.freeze()       # the earlier phases' answers live on: never walk them
    t_phase = time.perf_counter()
    stamps = Stamps()
    reqs = serve.one_endpoint_requests(graph, tried)

    def key(q):
        return (q.expr, q.subject, q.obj)

    epoch0 = {key(q): a for q, a in zip(queries, answers)}
    epoch0.update((key(q), a) for q, a in zip(skipped, hub_answers))
    if len(reqs) != tried or any(key(q) not in epoch0 for q in reqs):
        fail("phase 9's requests are not the ones phase 2 tried")
    epoch0 = [epoch0[key(q)] for q in reqs]
    hubs = {key(q) for q in skipped}
    classes = {"hub": [i for i, q in enumerate(reqs) if key(q) in hubs]}
    classes["regular"] = [i for i, q in enumerate(reqs) if key(q) not in hubs]
    adds = serve.live_adds(graph.num_nodes, graph.num_preds)
    mesh = _card_mesh((MESH_SHARDS,), ("data",))
    builds = {"ring": lambda: RingRPQ(ring, device="cuda",
                                      stats=_stats_copy(stats)),
              "dense": lambda: make_engine(graph, kind="dense",
                                           stats=_stats_copy(stats)),
              "mesh": lambda: make_engine(graph, kind="dense", mesh=mesh,
                                          stats=_stats_copy(stats))}
    out = {"phase": "serving_front", "requests": len(reqs),
           "hub_requests": len(classes["hub"]), "slots": SERVE_SLOTS,
           "concurrency": SERVE_SLOTS, "live_adds": len(adds),
           "overrun_bound_s": serve.OVERRUN_BOUND_S}

    def serve_run(name, deadline_s, idx=None):
        """Serve ``reqs`` (or those at ``idx``, in workload order)."""
        idx = list(range(len(reqs))) if idx is None else idx
        engine = builds[name]()
        kernels.reset_launch_counts()
        stamps.mark(f"{name}_setup")
        run = serve.run(engine, [reqs[i] for i in idx], slots=SERVE_SLOTS,
                        concurrency=SERVE_SLOTS, deadline_s=deadline_s,
                        adds=adds)
        launches = kernels.launch_counts()
        stamps.mark(f"{name}_serve")
        run["idx"] = idx
        if run["update_epoch"] != 1:
            fail(f"{name}: the live update made epoch {run['update_epoch']}")
        members = {c: set(v) for c, v in classes.items()}
        report = serve.latency_summary(run, {
            c: [j for j, i in enumerate(idx) if i in m]
            for c, m in members.items()})
        report.update(deadline_s=deadline_s, kernel_launches=launches)
        if set(report["ok_by_epoch"]) != {"0", "1"}:
            fail(f"{name}: answers at epochs {report['ok_by_epoch']}, not "
                 f"both sides of the live update")
        bad = {t: st for t, st in report["http"].items() if st != 200}
        if bad:
            fail(f"{name}: endpoints answered {bad}")
        if name == "mesh":
            sh = engine.sharded
            if sh.slot_dispatches <= 0:
                fail("the mesh's slots did not step on the mesh")
            report["mesh"] = {"shards": sh.num_shards,
                              "slot_dispatches": sh.slot_dispatches,
                              "gather_bytes": sh.gather_bytes}
        out[name] = report
        return run

    def replay(name, run, engine):
        stamps.mark(f"{name}_setup")
        engine.add_edges(adds)
        out[name]["flight"] = serve.replay(run["scraped"]["/flight"][1],
                                           engine)
        stamps.mark(f"{name}_replay")
        if out[name]["flight"]["parity"] != 1.0:
            fail(f"{name}: /flight replay parity "
                 f"{out[name]['flight']['parity']}")

    def check(name, run):
        """Hold the run's ok answers to eval_many at their epochs; epoch
        1 from ``yardstick`` (its answers to (b)'s replay are cached)."""
        sel = [reqs[i] for i in run["idx"]]
        idx = sorted({o.index for o in run["outcomes"]
                      if o.ok and o.epoch == 1})
        t0 = time.perf_counter()
        want = {0: [epoch0[i] for i in run["idx"]],
                1: dict(zip(idx, yardstick.eval_many([sel[j] for j in idx])))}
        try:
            checked = serve.check_answers(run["outcomes"], sel, want)
        except AssertionError as e:
            fail(f"{name}: {e}")
        out[name].update(answers_equal_eval_many=checked,
                         epoch_1_eval_many_s=time.perf_counter() - t0)
        stamps.mark(f"{name}_check")

    # (a) the ring, its largest nfa_step launch kept for the kernels line
    original = kops.nfa_step

    def recording(X, bwd):
        if X.shape[0] > capture.get("serve_N", -1):
            capture.update(serve_N=X.shape[0], serve_X=X, serve_bwd=bwd)
        return original(X, bwd)

    kops.nfa_step = recording
    try:
        ring_run = serve_run("ring", RING_SERVE_DEADLINE_S)
    finally:
        kops.nfa_step = original
    ring_report = out["ring"]
    ring_report["largest_nfa_step_tasks"] = capture.get("serve_N")
    emit({"phase": "serving_front_ring", **ring_report})   # before its gates
    if not ring_report["kernel_launches"]["nfa_step"]:
        fail("the ring's serving front launched no nfa_step")
    over = ring_report["max_overrun_s"]
    if over is not None and over > serve.OVERRUN_BOUND_S:
        fail(f"a ring request settled {over:.3f} s past its deadline, "
             f"more than {serve.OVERRUN_BOUND_S} s")
    replay("ring", ring_run, builds["ring"]())

    # (b) the dense engine: its capture replays on the epoch-1 yardstick;
    # (b) and (c) serve the regular requests and the first SERVE_HUBS hub
    # closures
    cut = sorted(classes["regular"] + classes["hub"][:SERVE_HUBS])
    cut_note = (f"{len(classes['regular'])} regular requests and the "
                f"first {SERVE_HUBS} of {len(classes['hub'])} hub closures")
    run = serve_run("dense", BATCH_DEADLINE_S, cut)
    out["dense"]["cut"] = cut_note
    yardstick = builds["dense"]()
    replay("dense", run, yardstick)
    check("dense", run)
    check("ring", ring_run)
    del run, ring_run

    # (c) the dense engine on the mesh
    run = serve_run("mesh", BATCH_DEADLINE_S, cut)
    out["mesh"]["cut"] = cut_note
    check("mesh", run)
    replay("mesh", run, builds["mesh"]())
    del run, yardstick
    for name in ("dense", "mesh"):
        check_packed_launches(out[name]["kernel_launches"],
                              f"the {name} serving front")
        if out[name]["timeouts"]:
            fail(f"{out[name]['timeouts']} requests timed out on the "
                 f"{name} serving front at {BATCH_DEADLINE_S} s")
    out["seconds"] = time.perf_counter() - t_phase
    out["substep_s"] = stamps.seconds
    return out


# -- phase 10 ----------------------------------------------------------------
LM_ARCH = "smollm-135m"
LM_DEVICE = "cuda"
LM_TRAIN = {"seq": 2048, "batch": 8, "steps": 20}
LM_STEADY = slice(4, 20)          # steps 5-20, 1-indexed: the median's
# (b): 40 steps, cut from the launcher's 300 (to 100 in PR 20, to 40 in
# PR 23 for phase 12 (c)) to keep the script inside its time limit; the
# learned gate is printed, not gated
LM_PATH_STEPS = 40
# (c): smollm-135m at its published widths, depth cut to 2 layers (every
# save of the full 30-layer state is 1.6 GB through zlib); 4 steps,
# save_every 2, one run failing at step 2: two saves, one each side of
# the failure
RESUME = {"layers": 2, "steps": 4, "save_every": 2, "fail_at": 2,
          "seq": 512, "batch": 8}
LM_SERVE = {"batch": 4, "prompt_len": 2048, "gen": 32}
# dense bf16 tensor-core peak of one H100 SXM at 700 W (NVIDIA's data sheet)
BF16_PEAK_FLOPS = 989e12
FLOPS_FORMULA = ("6*N*tokens + 12*L*H*Dh*T*tokens (N = param_count(), "
                 "remat recompute not counted)")


def _quiet(_msg: str) -> None:
    pass


def lm_flops(cfg, batch: int, seq: int) -> float:
    tokens = batch * seq
    return (6 * cfg.param_count() * tokens + 12 * cfg.num_layers *
            cfg.num_heads * cfg.head_dim * seq * tokens)


def _rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def attention_times(cfg, batch: int, seq: int) -> dict:
    """One layer's blockwise attention at the training shape, CUDA events:
    the forward, and forward + backward through the custom Function; the
    f32 score tensor of one chunk, and (timed only, used nowhere in the
    port) ``scaled_dot_product_attention`` on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.layers import _flash_fwd, flash_attention
    H, K, Dh = cfg.eff_num_heads, cfg.eff_num_kv_heads, cfg.head_dim
    chunk = min(cfg.attn_chunk, seq)
    g = torch.Generator(device=LM_DEVICE).manual_seed(0)
    q = torch.randn((batch, seq, H, Dh), generator=g, device=LM_DEVICE,
                    dtype=torch.bfloat16).requires_grad_()
    k = torch.randn((batch, seq, K, Dh), generator=g, device=LM_DEVICE,
                    dtype=torch.bfloat16).requires_grad_()
    v = torch.randn_like(k).requires_grad_()
    dout = torch.randn_like(q)

    def fwd():
        with torch.no_grad():
            _flash_fwd(q, k, v, True, chunk, 0, 0, None)

    def fwd_bwd():
        out = flash_attention(q, k, v, causal=True, chunk=chunk)
        torch.autograd.grad(out, (q, k, v), dout)

    qh = q.detach().transpose(1, 2)
    kh, vh = (t.detach().repeat_interleave(H // K, dim=2).transpose(1, 2)
              for t in (k, v))

    def sdpa():
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    return {"shape": [batch, seq, H, K, Dh], "chunk": chunk,
            "scores_f32_bytes_a_chunk": batch * H * seq * chunk * 4,
            "fwd_ms": time_ms(fwd, runs=5), "fwd_bwd_ms": time_ms(fwd_bwd,
                                                                 runs=5),
            "sdpa_fwd_ms": time_ms(sdpa, runs=5)}


ATTENTION_SCOPES = ("attention_fwd", "attention_bwd")


@contextlib.contextmanager
def attention_scopes():
    """Wrap the port's blockwise attention forward and backward
    (``layers._flash_fwd``, ``layers._flash_bwd``) in profiler scopes
    while a step is profiled, so its kernels can be told apart."""
    from torch.profiler import record_function
    from repro_torch.models import layers
    saved = layers._flash_fwd, layers._flash_bwd

    def scoped(name, fn):
        def run(*args):
            with record_function(name):
                return fn(*args)
        return run

    layers._flash_fwd = scoped(ATTENTION_SCOPES[0], saved[0])
    layers._flash_bwd = scoped(ATTENTION_SCOPES[1], saved[1])
    try:
        yield
    finally:
        layers._flash_fwd, layers._flash_bwd = saved


def profile_step(step_fn, state, batch, top: int = 10) -> dict:
    """One train step under ``torch.profiler``: the card's kernel time
    against the step's wall time, the share of it in the attention's
    scopes (forward, its recompute under remat, and backward), and the
    heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with attention_scopes(), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        _, metrics = step_fn(state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    # the scopes' own device-side annotations are spans, not kernels
    device = [e for e in prof.key_averages()
              if e.device_type == cuda and e.key not in ATTENTION_SCOPES]
    busy_us = sum(e.self_device_time_total for e in device)
    attn_us = {name: 0.0 for name in ATTENTION_SCOPES}
    for e in prof.events():
        if e.device_type != cuda and e.name in attn_us:
            attn_us[e.name] += e.device_time_total
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"profiled_step_s": wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "attention_device_ms": {k: v / 1e3 for k, v in attn_us.items()},
            "attention_share_of_busy": sum(attn_us.values()) / busy_us
            if busy_us else None,
            "top_kernels_count_ms": [[e.key[:70], e.count,
                                      e.self_device_time_total / 1e3]
                                     for e in device[:top]]}


def lm_train(smi: str):
    """(a) ``launch.train`` at the published config on ``SyntheticLM``."""
    import torch
    from repro_torch.launch import train as ltrain
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg, rep = ltrain.run(
        ["--arch", LM_ARCH, "--seq", str(LM_TRAIN["seq"]), "--batch",
         str(LM_TRAIN["batch"]), "--steps", str(LM_TRAIN["steps"]),
         "--device", LM_DEVICE],
        log_fn=_quiet)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = rep.losses
    if len(losses) != LM_TRAIN["steps"] or not all(
            x == x and abs(x) != float("inf") for x in losses):
        fail(f"(a) losses are not all finite: {losses}")
    first5 = statistics.fmean(losses[:5])
    last5 = statistics.fmean(losses[-5:])
    step_s = statistics.median(rep.step_seconds[LM_STEADY])
    tokens = LM_TRAIN["batch"] * LM_TRAIN["seq"]
    flops = lm_flops(cfg, LM_TRAIN["batch"], LM_TRAIN["seq"])
    # one more step, profiled, from the trained state
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, LM_TRAIN["seq"], LM_TRAIN["batch"])
    batch = {k: torch.from_numpy(v).to(LM_DEVICE)
             for k, v in data.batch(LM_TRAIN["steps"]).items()}
    step_fn = make_train_step(cfg, optim.AdamWConfig(
        lr=3e-4, warmup_steps=1, total_steps=LM_TRAIN["steps"]))
    line = {"phase": "lm_train", "device": smi, "arch": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": cfg.param_count(), **LM_TRAIN, "seconds": seconds,
            "losses": losses, "first5": first5, "last5": last5,
            "median_step_s": step_s, "step_s": rep.step_seconds,
            "tokens_per_s": tokens / step_s,
            "model_tflops_per_s": flops / step_s / 1e12,
            "flops_per_step": flops, "flops_formula": FLOPS_FORMULA,
            "peak_tflops_per_s": BF16_PEAK_FLOPS / 1e12,
            "mfu": flops / step_s / BF16_PEAK_FLOPS,
            "peak_memory_bytes": peak, "memory_before_bytes": base,
            "data_s": rep.data_seconds,
            "attention": attention_times(cfg, LM_TRAIN["batch"],
                                         LM_TRAIN["seq"]),
            "profile": profile_step(step_fn, rep.state, batch)}
    if not last5 < first5:
        fail(f"(a) the loss did not fall: first5 {first5}, last5 {last5}")
    return line, rep.state


def lm_path():
    """(b) ``launch.path_lm --full --steps 40`` (``LM_PATH_STEPS``)."""
    from repro_torch.launch import path_lm as lpath
    t0 = time.perf_counter()
    report, cfg, _ = lpath.run(["--full", "--steps", str(LM_PATH_STEPS),
                                "--ckpt", "", "--device", LM_DEVICE],
                               log_fn=_quiet)
    line = {"phase": "lm_path", **report,
            "cut": f"steps 300 -> {LM_PATH_STEPS} (the script's time limit)",
            "seconds": time.perf_counter() - t0,
            "learned_gate": "printed, not gated: last5 < log(vocab) - 1"}
    if not report["last5"] < report["first5"]:
        fail(f"(b) the path LM's loss did not fall: {report}")
    return line


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def lm_resume():
    """(c) fail at step 2 and resume against an uninterrupted run, both
    under deterministic algorithms."""
    import tempfile
    from dataclasses import replace
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import loop, optim
    from repro_torch.train.step import init_state, make_train_step
    cfg = replace(get_config(LM_ARCH), num_layers=RESUME["layers"])
    data = SyntheticLM(cfg.vocab_size, RESUME["seq"], RESUME["batch"])
    ocfg = optim.AdamWConfig(lr=3e-4, warmup_steps=1,
                             total_steps=RESUME["steps"])
    kw = dict(num_steps=RESUME["steps"], opt_cfg=ocfg,
              save_every=RESUME["save_every"], log_fn=_quiet,
              device=LM_DEVICE)
    out = {"phase": "lm_resume", "arch": LM_ARCH,
           "cut": f"num_layers 30 -> {RESUME['layers']} (widths as "
                  f"published); {RESUME['steps']} steps, failing at "
                  f"{RESUME['fail_at']} (the script's time limit)", **RESUME}
    with tempfile.TemporaryDirectory() as d:
        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            try:
                loop.train(cfg, data, ckpt_dir=os.path.join(d, "a"),
                           fail_at_step=RESUME["fail_at"], **kw)
                fail("(c) the simulated preemption did not happen")
            except RuntimeError as e:
                if "simulated preemption" not in str(e):
                    raise
            resumed = loop.train(cfg, data, ckpt_dir=os.path.join(d, "a"),
                                 **kw)
            # compared in memory: the uninterrupted run saves nothing
            straight = loop.train(cfg, data, ckpt_dir=None, **kw)
            out["runs_s"] = time.perf_counter() - t0
            out["deterministic_step_s"] = statistics.median(
                straight.step_seconds)
        finally:
            torch.use_deterministic_algorithms(False)
        if resumed.resumed_from != RESUME["fail_at"]:
            fail(f"(c) resumed from {resumed.resumed_from}")
        a = ckpt._flatten(loop.train_state_tree(resumed.state))
        b = ckpt._flatten(loop.train_state_tree(straight.state))
        worst = 0.0
        for (ka, x), (kb, y) in zip(a, b):
            if ka != kb:
                fail(f"(c) state keys differ: {ka} != {kb}")
            x, y = x.double(), y.double()
            if not torch.allclose(x, y, rtol=1e-5, atol=1e-6):
                fail(f"(c) resumed state differs from the uninterrupted "
                     f"run's at {ka}")
            worst = max(worst, float((x - y).abs().max()))
        out["max_abs_diff"] = worst
        out["equal_bitwise"] = all(torch.equal(x, y) for (_, x), (_, y)
                                   in zip(a, b))
        # the same steps without deterministic algorithms, for their cost
        state = init_state(cfg, 0, LM_DEVICE)
        step_fn = make_train_step(cfg, ocfg)
        times = []
        for s in range(RESUME["steps"]):
            batch = {k: torch.from_numpy(v).to(LM_DEVICE)
                     for k, v in data.batch(s).items()}
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        out["default_step_s"] = statistics.median(times)
    return out


def lm_full_checkpoint(full_state) -> dict:
    """(c), its second part: the full 30-layer state of (a) saved and
    restored once each, exact.  It runs on a thread beside (b), (c)'s
    resume runs, (d), (e) and phases 11-12, whose eager steps hold one
    core: zlib deflates and inflates on another with the GIL released.
    The state stays on the card until the restore has been checked."""
    import tempfile
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.train import loop
    out = {"full_beside": "(b) lm_path, (c)'s runs, (d) lm_serve, (e) "
           "lm_card_vs_cpu and phases 11-12, on a thread"}
    full = ckpt._flatten(loop.train_state_tree(full_state))
    before = [t.clone() for _, t in full]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "full")
        t0 = time.perf_counter()
        loop.save_train_state(path, LM_TRAIN["steps"], full_state,
                              extra={"data": {"step": LM_TRAIN["steps"]}})
        out["full_save_s"] = time.perf_counter() - t0
        out["full_bytes_on_disk"] = _dir_bytes(path)
        out["full_state_bytes"] = sum(t.numel() * t.element_size()
                                      for t in before)
        with torch.no_grad():
            for p in full_state["params"].parameters():
                p.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = loop.restore_train_state(path, full_state)
        torch.cuda.synchronize()
        out["full_restore_s"] = time.perf_counter() - t0
    after = ckpt._flatten(loop.train_state_tree(full_state))
    if extra["data"]["step"] != LM_TRAIN["steps"] or not all(
            torch.equal(x, y) for x, (_, y) in zip(before, after)):
        fail("(c) the full state did not restore bit for bit")
    out["full_restore_exact"] = True
    return out


def decode_consistency(model, cfg, prompt: dict, seed: int = 1) -> dict:
    """The reference's ``test_arch_decode_consistency`` at any size:
    prefill(T) + decode(1) against prefill(T+1)'s last logits, one
    random next token; ``prompt`` is ``launch.serve.prompt_batch``'s
    (a vlm's patches and an encdec's frames stay as they are)."""
    import numpy as np
    import torch
    from repro_torch.models import api
    toks = prompt["tokens"]
    nxt = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (toks.shape[0], 1))).to(toks.device)
    ml = toks.shape[1] + cfg.num_prefix_embeds + 5
    full, _ = api.prefill_fn(model, {**prompt, "tokens": torch.cat(
        [toks, nxt], 1)}, cfg, max_len=ml)
    _, cache = api.prefill_fn(model, prompt, cfg, max_len=ml)
    dec, _ = api.decode_fn(model, cache, nxt, cfg)
    full, dec = full.float(), dec.float()
    return {"max_abs_err": float((dec - full).abs().max()),
            "bound": 0.1 * float(full.abs().max()) + 0.06,
            "formula": "0.1 * max|ref| + 0.06",
            "shape": [int(toks.shape[0]), int(toks.shape[1])]}


def lm_serve():
    """(d) ``launch.serve``, and decode consistency at full width."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lserve
    t0 = time.perf_counter()
    report, model, prompt = lserve.run(
        ["--arch", LM_ARCH, "--batch", str(LM_SERVE["batch"]),
         "--prompt-len", str(LM_SERVE["prompt_len"]), "--gen",
         str(LM_SERVE["gen"]), "--device", LM_DEVICE])
    seconds = time.perf_counter() - t0
    if not report["finite"]:
        fail("(d) the decoded logits are not finite")
    gate = decode_consistency(model, get_config(LM_ARCH), prompt)
    line = {"phase": "lm_serve", **report, "seconds": seconds,
            "decode_consistency": gate}
    if not gate["max_abs_err"] < gate["bound"]:
        fail(f"(d) decode differs from prefill: {gate}")
    return line


def lm_card_vs_cpu():
    """(e) the tiny config's loss and gradients on the card against the
    CPU, from the same converted params."""
    from dataclasses import replace
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import api
    cfg = replace(smoke_variant(get_config(LM_ARCH)), num_layers=2,
                  d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                  d_ff=64, vocab_size=64)
    host = api.init_params(cfg, 0, "cpu")
    tree = convert.lm_params_to_reference(host)
    card = api.init_params(cfg, 1, LM_DEVICE)
    card.load_state_dict(convert.lm_params_from_reference(tree))
    data = SyntheticLM(cfg.vocab_size, 32, 4).batch(0)
    out = {"phase": "lm_card_vs_cpu", "config": "tiny (tests' _tiny_cfg)"}
    losses, grads = [], []
    for model, dev in ((host, "cpu"), (card, LM_DEVICE)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        loss, _ = api.loss_fn(model, batch, cfg)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
        losses.append(float(loss.detach()))
    out["loss_cpu"], out["loss_cuda"] = losses
    out["grad_rel_l2_max"] = max(_rel_l2(b, a) for a, b in zip(*grads))
    if abs(losses[0] - losses[1]) >= 1e-2 or out["grad_rel_l2_max"] > 5e-2:
        fail(f"(e) the card's loss or gradients differ from the CPU's: {out}")
    return out


def phase_lm(smi: str):
    """Phase 10: the LM on the card, (a)-(e), one line each; the RPQ
    kernels' counts set to 0 before and read after: the LM launches none
    of them.  Returns the future of (c)'s full-state checkpoint, which
    goes on beside phases 11-12 (:func:`join_full_checkpoint`)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    print(smi, flush=True)
    reset_launch_counts()
    line, state = lm_train(smi)
    emit(line)
    # (c)'s full-state checkpoint, host-bound on one core, beside (b),
    # (c)'s resume runs, (d), (e) and phases 11-12
    pool = ThreadPoolExecutor(1)
    full = pool.submit(lm_full_checkpoint, state)
    pool.shutdown(wait=False)
    del state
    emit(lm_path())
    emit(lm_resume())
    emit(lm_serve())
    emit(lm_card_vs_cpu())
    torch.cuda.empty_cache()
    launches = launch_counts()
    emit({"phase": "lm", "kernel_launches": launches,
          "full_checkpoint_done": full.done(),
          "seconds": time.perf_counter() - t_phase})
    if any(launches.values()):
        fail(f"the LM launched an RPQ kernel: {launches}")
    return full


def join_full_checkpoint(full) -> None:
    """Phase 10 (c)'s full-state line, after phases 11-12: its save and
    restore seconds, and ``wait_s``, how long the script waited for the
    thread there."""
    t0 = time.perf_counter()
    emit({"phase": "lm_full_checkpoint", **full.result(),
          "wait_s": time.perf_counter() - t0})


# -- phase 11 ----------------------------------------------------------------
# the LM substrate's other families at their published sizes: (part,
# config); each config's source is in its file under configs/
FAMILY_ARCHS = (("moe", "olmoe-1b-7b"), ("vlm", "paligemma-3b"),
                ("ssm", "mamba2-2.7b"), ("hybrid", "zamba2-7b"),
                ("encdec", "seamless-m4t-medium"))
# serve: B = 2, prompts of 1,024 positions (a vlm's 256 patches + 768
# tokens; an encdec's 256 frames and 1,024 target tokens), 32 greedy tokens
FAMILY_SERVE = {"batch": 2, "positions": 1024, "gen": 32, "frames": 256}
# olmoe's decode-consistency gate at B*T <= C = int(2048*8/64*1.25) = 320:
# its one padded group can then drop no real (token, slot) pair
MOE_GATE = {"batch": 1, "prompt_len": 256}
# train: published widths, depth cut (olmoe's whole state, 6.92 B x 16
# bytes, would not fit in 80 GB); the hybrid keeps one group of 6 and one
# tail layer, so the shared block and the tail both run
# (10 steps: cut from 20 in PR 23 for phase 12 (c))
FAMILY_TRAIN = {"batch": 4, "seq": 512, "steps": 10}
FAMILY_CUTS = {"moe": {"num_layers": 2}, "vlm": {"num_layers": 2},
               "ssm": {"num_layers": 2}, "hybrid": {"num_layers": 7},
               "encdec": {"num_layers": 2, "enc_layers": 2}}
FAMILY_STEADY = slice(4, 10)       # steps 5-10, the median's
# card against CPU: each family's smoke variant, and qwen2-moe's too
# (shared experts)
CARD_VS_CPU_EXTRA = "qwen2-moe-a2.7b"


def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def family_batch(cfg, B: int, T: int, step: int, device) -> dict:
    """A training batch of ``T`` positions, shaped as the reference's
    ``_smoke_batch`` (``tests/test_models.py``): tokens and labels from
    ``SyntheticLM`` (learnable, seeded by ``step``); a vlm's first
    ``num_prefix_embeds`` positions random patch embeddings, their labels
    masked out; an encdec's ``T`` random frames."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    rng = np.random.default_rng(np.random.SeedSequence([7, step]))
    Np = cfg.num_prefix_embeds if cfg.family == "vlm" else 0
    syn = SyntheticLM(cfg.vocab_size, T - Np, B).batch(step)
    out = {k: torch.from_numpy(v).long() for k, v in syn.items()}

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape)).to(torch.bfloat16)

    if cfg.family == "vlm":
        out["patch_embeds"] = normal(B, Np, cfg.d_model)
        out["labels"] = torch.cat([torch.zeros((B, Np), dtype=torch.long),
                                   out["labels"]], 1)
        out["mask"] = torch.cat([torch.zeros((B, Np), dtype=torch.long),
                                 torch.ones((B, T - Np), dtype=torch.long)], 1)
    if cfg.family == "encdec":
        out["frames"] = normal(B, T, cfg.d_model)
    return {k: v.to(device) for k, v in out.items()}


@contextlib.contextmanager
def moe_drop_counter(counts: dict):
    """Count, over every MoE layer call while it is open, the (token,
    slot) pairs its block dropped (past their expert's capacity) and all
    of them, from the blocks' own log (``layers.routing_log``: a decoded
    token's pairs are all kept); a ``counts["kept"]`` list gets each
    call's [B, T, k] mask of the pairs kept."""
    from repro_torch.models import layers
    with layers.routing_log() as log:
        yield counts
    for r in log:
        counts["dropped"] += int((~r["kept"]).sum())
        counts["pairs"] += r["kept"].numel()
        if "kept" in counts:
            counts["kept"].append(r["kept"])


def routing_agreement(a: list, b: list, last: bool = False) -> float:
    """The share of (layer, token) pairs that two routing logs of the same
    layers send to the same experts (``last``: only ``b``'s tokens, the
    last positions of ``a``'s)."""
    same = n = 0
    for x, y in zip(a, b):
        x, y = x["top_e"], y["top_e"]
        if last:
            x = x[:, -y.shape[1]:]
        eq = (x.sort(dim=-1).values == y.sort(dim=-1).values).all(dim=-1)
        same, n = same + int(eq.sum()), n + eq.numel()
    return same / max(n, 1)


def family_serve(part: str, arch: str) -> dict:
    """``launch.serve`` at the published size; decode consistency (for
    the moe at ``MOE_GATE``, where its capacity drops nothing, and the
    pairs the served prompt's prefill dropped)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve as lserve
    from repro_torch.models import api
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    prompt_len = FAMILY_SERVE["positions"] - (
        cfg.num_prefix_embeds if part == "vlm" else 0)
    t0 = time.perf_counter()
    report, model, prompt = lserve.run(
        ["--arch", arch, "--batch", str(FAMILY_SERVE["batch"]),
         "--prompt-len", str(prompt_len), "--gen", str(FAMILY_SERVE["gen"]),
         "--frames", str(FAMILY_SERVE["frames"]), "--device", LM_DEVICE])
    serve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nparams = sum(t.numel() for t in model.parameters())
    line = {"phase": "lm_family_serve", "part": part, "arch": arch,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": nparams, "init_s": report["init_s"],
            "prefill_s_cold": report["prefill_s"][0],
            "prefill_s_warm": report["prefill_s"][1],
            "decode_ms_per_token": report["decode_ms_per_token"],
            "decode_tokens_per_s": report["decode_tokens_per_s"],
            "peak_gb": peak / 1e9, "serve_s": serve_s,
            "prompt": {k: list(v.shape) for k, v in prompt.items()},
            "gen": FAMILY_SERVE["gen"], "finite": report["finite"]}
    if not report["finite"]:
        fail(f"({part}) {arch}'s decoded logits are not finite")
    if part == "moe":
        counts = {"dropped": 0, "pairs": 0}
        with moe_drop_counter(counts):
            api.prefill_fn(model, prompt, cfg, max_len=FAMILY_SERVE[
                "positions"] + 1)
        line["served_prefill_drops"] = counts
        prompt = lserve.prompt_batch(cfg, MOE_GATE["batch"],
                                     MOE_GATE["prompt_len"], 0,
                                     np.random.default_rng(2), LM_DEVICE)
        with moe_drop_counter({"dropped": 0, "pairs": 0}) as gate_counts:
            gate = decode_consistency(model, cfg, prompt)
        if gate_counts["dropped"]:
            fail(f"(moe) the gate's prefill dropped {gate_counts}")
        gate["prefill_drops"] = gate_counts
    else:
        gate = decode_consistency(model, cfg, prompt)
    line["decode_consistency"] = gate
    line["kernel_launches"] = launch_counts()
    line["peak_gb_with_gate"] = torch.cuda.max_memory_allocated() / 1e9
    if not gate["max_abs_err"] < gate["bound"]:
        fail(f"({part}) {arch}: decode differs from prefill: {gate}")
    del model, prompt
    _free()
    return line


def family_train(part: str, arch: str) -> dict:
    """``FAMILY_TRAIN``'s steps through ``make_train_step`` at the
    published widths, the depth cut by ``FAMILY_CUTS``, remat on."""
    import math
    from dataclasses import replace
    import torch
    from repro_torch.configs import get_config
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step
    full = get_config(arch)
    cfg = replace(full, **FAMILY_CUTS[part])
    B, T, n = FAMILY_TRAIN["batch"], FAMILY_TRAIN["seq"], FAMILY_TRAIN["steps"]
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, 0, LM_DEVICE)
    step_fn = make_train_step(cfg, optim.AdamWConfig(
        lr=3e-4, warmup_steps=1, total_steps=n))
    losses, gnorms, aux, times = [], [], [], []
    for s in range(n):
        batch = family_batch(cfg, B, T, s, LM_DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
        if "moe_aux" in m:
            aux.append(float(m["moe_aux"]))
    step_s = statistics.median(times[FAMILY_STEADY])
    first5, last5 = statistics.fmean(losses[:5]), statistics.fmean(losses[-5:])
    cut = ", ".join(f"{k} {getattr(full, k)} -> {v}"
                    for k, v in FAMILY_CUTS[part].items())
    line = {"phase": "lm_family_train", "part": part, "arch": arch,
            "cut": f"{cut} (widths as published)", **FAMILY_TRAIN,
            "params": sum(t.numel() for t in state["params"].parameters()),
            "losses": losses, "grad_norms": gnorms, "first5": first5,
            "last5": last5, "median_step_s": step_s, "step_s": times,
            "tokens_per_s": B * T / step_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if aux:
        line["moe_aux"] = aux
    del state, step_fn
    _free()
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"({part}) {arch}: a loss or gradient norm is not finite")
    if not last5 < first5:
        fail(f"({part}) {arch}: the loss did not fall: {first5} -> {last5}")
    return line


def family_card_vs_cpu(arch: str) -> dict:
    """The smoke variant's loss and gradients on the card against the CPU
    from the same weights and batch: the whole gradient's relative L2
    error, and each leaf's, at most (PR 18's (e) bound).  A small leaf
    whose gradient sums terms that cancel (a mamba layer's ``A_log``,
    ``conv_C``) moves by about 1% when a few bf16 products round the other
    way, which the card's and the CPU's matmuls do."""
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import api
    cfg = smoke_variant(get_config(arch))
    host = api.init_params(cfg, 0, "cpu")
    card = api.init_params(cfg, 1, LM_DEVICE)
    card.load_state_dict(host.state_dict())
    data = family_batch(cfg, 2, 32, 0, "cpu")
    losses, grads = [], []
    for model, dev in ((host, "cpu"), (card, LM_DEVICE)):
        batch = {k: v.to(dev) for k, v in data.items()}
        loss, _ = api.loss_fn(model, batch, cfg)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
        losses.append(float(loss.detach()))
    host_g, card_g = (torch.cat([g.flatten().cpu() for g in gs])
                      for gs in grads)
    out = {"arch": cfg.name, "loss_cpu": losses[0], "loss_cuda": losses[1],
           "grad_rel_l2": _rel_l2(card_g, host_g),
           "grad_rel_l2_max_leaf": max(_rel_l2(b, a)
                                       for a, b in zip(*grads))}
    if (abs(losses[0] - losses[1]) >= 1e-3 or out["grad_rel_l2"] > 1e-2
            or out["grad_rel_l2_max_leaf"] > 5e-2):
        fail(f"{cfg.name}: the card's loss or gradients differ from the "
             f"CPU's: {out}")
    return out


def phase_families(smi: str) -> None:
    """Phase 11: each family served at its published size, trained at its
    published widths (depth cut), and its smoke variant on the card
    against the CPU; one line each.  The RPQ kernels' counts are set to 0
    before and read after: the LM launches none of them."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    print(smi, flush=True)
    reset_launch_counts()
    for part, arch in FAMILY_ARCHS + (("moe", CARD_VS_CPU_EXTRA),):
        if arch != CARD_VS_CPU_EXTRA:
            emit({**family_serve(part, arch), "device": smi})
            emit({**family_train(part, arch), "device": smi})
        emit({"phase": "lm_family_card_vs_cpu", "part": part,
              **family_card_vs_cpu(arch),
              "gates": "loss within 1e-3; the gradient within 1e-2 "
                       "relative L2, every leaf within 5e-2"})
    launches = launch_counts()
    emit({"phase": "lm_families", "kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    if any(launches.values()):
        fail(f"the LM families launched an RPQ kernel: {launches}")


# -- phase 12 ----------------------------------------------------------------
# the LM on a (data 2, model 2) mesh of 4 x the card: the dense family in
# (a) and (b), the other five in (c)
MESH_SHAPE = {"shards": 4, "model": 2}
MESH_TRAIN = {"arch": "smollm-135m", "batch": 8, "seq": 1024, "steps": 10}
# (a)'s save, restore and resume on a depth-cut copy (PR 23, for phase 12
# (c)): the state's zlib save and its restore were 41.8 s and 17.3 s at
# 30 layers (PR 22's run 11)
MESH_RESUME = {"layers": 2, "steps": 6, "save_at": 3}
MESH_SERVE = {"arch": "smollm-135m", "batch": 4, "prompt_len": 1024,
              "gen": 16, "small_batch": 1, "small_gen": 4}
MESH_WIDE_SERVE = {"arch": "qwen3-4b", "batch": 2, "prompt_len": 1024,
                   "gen": 8}
MESH_WIDE_TRAIN = {"arch": "qwen3-4b", "layers": 2, "batch": 4, "seq": 512,
                   "steps": 5}
MESH_GATES = {"loss_step1": 2e-3, "grad_rel_l2": 1e-2, "leaf_rel_l2": 5e-2,
              "losses": 1e-2, "resume_rtol": 1e-5, "resume_atol": 1e-6}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _grads(cfg, state, batch, ctx=None):
    """Step 1's loss and gradient, name -> f32 tensor: one device's moved
    to the host, a mesh's unsharded on the card (every replica carries
    the whole)."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.models import api
    from repro_torch.train.step import mesh_grads
    params = state["params"]
    if ctx is None:
        loss, _ = api.loss_fn(params, batch, cfg)
        named = dict(params.named_parameters())
        got = dict(zip(named, torch.autograd.grad(loss,
                                                  list(named.values()))))
        got = {n: g.cpu() for n, g in got.items()}
    else:
        loss, _ = api.loss_fn(params, batch, cfg, ctx)
        got = {n: shd.unshard(g) for n, g in mesh_grads(params, loss).items()}
    return float(loss.detach()), got


def _compare_grads(g1: dict, gm: dict) -> dict:
    """Relative L2 errors of the mesh's gradient ``gm`` (on the card)
    against one device's ``g1`` (on the host), leaf by leaf on the card,
    in f64 sums."""
    import torch
    num = den = 0.0
    leaf = (0.0, None)
    for n, b in g1.items():
        a = gm[n]
        b = b.to(a.device)
        d2 = float(torch.linalg.vector_norm(a - b, dtype=torch.float64)) ** 2
        b2 = float(torch.linalg.vector_norm(b, dtype=torch.float64)) ** 2
        num, den = num + d2, den + b2
        leaf = max(leaf, ((d2 / max(b2, 1e-60)) ** 0.5, n))
    return {"grad_rel_l2": (num / max(den, 1e-60)) ** 0.5,
            "grad_rel_l2_max_leaf": leaf[0], "worst_leaf": leaf[1]}


def _resident(state) -> dict:
    """Bytes of params + moments each coordinate holds, and what the
    sanitized specs give for one coordinate (the same for all):
    ``sharding.resident_bytes``, the count the dry run's resident bytes
    are held to."""
    from repro_torch import sharding as shd
    return shd.resident_bytes(state["params"], state["opt"]["mu"],
                              state["opt"]["nu"])


def _perturbed(state, seed: int = 11) -> None:
    """Every weight of a one-device state times ``1 + 2**-8 * u``, ``u``
    uniform in [-1, 1] (drawn from ``seed``): about half its bf16 compute
    copies move by one ulp, a rounding-level change of the whole model."""
    import torch
    gen = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    with torch.no_grad():
        for t in state["params"].parameters():
            u = torch.rand(t.shape, generator=gen, device=t.device) * 2 - 1
            t.mul_(1 + 2.0 ** -8 * u)


def _one_device_run(cfg, ocfg, batch, steps: int, perturb: bool = False):
    """Step 1's loss and gradient and ``steps`` losses of one device, from
    the seed-0 state (:func:`_perturbed` first with ``perturb``), and its
    step seconds."""
    import torch
    from repro_torch.train.step import init_state, make_train_step
    one = init_state(cfg, 0, LM_DEVICE)
    if perturb:
        _perturbed(one)
    loss1, g1 = _grads(cfg, one, batch(0))
    fn = make_train_step(cfg, ocfg)
    losses, times = [], []
    for s in range(steps):
        b = batch(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one, m = fn(one, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    del one, fn
    _free()
    return loss1, g1, losses, times


def _mesh_train_compare(cfg, mesh, B: int, T: int, steps: int,
                        save_at=None, save_dir=None, profile=False,
                        batch_fn=None, warmup: int = 1,
                        baseline: bool = False):
    """The same initial state and batches on one device and on the mesh:
    step 1's loss and gradient, every step's loss, the mesh's step
    seconds and collective bytes a step, its resident bytes.  With
    ``save_at``, the mesh state after that step is saved on a thread
    (zlib holds no lock) and steps after it run under deterministic
    algorithms; returns the thread's future, the snapshot and the final
    mesh state for the resume.  With ``profile``, one more mesh step
    runs under ``torch.profiler`` (asked of the 2-layer model only: its
    trace is a tenth of a 30-layer step's, which the profiler's Python
    post-processing walks event by event).  ``batch_fn(step)``: the
    batches (``SyntheticLM``'s by default); ``warmup``: the optimizer's
    warmup steps.  With ``baseline``, one device runs again from
    :func:`_perturbed` weights, and the gradient and loss gates become
    the larger of ``MESH_GATES``' and that run's distance from the
    first, capped by ``MESH_BASELINE_CAP``: the mesh may move its step
    no further than rounding-level noise moves one device's."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import api
    from repro_torch.train import loop, optim
    from repro_torch.train.step import init_state, make_train_step
    data = SyntheticLM(cfg.vocab_size, T, B)
    ocfg = optim.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=steps)
    gates = dict(MESH_GATES)

    def batch(s):
        if batch_fn is not None:
            return batch_fn(s)
        return {k: torch.from_numpy(v).to(LM_DEVICE)
                for k, v in data.batch(s).items()}

    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": B, "seq": T,
           "steps": steps, "params": cfg.param_count(),
           "mesh": mesh.shape}
    clock = {}
    t_part = time.perf_counter()

    def lap(name):
        nonlocal t_part
        torch.cuda.synchronize()
        now = time.perf_counter()
        clock[name] = now - t_part
        t_part = now

    loss1, g1, losses1, times1 = _one_device_run(cfg, ocfg, batch, steps)
    out["one_device_median_step_s"] = statistics.median(times1[1:])
    lap("one_device")
    if baseline:
        lossp, gp, lossesp, _ = _one_device_run(cfg, ocfg, batch, steps,
                                                perturb=True)
        near = _compare_grads(g1, {n: g.to(LM_DEVICE) for n, g in
                                   gp.items()})
        near.update({"loss_step1_diff": abs(lossp - loss1),
                     "losses": lossesp, "losses_max_diff": max(
                         abs(a - b) for a, b in zip(losses1, lossesp))})
        del gp
        _free()
        out["one_device_perturbed"] = near
        for g, k in (("grad_rel_l2", "grad_rel_l2"),
                     ("leaf_rel_l2", "grad_rel_l2_max_leaf"),
                     ("losses", "losses_max_diff")):
            gates[g] = max(gates[g], min(MESH_BASELINE_CAP[g], near[k]))
        lap("one_device_perturbed")
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, 0, LM_DEVICE, mesh=mesh)
    fn = make_train_step(cfg, ocfg, mesh=mesh)
    out["replicated_dims"] = api.replicated_dims(
        cfg, fn.ctx, {n: sh.shape for n, sh in state["params"].items()})
    out["resident_bytes"] = _resident(state)
    lap("mesh_init")
    lossm, gm = _grads(cfg, state, batch(0), fn.ctx)
    out.update({"loss_step1_one_device": loss1, "loss_step1_mesh": lossm,
                "loss_step1_diff": abs(loss1 - lossm),
                **_compare_grads(g1, gm)})
    del g1, gm
    lap("mesh_grads")
    losses, times, moved = [], [], {}
    saved = snapshot = None
    for s in range(steps):
        if save_at is not None and s == save_at:
            lap("mesh_steps_before_save")
            snapshot = _to_cpu(loop.train_state_tree(state))
            lap("snapshot")
            from repro_torch import checkpoint as ckpt
            pool = ThreadPoolExecutor(1)
            saved = (pool, pool.submit(
                ckpt.save, save_dir, save_at, snapshot,
                {"data": data.state(save_at)}))
            torch.use_deterministic_algorithms(True)
        b = batch(s)
        torch.cuda.synchronize()
        shd.reset_collective_bytes()
        t0 = time.perf_counter()
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        if s == 1:
            moved = shd.collective_bytes()
    torch.use_deterministic_algorithms(False)
    lap("mesh_steps")
    if profile:
        out["profile"] = profile_step(fn, state, batch(steps))
        lap("profile")
    out["seconds_by_part"] = clock
    timed = times[1:save_at] if save_at else times[1:]
    step_s = statistics.median(timed)
    out.update({
        "losses_one_device": losses1, "losses_mesh": losses,
        "losses_max_diff": max(abs(a - b) for a, b in zip(losses1, losses)),
        "step_s": times, "median_step_s": step_s,
        "steady_steps": "2-%d, default algorithms" % (save_at or steps),
        "tokens_per_s": B * T / step_s,
        "model_tflops_per_s": lm_flops(cfg, B, T) / step_s / 1e12,
        "flops_formula": FLOPS_FORMULA,
        "collective_bytes_a_step": moved,
        "collective_bytes_note": "forward calls of step 2 (remat's "
        "recompute counted again); autograd's transposes move as much "
        "again, transposed",
        "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    res = out["resident_bytes"]
    if any(b != res["from_specs"] for b in res["per_coordinate"]):
        fail(f"{cfg.name}: resident bytes differ from the specs: {res}")
    out["gates"] = gates
    if out["loss_step1_diff"] > gates["loss_step1"] or (
            out["grad_rel_l2"] > gates["grad_rel_l2"]) or (
            out["grad_rel_l2_max_leaf"] > gates["leaf_rel_l2"]):
        fail(f"{cfg.name}: the mesh's step 1 differs from one device: {out}")
    if out["losses_max_diff"] > gates["losses"]:
        fail(f"{cfg.name}: the mesh's losses differ from one device: {out}")
    k = max(1, steps // 2)
    if not statistics.fmean(losses[-k:]) < statistics.fmean(losses[:k]):
        fail(f"{cfg.name}: the mesh's loss did not fall: {losses}")
    return out, saved, snapshot, state, (fn, batch, data)


def _mesh_serve(cfg, mesh, B: int, prompt_len: int, gen: int,
                model=None, frames: int = 0,
                consistency_len: int | None = None) -> dict:
    """Prefill ``B`` prompts (a vlm's patches before them, an encdec's
    ``frames`` for its encoder) and decode ``gen`` greedy tokens on the
    mesh (serving rules; ``small_batch`` when B is below the data axes)
    from the one-device model's weights: the mesh's last prefill logits
    against the one-device prefill's, and decode consistency on the
    mesh (prefill T + decode 1 against prefill T + 1, T the prompt's
    first ``consistency_len`` tokens, all by default).  For a moe, the
    compared side takes the other side's experts
    (``layers.routing_log(replay=)``): a near-tie that their rounding
    splits (as it can on one device between prefill and decode) would
    otherwise send a token to another expert; how often each side's own
    choice agrees is reported and gated (``MESH_MOE_AGREEMENT``), and
    the consistency's prefill must keep every pair of its last token
    (decode is dropless)."""
    import numpy as np
    import torch
    from repro_torch import sharding as shd
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import api, layers
    from repro_torch.train.step import make_prefill_step, make_serve_step
    small = B < shd.axes_size(mesh, shd.data_axes(mesh))
    torch.cuda.reset_peak_memory_stats()
    t0 = t_serve = time.perf_counter()
    if model is None:
        model = api.init_params(cfg, 0, LM_DEVICE)
    prompt = prompt_batch(cfg, B, prompt_len, frames,
                          np.random.default_rng(0), LM_DEVICE)
    ml = prompt_len + cfg.num_prefix_embeds + gen + 6
    moe = cfg.family == "moe"

    def routing(replay=None):
        return layers.routing_log(replay) if moe \
            else contextlib.nullcontext([])

    with routing() as one_log:
        ref, _ = api.prefill_fn(model, prompt, cfg, ml)
    ref = ref.float()
    pre = make_prefill_step(cfg, ml, mesh=mesh, small_batch=small)
    dec = make_serve_step(cfg, mesh=mesh, small_batch=small)
    params = api.shard_params(model, cfg, pre.ctx, dtype=torch.bfloat16)
    del model
    _free()
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
           "prompt": {k: list(v.shape) for k, v in prompt.items()},
           "prompt_len": prompt_len, "gen": gen, "small_batch": small,
           "mesh": mesh.shape, "setup_s": time.perf_counter() - t0,
           "replicated_dims": api.replicated_dims(
               cfg, pre.ctx, {n: sh.shape for n, sh in params.items()})}
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, cache = pre(params, prompt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    agree = {}
    if moe:
        with routing() as own:
            pre(params, prompt)
        agree["prefill"] = routing_agreement(one_log, own)
        with routing(one_log):
            replayed, _ = pre(params, prompt)

    def compare(got, want) -> dict:
        return {"max_abs_err": float((got - want).abs().max()),
                "bound": 0.1 * float(want.abs().max()) + 0.06,
                "formula": "0.1 * max|ref| + 0.06"}

    got = shd.unshard(logits).float()
    out.update({"prefill_s": times, "prefill_vs_one_device": compare(
        shd.unshard(replayed).float() if moe else got, ref),
        "cache_specs": {f"{g}/{n}": [list(sh.spec), list(next(iter(
            sh.parts.values())).shape)] for g, leaves in cache.items()
            if isinstance(leaves, dict) for n, sh in leaves.items()}})
    cur = torch.argmax(got, dim=-1)[:, None]
    toks = []
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = dec(params, cache, cur)
        cur = torch.argmax(shd.unshard(logits), dim=-1)[:, None]
        toks.append(cur)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out.update({"decode_ms_per_token": dt / gen * 1e3,
                "decode_tokens_per_s": B * gen / dt,
                "sample": torch.cat(toks, 1)[0].tolist()})
    # decode consistency on the mesh
    nxt = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (B, 1))).to(LM_DEVICE)
    toks = prompt["tokens"][:, :consistency_len]
    with routing() as full_log:
        full, _ = pre(params, {**prompt,
                               "tokens": torch.cat([toks, nxt], 1)})
    _, cache = pre(params, {**prompt, "tokens": toks})
    with routing(full_log):
        step, _ = dec(params, cache, nxt)
    if moe:
        # the same position again, routed by its own choice
        with routing() as own:
            dec(params, cache, nxt)
        agree["decode"] = routing_agreement(full_log, own, last=True)
        out["moe_routing"] = {
            "agreement": agree, "gate": MESH_MOE_AGREEMENT,
            "last_token_pairs_dropped_in_prefill": sum(
                int((~r["kept"][:, -1]).sum()) for r in full_log)}
    full, step = shd.unshard(full).float(), shd.unshard(step).float()
    out["decode_consistency"] = {**compare(step, full),
                                 "shape": list(toks.shape)}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del params, cache
    _free()
    out["seconds"] = time.perf_counter() - t_serve
    for k in ("prefill_vs_one_device", "decode_consistency"):
        if not out[k]["max_abs_err"] < out[k]["bound"]:
            fail(f"{cfg.name} on the mesh: {k} {out[k]}")
    if moe and (any(agree[k] < v for k, v in MESH_MOE_AGREEMENT.items())
                or out["moe_routing"]["last_token_pairs_dropped_in_prefill"]):
        fail(f"{cfg.name} on the mesh: routing {out['moe_routing']}")
    return out


# (c) the other five families on the same mesh: published widths, phase
# 11's depth cuts (FAMILY_CUTS: 2 layers; zamba2 7, so its shared block
# runs once; seamless 2 + 2); 5 steps at B = 4, T = 512 beside one device,
# then serving at B = 2: 512 positions (a vlm's 256 patches + 256 tokens;
# an encdec's 512 frames and a 512-token prompt), 8 tokens
# (the lr warmed up over the 5 steps: at published widths a full-lr first
# update overshoots, zamba2's loss rising 10.91 -> 12.47 on one device, and
# the two runs' later losses part by up to 0.4 on either path)
MESH_FAMILY_TRAIN = {"batch": 4, "seq": 512, "steps": 5, "warmup": 5}
# A mamba layer's decay exp(dt * A) moves by |dt * A| times a relative
# change of its input (the reference's init: dt_bias 0, so dt =
# softplus(x . wdt) is about 0.7, and A reaches -16), layer after layer,
# in both packages alike: at a stand-in of d_model 512 the reference's
# own mesh-vs-unsharded step-1 gradient differs by 1.9% (mamba2, 2
# layers) and 22% (zamba2, 7 layers), and the port's from the same
# weights by 2.0% and 23% (tests/lm_mesh_spread.py --same-weights).  So
# the ssm's and the hybrid's step-1 gradient is gated at MESH_GATES on
# one mamba layer (the hybrid's shared block after it), MESH_GRAD_CUTS;
# at FAMILY_CUTS' depth the gradient and loss gates are the larger of
# MESH_GATES' and the distance a rounding-level perturbation of the
# weights (_perturbed) moves one device's run in the same call, capped
# by MESH_BASELINE_CAP (a zero gradient is 1.0 away, a sign flip 2.0)
MESH_GRAD_CUTS = {"ssm": {"num_layers": 1},
                  "hybrid": {"num_layers": 1, "attn_period": 1}}
MESH_BASELINE_CAP = {"grad_rel_l2": 0.5, "leaf_rel_l2": 0.5, "losses": 0.1}
MESH_FAMILY_SERVE = {"batch": 2, "positions": 512, "frames": 512, "gen": 8}
# olmoe's decode consistency on the mesh at B*T = 2 x 128 = 256 <= C =
# int(2048*8/64*1.25) = 320, where its capacity drops nothing (decode is
# dropless; a served prefill of 2 x 512 drops pairs, its last token's
# first)
MESH_MOE_CONSISTENCY = 128
# the least share of (layer, token) pairs the mesh routes to one device's
# experts (prefill: B x T x layers = 2,048 pairs) and to its own
# prefill's (decode: B x layers = 4): a near-tie of a top-8 of 64 splits
# with the bf16 rounding now and then (about 5% of the prefill's pairs),
# a wrong router or a shard's tokens routed apart much more often
MESH_MOE_AGREEMENT = {"prefill": 0.9, "decode": 0.5}
# the moe's drop gate: layer 0's MoE block on one device and on the mesh
# from the same [4, 512, d] input, one capacity group of its 2,048 tokens
# (olmoe's own group size) that spans both data coordinates, at capacity
# factor 1 (C = 256 slots an expert) so pairs drop; the output within
# 1e-2 relative L2 (the bf16 partial sums over the experts)
MOE_DROP_GATE = {"batch": 4, "seq": 512, "capacity_factor": 1.0,
                 "output_rel_l2": 1e-2}


def moe_drop_gate(cfg, mesh) -> dict:
    """The mesh's MoE keeps and drops exactly one device's (token, slot)
    pairs: ``MOE_DROP_GATE``."""
    from dataclasses import replace
    import numpy as np
    import torch
    from repro_torch import sharding as shd
    from repro_torch.models import api, layers
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import ShardCtx
    B, T = MOE_DROP_GATE["batch"], MOE_DROP_GATE["seq"]
    cfg = replace(cfg, capacity_factor=MOE_DROP_GATE["capacity_factor"],
                  moe_group_size=B * T)
    flat = {n: t for n, t in api.init_params(cfg, 0, LM_DEVICE)
            .named_parameters() if n.startswith("layers.0.")}
    ctx = ShardCtx(mesh, shd.make_rules(mesh, cfg))
    one = tf.weights(flat, "layers.0.")
    on_mesh = tf.weights(api.shard_params(flat, cfg, ctx), "layers.0.")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)).to(LM_DEVICE) \
        .to(torch.bfloat16)
    sp = ctx.spec(x.shape, "batch", "seq_sp", None)
    got = []
    with torch.no_grad():
        for lw, xl, geo in (
                (one, {(): x}, tf.Geo(None, (), ())),
                (on_mesh, shd.shard(x, mesh, sp).parts,
                 tf.geo_of(ctx, B, T))):
            counts = {"dropped": 0, "pairs": 0, "kept": []}
            with moe_drop_counter(counts):
                y, _ = tf.moe_sublayer(lw, xl, cfg, geo, False)
            if geo.mesh is not None:
                y = {(): shd.unshard(shd.Sharded(y, x.shape, sp, mesh))}
            got.append((counts, y[()].float() - x.float()))
    (c1, h1), (cm, hm) = got
    out = {"batch": B, "seq": T, "group": cfg.moe_group_size,
           "capacity_factor": cfg.capacity_factor,
           "capacity": layers.capacity(cfg, cfg.moe_group_size),
           "pairs": c1["pairs"], "dropped_one_device": c1["dropped"],
           "dropped_mesh": cm["dropped"],
           "same_pairs_dropped": len(c1["kept"]) == len(cm["kept"]) == 1
           and bool(torch.equal(c1["kept"][0], cm["kept"][0])),
           "output_rel_l2": float((hm - h1).norm() / h1.norm()),
           "gates": MOE_DROP_GATE}
    del flat, one, on_mesh, x, got
    _free()
    if not (out["same_pairs_dropped"] and out["dropped_one_device"] > 0):
        fail(f"(moe) the mesh's drops differ from one device's: {out}")
    if out["output_rel_l2"] > MOE_DROP_GATE["output_rel_l2"]:
        fail(f"(moe) the mesh's MoE output differs from one device's: {out}")
    return out


def mesh_grad_gate(cfg, mesh, B: int, T: int) -> dict:
    """Step 1's loss and gradient of ``cfg`` on one device and on the
    mesh from the same seed-0 state and batch, held to ``MESH_GATES``."""
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step
    t0 = time.perf_counter()
    b0 = family_batch(cfg, B, T, 0, LM_DEVICE)
    one = init_state(cfg, 0, LM_DEVICE)
    loss1, g1 = _grads(cfg, one, b0)
    del one
    _free()
    state = init_state(cfg, 0, LM_DEVICE, mesh=mesh)
    ctx = make_train_step(cfg, optim.AdamWConfig(), mesh=mesh).ctx
    lossm, gm = _grads(cfg, state, b0, ctx)
    out = {"layers": cfg.num_layers, "attn_period": cfg.attn_period,
           "batch": B, "seq": T, "loss_step1_one_device": loss1,
           "loss_step1_diff": abs(loss1 - lossm), **_compare_grads(g1, gm),
           "gates": {k: MESH_GATES[k] for k in
                     ("loss_step1", "grad_rel_l2", "leaf_rel_l2")}}
    del state, g1, gm
    _free()
    out["seconds"] = time.perf_counter() - t0
    if out["loss_step1_diff"] > MESH_GATES["loss_step1"] or (
            out["grad_rel_l2"] > MESH_GATES["grad_rel_l2"]) or (
            out["grad_rel_l2_max_leaf"] > MESH_GATES["leaf_rel_l2"]):
        fail(f"{cfg.name}: the mesh's step 1 differs from one device at "
             f"one mamba layer: {out}")
    return out


def mesh_family(part: str, arch: str, mesh, smi: str) -> dict:
    """Phase 12 (c) for one family: ``MESH_FAMILY_TRAIN`` beside one
    device, the ssm's and hybrid's gradient at ``MESH_GRAD_CUTS``,
    ``MESH_FAMILY_SERVE`` (and the moe's drop gate), one line."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    full = get_config(arch)
    cfg = replace(full, **FAMILY_CUTS[part])
    B, T = MESH_FAMILY_TRAIN["batch"], MESH_FAMILY_TRAIN["seq"]
    t0 = time.perf_counter()
    train, _, _, state, _ = _mesh_train_compare(
        cfg, mesh, B, T, MESH_FAMILY_TRAIN["steps"],
        batch_fn=lambda s: family_batch(cfg, B, T, s, LM_DEVICE),
        warmup=MESH_FAMILY_TRAIN["warmup"],
        baseline=part in ("ssm", "hybrid"))
    del state
    _free()
    shallow = None
    if part in MESH_GRAD_CUTS:
        shallow = mesh_grad_gate(replace(full, **MESH_GRAD_CUTS[part]),
                                 mesh, B, T)
    sv = MESH_FAMILY_SERVE
    serve = _mesh_serve(
        cfg, mesh, sv["batch"], sv["positions"] - (
            cfg.num_prefix_embeds if part == "vlm" else 0), sv["gen"],
        frames=sv["frames"] if part == "encdec" else 0,
        consistency_len=MESH_MOE_CONSISTENCY if part == "moe" else None)
    res = train["resident_bytes"]
    line = {"phase": "lm_mesh_family", "part": part, "arch": arch,
            "device": smi, "cut": ", ".join(
                f"{k} {getattr(full, k)} -> {v}"
                for k, v in FAMILY_CUTS[part].items())
            + " (widths as published)",
            "summary": {
                "mesh_step_s": train["median_step_s"],
                "one_device_step_s": train["one_device_median_step_s"],
                "resident_bytes_per_coordinate": res["per_coordinate"],
                "share_of_state": res["share_of_total"],
                "collective_bytes_a_step": train["collective_bytes_a_step"],
                "decode_ms_per_token": serve["decode_ms_per_token"],
                "peak_memory_bytes": {
                    "train": train["peak_memory_bytes"],
                    "serve": serve["peak_memory_bytes"]},
                "replicated_dims": {"train": train["replicated_dims"],
                                    "serve": serve["replicated_dims"]}},
            "train": train, "serve": serve}
    if shallow is not None:
        line["grad_gate"] = shallow
    if part == "moe":
        line["moe_drop_gate"] = moe_drop_gate(cfg, mesh)
    line["seconds"] = time.perf_counter() - t0
    return line


def phase_lm_mesh(smi: str) -> None:
    """Phase 12: the dense LM on a (data 2, model 2) mesh of 4 x the card
    (``launch.mesh.make_host_mesh(model=2, shards=4)``), seeded random
    weights: (a) smollm-135m at its published size trains 10 steps
    against a one-device run from the same state and batches and serves
    at B = 4 and at B = 1 (``small_batch``); its 2-layer copy trains 6
    steps, saves at step 3 (on a thread) and, last, restores the step-3
    checkpoint onto the mesh and resumes against the uninterrupted run
    (``MESH_RESUME``); (b) qwen3-4b at its published widths
    serves at 36 layers and trains 5 steps at 2 layers; (c) olmoe-1b-7b,
    paligemma-3b, mamba2-2.7b, zamba2-7b and seamless-m4t-medium at their
    published widths, phase 11's depth, train beside one device and
    serve (:func:`mesh_family`).  The RPQ kernels' counts are set to 0
    before and read after."""
    import tempfile
    from dataclasses import replace
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import loop
    t_phase = time.perf_counter()

    def emit_at(line: dict) -> None:
        emit({**line, "at_s": time.perf_counter() - t_phase})

    print(smi, flush=True)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(model=MESH_SHAPE["model"],
                          shards=MESH_SHAPE["shards"], device=LM_DEVICE)
    cfg = get_config(MESH_TRAIN["arch"])
    B, T = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    train, _, _, state, _ = _mesh_train_compare(cfg, mesh, B, T,
                                                MESH_TRAIN["steps"])
    del state
    _free()
    MESH_MEASURED.update(
        resident_from_specs=train["resident_bytes"]["from_specs"],
        collective_bytes_a_step=train["collective_bytes_a_step"])
    emit_at({"phase": "lm_mesh_train", "device": smi, **train,
             "gates": MESH_GATES})
    cut = replace(cfg, num_layers=MESH_RESUME["layers"])
    with tempfile.TemporaryDirectory() as d:
        train, saved, snapshot, state, (fn, batch, data) = \
            _mesh_train_compare(cut, mesh, B, T, MESH_RESUME["steps"],
                                MESH_RESUME["save_at"], d)
        emit_at({"phase": "lm_mesh_train", "device": smi, **train,
                 "cut": f"num_layers {cfg.num_layers} -> "
                        f"{MESH_RESUME['layers']} (widths as published): "
                        "the run the resume repeats", "gates": MESH_GATES})
        straight = loop.train_state_tree(state)     # unsharded, on the card
        emit_at({"phase": "lm_mesh_serve", "device": smi, **_mesh_serve(
            cfg, mesh, MESH_SERVE["batch"], MESH_SERVE["prompt_len"],
            MESH_SERVE["gen"])})
        emit_at({"phase": "lm_mesh_serve", "device": smi, **_mesh_serve(
            cfg, mesh, MESH_SERVE["small_batch"], MESH_SERVE["prompt_len"],
            MESH_SERVE["small_gen"])})
        wide = get_config(MESH_WIDE_SERVE["arch"])
        emit_at({"phase": "lm_mesh_serve", "device": smi, **_mesh_serve(
            wide, mesh, MESH_WIDE_SERVE["batch"],
            MESH_WIDE_SERVE["prompt_len"], MESH_WIDE_SERVE["gen"])})
        cut = replace(wide, num_layers=MESH_WIDE_TRAIN["layers"])
        line, _, _, wstate, _ = _mesh_train_compare(
            cut, mesh, MESH_WIDE_TRAIN["batch"], MESH_WIDE_TRAIN["seq"],
            MESH_WIDE_TRAIN["steps"], profile=True)
        del wstate
        _free()
        emit_at({"phase": "lm_mesh_train", "device": smi, **line,
              "cut": f"num_layers {wide.num_layers} -> "
                     f"{MESH_WIDE_TRAIN['layers']} (widths as published)",
              "gates": MESH_GATES})
        for part, arch in FAMILY_ARCHS:
            emit_at(mesh_family(part, arch, mesh, smi))

        # the step-3 checkpoint onto the mesh, then steps 4-6 again
        pool, fut = saved
        t0 = time.perf_counter()
        fut.result()
        pool.shutdown()
        resume = {"save_wait_s": time.perf_counter() - t0,
                  "bytes_on_disk": _dir_bytes(d)}
        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            extra = loop.restore_train_state(d, state)
            torch.cuda.synchronize()
            resume["restore_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = ckpt._flatten(loop.train_state_tree(state))
            resume["restore_exact"] = all(
                torch.equal(x.cpu(), y) for (_, x), (_, y) in
                zip(got, ckpt._flatten(snapshot)))
            resume["restore_check_s"] = time.perf_counter() - t0
            start = int(extra["data"]["step"])
            t0 = time.perf_counter()
            for s in range(start, MESH_RESUME["steps"]):
                state, m = fn(state, batch(s))
                float(m["loss"])
            resume["resumed_steps_s"] = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        worst = 0.0
        close = True
        for (k, x), (_, y) in zip(
                ckpt._flatten(loop.train_state_tree(state)),
                ckpt._flatten(straight)):
            x, y = x.double(), y.double()
            close &= bool(torch.allclose(x, y, rtol=MESH_GATES["resume_rtol"],
                                         atol=MESH_GATES["resume_atol"]))
            worst = max(worst, float((x - y).abs().max()))
        resume.update({"resumed_from": start, "max_abs_diff": worst,
                       "within_rtol_atol": close})
    emit_at({"phase": "lm_mesh_resume", "device": smi, **resume})
    if not resume["restore_exact"]:
        fail("the mesh's restore is not bit for bit the saved state")
    if start != MESH_RESUME["save_at"] or not close:
        fail(f"the resumed mesh run differs from the uninterrupted one: "
             f"{resume}")
    del state, snapshot, straight
    _free()
    launches = launch_counts()
    emit({"phase": "lm_mesh", "kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    if any(launches.values()):
        fail(f"the LM mesh launched an RPQ kernel: {launches}")


# -- phase 13: the dry run, and make_bfs at the ring-rpq config's size ---------
BFS_SHARDS = 4
BFS_SEED = 29
BFS_START_NODES = 65_536
# 15 positions (S = 16) over the most frequent predicates (0-8; ^p its
# inverse): the ring-rpq config's automaton size
BFS_REGEX = "(0|^0|1)+/(2|^2|3|^1)*/(4|^3|5)*/(6|7|^4|8|^5)*"
# phase 12 (a)'s resident bytes and collective bytes a step, which 13 (b)
# holds the dry run to
MESH_MEASURED: dict = {}
DRY_CELLS = (("ring-rpq", "train_4k"), ("smollm-135m", "train_4k"))


def rpq_graph(c, shards: int, seed: int, device):
    """The ring-rpq config's graph on the card, drawn from a seeded
    ``torch.Generator``: ``[shards, E / shards]`` int32 subj (uniform in
    each shard's range, owner-local), pred and obj.  Objects carry hubs
    as ``scale_free_graph`` draws nodes (weight ``1 / rank ** 0.8``, node
    0 the largest); predicates are Zipf-skewed as Wikidata's are
    (weight ``1 / rank`` over the L / 2 predicates, a few holding most
    triples), each edge forward (p) or inverse (p + L / 2) at random."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    V, E, L = c.num_nodes, c.num_edges, c.num_labels
    P, Vl, El = L // 2, V // shards, E // shards

    def cdf(n, power):
        w = torch.arange(1, n + 1, dtype=torch.float64,
                         device=device).pow(-power)
        out = torch.cumsum(w, 0)
        return out / out[-1]

    nodes, preds = cdf(V, 0.8), cdf(P, 1.0)
    subj, pred, obj = (torch.empty((shards, El), dtype=torch.int32,
                                   device=device) for _ in range(3))
    for k in range(shards):
        subj[k] = torch.randint(0, Vl, (El,), generator=gen, device=device,
                                dtype=torch.int32)
        u = torch.rand(El, generator=gen, device=device, dtype=torch.float64)
        obj[k] = torch.searchsorted(nodes, u).clamp_(max=V - 1)
        u = torch.rand(El, generator=gen, device=device, dtype=torch.float64)
        p = torch.searchsorted(preds, u).clamp_(max=P - 1)
        p += P * torch.randint(0, 2, (El,), generator=gen, device=device)
        pred[k] = p
        del u, p
    return subj, pred, obj


def rpq_tables(c, device):
    """B [L+1, S] and PRED [S, S] int8 planes and the start row [S] of
    ``BFS_REGEX``, compiled by the port's ``regex``/``glushkov`` (the
    dense engine's plane tables, unpacked)."""
    import numpy as np
    import torch
    from repro_torch.core import dense as pdense
    from repro_torch.core import glushkov
    from repro_torch.kernels import ops
    P = c.num_labels // 2
    g = glushkov.build(BFS_REGEX, lambda lit: int(lit.name) +
                       (P if lit.inverse else 0))
    S = g.m + 1
    if S != c.nfa_states:
        fail(f"{BFS_REGEX} has {S} states, the config {c.nfa_states}")
    Bw, Pw = pdense._plane_tables(g, c.num_labels)

    def planes(words):
        return torch.from_numpy(ops.unpack_bits(words, S).astype(np.int8)
                                ).to(device)

    return planes(Bw), planes(Pw), planes(pdense._start_row(g))


def _held_bytes(bfs) -> dict:
    """What the mesh's BFS holds on the card, from its own tensors."""
    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    shards = sum(nb(*r.bufs, r.v, r.edges.grouped.offsets,
                    r.edges.grouped.subj, r.edges.grouped.pred,
                    r.scratch.work, r.scratch.counters)
                 for r in bfs.replicas)
    once = sum(nb(g) for g in bfs.gathered.values()) + \
        sum(nb(*t) for t in bfs.tables.values())
    return {"shards": shards, "gathered_and_tables": once,
            "total": shards + once}


def bfs_heaviest_superstep(run, planes, errs: dict) -> dict:
    """``make_bfs`` run again on the same inputs with a recorder
    (:func:`_recorder`) on ``ops.packed_superstep`` that keeps the shard
    launch with the most non-zero transition inputs, as phases 5, 7 and
    8 keep theirs; that launch held to its plain version on the card and
    timed (:func:`superstep_check_and_time`, over the gathered
    frontier).  The rerun's launches are no part of the main path's
    count.  Returns the check, the launch's shape and whether the rerun
    gave the same planes as ``planes`` (the main path's)."""
    import torch
    from repro_torch.kernels import ops as kops
    capture: dict = {}
    recording, seen = _recorder(
        capture, "bfs_superstep",
        lambda: [r.edges for r in run.last.replicas],
        lambda f, gathered: gathered is not None)
    original = kops.packed_superstep
    kops.packed_superstep = recording
    try:
        again = run(*planes[2:])
    finally:
        kops.packed_superstep = original
    same = all(bool(torch.equal(a, b)) for a, b in zip(again, planes[:2]))
    args, gathered = capture["bfs_superstep"]
    shard = next(r.k for r in run.last.replicas if r.edges is args[8])
    run.last = None
    del again
    _free()
    shape = {"shard": shard, "superstep": int(args[5]),
             "launches_recorded": seen[0],
             "transition_words": capture["bfs_superstep_live"],
             "E_local": int(args[8].subj.shape[0]),
             "V_local": int(args[0].shape[1]),
             "V_pad": int(gathered.shape[1]), "S": int(args[7].shape[1]),
             "W": int(gathered.shape[2]), "rerun_equal": same}
    check = superstep_check_and_time(
        errs, args, "the ring-rpq BFS's heaviest shard superstep",
        gathered=gathered)
    return {**shape, **check}


def bfs_at_config(smi: str, errs: dict) -> dict:
    """13 (a): ``make_bfs`` at the ring-rpq config's own size on a mesh
    of 4 x the card, against the one-device ``dense.bfs_rows`` on the
    same edges; its heaviest shard superstep against the kernel's plain
    version (:func:`bfs_heaviest_superstep`); and its bytes against the
    dry run's record of that mesh (``dryrun.lower_rpq``): held at most
    the record's worst case (every edge kept, the most worklist tiles),
    exactly its formula given the run's own tile and edge counts, and
    gathered exactly (no data in it)."""
    import torch
    from repro_torch.configs.ring_rpq import CONFIG as c
    from repro_torch.core import dense as pdense
    from repro_torch.core.distributed import Mesh, make_bfs
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.launch import dryrun
    dev = torch.device(LM_DEVICE)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    clock = {}
    t0 = time.perf_counter()
    subj, pred, obj = rpq_graph(c, BFS_SHARDS, BFS_SEED, dev)
    B, PRED, start_row = rpq_tables(c, dev)
    S, V = c.nfa_states, c.num_nodes
    gen = torch.Generator(device=dev).manual_seed(BFS_SEED + 1)
    starts = torch.randperm(V, generator=gen, device=dev)[:BFS_START_NODES]
    frontier = torch.zeros((V, S), dtype=torch.int8, device=dev)
    frontier[starts] = start_row
    visited = frontier.clone()
    torch.cuda.synchronize()
    clock["graph_s"] = time.perf_counter() - t0
    mesh = Mesh([dev] * BFS_SHARDS, ("data",))
    run = make_bfs(mesh, ("data",), S, c.supersteps)
    steps = []

    def on_step(n, bfs):
        torch.cuda.synchronize()
        live = sum(int((w != 0).sum()) for w in bfs.frontier_words(n))
        steps.append({"superstep": n + 1, "live_share": live / V,
                      "at_s": time.perf_counter() - t_run})

    reset_launch_counts()
    t_run = time.perf_counter()
    f_mesh, v_mesh = run(frontier, visited, subj, pred, obj, B, PRED,
                         on_step=on_step)
    torch.cuda.synchronize()
    launches = launch_counts()
    clock["make_bfs_s"] = time.perf_counter() - t_run
    bfs = run.last
    first = steps[0]["at_s"]
    per_step = [b["at_s"] - a["at_s"] for a, b in zip(steps, steps[1:])]
    held = _held_bytes(bfs)
    devices = len(bfs.devices)
    # the sweep's record of this mesh (a device a shard), its worst case
    # on this mesh's one card, and its formula at the run's own counts
    sweep = dryrun.lower_rpq(mesh)
    worst = dryrun.lower_rpq(mesh, gather_devices=devices)
    formula = dryrun.lower_rpq(
        mesh, tiles=[r.edges.grouped.tiles for r in bfs.replicas],
        edges_kept=[int(r.edges.grouped.subj.numel()) for r in bfs.replicas],
        gather_devices=devices)
    predicted = {"held_at_most": worst["port_held_bytes_all_shards"],
                 "held_given_run_counts":
                     formula["port_held_bytes_all_shards"],
                 "gathered": c.supersteps * worst[
                     "gather_bytes_per_superstep"]["port_all_devices"]}
    gathered = bfs.gather_bytes
    run.last = bfs = None
    _free()
    t0 = time.perf_counter()
    heaviest = bfs_heaviest_superstep(
        run, (f_mesh, v_mesh, frontier, visited, subj, pred, obj, B, PRED),
        errs)
    clock["heaviest_superstep_s"] = time.perf_counter() - t0
    _free()
    # the one-device BFS on the same edges
    t0 = time.perf_counter()
    Vl = V // BFS_SHARDS
    offs = (torch.arange(BFS_SHARDS, device=dev, dtype=torch.int32)
            * Vl)[:, None]
    edges = pdense.Edges.build((subj + offs).reshape(-1), pred.reshape(-1),
                               obj.reshape(-1), V, c.num_labels)
    clock["one_device_layout_s"] = time.perf_counter() - t0
    words = ops.planes_to_words(frontier)[None]
    vis, fr, it = pdense.bfs_rows(
        edges, ops.planes_to_words(B)[None], ops.planes_to_words(PRED)[None],
        words, c.supersteps, visited=words.clone())
    torch.cuda.synchronize()
    clock["one_device_bfs_s"] = time.perf_counter() - t0
    same = bool(torch.equal(ops.words_to_planes(vis[0], S), v_mesh)) and \
        bool(torch.equal(ops.words_to_planes(fr[0], S), f_mesh))
    edge_bytes = 3 * subj.numel() * subj.element_size()
    out = {
        "phase": "dry_run_bfs", "device": smi,
        "config": {"num_nodes": V, "num_edges": c.num_edges,
                   "num_labels": c.num_labels, "nfa_states": S,
                   "supersteps": c.supersteps, "shards": BFS_SHARDS,
                   "start_nodes": BFS_START_NODES, "regex": BFS_REGEX,
                   "seed": BFS_SEED},
        "supersteps": steps, "first_superstep_s": first,
        "seconds_a_superstep": per_step,
        "one_device_supersteps": it, "equal_to_one_device": same,
        "kernel_launches": launches,
        "heaviest_superstep": heaviest,
        "edge_array_bytes": edge_bytes,
        "plane_bytes": 2 * frontier.numel(),
        "held_bytes": held, "gathered_bytes": gathered,
        "dry_run": {"held_bytes_at_most": predicted["held_at_most"],
                    "held_bytes_given_run_counts":
                        predicted["held_given_run_counts"],
                    "gathered_bytes": predicted["gathered"],
                    "sweep_record_held_bytes":
                        sweep["port_held_bytes_all_shards"],
                    "reference_argument_bytes_per_device":
                        sweep["reference_argument_bytes_per_device"],
                    "kernel_bytes_per_superstep_all_live":
                        sweep["kernel_bytes_per_superstep_all_live"]},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "seconds_by_part": clock}
    del edges, vis, fr, words, subj, pred, obj
    _free()
    if not same:
        fail(f"make_bfs on the mesh differs from one device: {out}")
    if not heaviest["rerun_equal"]:
        fail(f"make_bfs gave other planes when run again: {out}")
    if not all(s["live_share"] > 0 for s in steps) or \
            len(steps) != c.supersteps:
        fail(f"the ring-rpq BFS's frontier emptied: {steps}")
    if launches["packed_superstep"] != BFS_SHARDS * c.supersteps or \
            launches["nfa_step"] or launches["segment_or"]:
        fail(f"make_bfs launched {launches}")
    if held["total"] > predicted["held_at_most"] or \
            held["total"] != predicted["held_given_run_counts"] or \
            gathered != predicted["gathered"]:
        fail(f"the dry run's ring-rpq bytes miss the card's: {out}")
    return out


def dry_run_vs_mesh(smi: str) -> dict:
    """13 (b): the dry run of phase 12 (a)'s training (its arch, mesh
    shape and B, T) on the meta device against what phase 12 (a)
    measured: resident bytes from the specs, and the forward collective
    bytes of a step by kind."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=MESH_SHAPE["model"],
                          shards=MESH_SHAPE["shards"], device="meta")
    shape = ShapeSpec("phase_12a", MESH_TRAIN["seq"], MESH_TRAIN["batch"],
                      "train")
    t0 = time.perf_counter()
    rec = dryrun.analyse(dryrun.trace_cell(MESH_TRAIN["arch"], shape, mesh),
                         mesh)
    res = dryrun.resident(MESH_TRAIN["arch"], shape, mesh)
    got = {"resident_from_specs": res["params"] + res["opt_moments"],
           "collective_bytes_a_step":
               rec["collectives"]["forward_bytes_all_coordinates"]}
    out = {"phase": "dry_run_vs_mesh", "device": smi,
           "arch": MESH_TRAIN["arch"], "mesh": mesh.shape,
           "batch": shape.global_batch, "seq": shape.seq_len,
           "method": rec["method"], "trace_seconds": rec["trace_seconds"],
           "seconds": time.perf_counter() - t0, "dry_run": got,
           "measured": dict(MESH_MEASURED),
           "saved_bytes_per_device": rec["saved_bytes_per_device"],
           "flops_per_device": rec["flops_per_device"]}
    if got != MESH_MEASURED:
        fail(f"the dry run misses phase 12 (a)'s bytes: {out}")
    return out


def phase_dry_run(smi: str, errs: dict, capture: dict) -> dict:
    """Phase 13: (a) ``make_bfs`` at the ring-rpq config's size (V =
    2**25, E = 2**29, L = 1,024, S = 16, 8 supersteps) on a mesh of 4 x
    the card, equal to one device, its bytes equal to the dry run's; (b)
    the dry run against phase 12 (a); (c) two production cells of the
    dry run (16 x 16 on the meta device), with their trace seconds.
    (a)'s heaviest shard superstep goes to ``capture["bfs_superstep"]``
    for the kernels line.  Returns the kernel launches of (a)."""
    import tempfile
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    print(smi, flush=True)
    a = bfs_at_config(smi, errs)
    capture["bfs_superstep"] = a["heaviest_superstep"]
    emit({**a, "at_s": time.perf_counter() - t_phase})
    emit({**dry_run_vs_mesh(smi), "at_s": time.perf_counter() - t_phase})
    cells = {}
    with tempfile.TemporaryDirectory() as d:
        for arch, shape in DRY_CELLS:
            rec = dryrun.run_cell(arch, shape, False, d, verbose=False)
            if not rec.get("ok"):
                fail(f"dry run {arch} {shape}: {rec}")
            cells[arch] = {k: rec[k] for k in (
                "num_devices", "trace_seconds", "resident_bytes_per_device",
                "saved_bytes_per_device", "fits_h100", "est", "method")}
    emit({"phase": "dry_run_cells", "device": smi, "mesh": "16x16 (meta)",
          "cells": cells, "at_s": time.perf_counter() - t_phase})
    emit({"phase": "dry_run", "kernel_launches": a["kernel_launches"],
          "seconds": time.perf_counter() - t_phase})
    return a["kernel_launches"]


# -- phase 14: the static analyzer --------------------------------------------
ANALYSIS_MESH = 4        # devices of the trace layer's mesh: 4 x the card


def phase_analysis(smi: str) -> dict:
    """Phase 14: ``python -m repro_torch.analysis`` in this process (its
    report captured), all three layers on this tree, the trace layer on
    the card over a mesh of 4 x the card, every kernel it launches held
    to its plain version there.  Fails on any finding the baseline does
    not hold, or a report without T005's bytes.  Returns the
    phase's kernel launches, the kernels line's ``audit`` point."""
    import io
    import tempfile
    import torch
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    print(smi, flush=True)
    report = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "analysis.json")
        reset_launch_counts()
        with contextlib.redirect_stdout(report):
            rc = analysis_main([
                "--device", "cuda", "--mesh-devices", str(ANALYSIS_MESH),
                "--no-trace-cache", "--root", ROOT, "--json", out])
        torch.cuda.synchronize()
        launches = launch_counts()
        with open(out) as f:
            doc = json.load(f)
    notes = doc["notes"]
    if rc != 0 or doc["new"]:
        fail(f"the analyzer found {len(doc['new'])} new finding(s):\n"
             + report.getvalue())
    trace = doc["trace"]
    t005 = trace["t005"] if trace else None
    if t005 is None:
        fail("the analyzer measured no T005 bytes over the mesh:\n"
             + report.getvalue())
    gathered = t005["gathered_bytes_per_participant_per_superstep"]
    return {"phase": "analysis", "device": smi,
            "args": ["--device", "cuda", "--mesh-devices",
                     str(ANALYSIS_MESH), "--no-trace-cache"],
            "new": len(doc["new"]), "baselined": doc["baselined"],
            "checks": trace["checks"],
            "t005": {**t005,
                     "gathered_over_port_model":
                         gathered / t005["port_wire_model_bytes"],
                     "gathered_over_reference_model":
                         gathered / t005["reference_int8_plane_model_bytes"]},
            "b001": [n for n in notes if n.startswith("B001")],
            "notes": notes, "kernel_launches": launches,
            "seconds": time.perf_counter() - t0}


# -- phase 15: the query examples ---------------------------------------------
EXAMPLE_KERNELS = ("nfa_step", "packed_superstep")


def record_example_launch(engine, answers, capture: dict) -> dict:
    """Rerun the Wikidata-style queries on the example's dense engine
    (``DenseRPQ(source_batch=8)``, its result cache cleared) with two
    recorders (:func:`_recorder`) on ``ops.packed_superstep``: one keeps
    the launch with the most non-zero transition inputs in
    ``capture["examples_superstep"]``, the other the heaviest launch of
    ``source_batch`` rows (an unbound query's batch) in
    ``capture["examples_rows_superstep"]``, for the kernels line.  The
    rerun's answers must equal the timed run's.  Returns the launches
    recorded."""
    import torch
    from repro_torch.examples import wikidata_style_queries as wikidata
    from repro_torch.kernels import ops as kops
    original = kops.packed_superstep

    def epochs():
        return [e for e in (engine.dg.edges, engine._eff) if e is not None]

    recording, seen = _recorder(capture, "examples_superstep", epochs,
                                lambda f, gathered: gathered is None)
    kops.packed_superstep = recording      # the second wraps the first
    rows, _ = _recorder(
        capture, "examples_rows_superstep", epochs,
        lambda f, gathered: f.shape[0] == engine.source_batch and
        gathered is None)
    engine.results.clear()
    kops.packed_superstep = rows
    try:
        again = [engine.eval(q[0], subject=q[1], obj=q[2],
                             limit=wikidata.LIMIT) for q, _, _ in answers]
        torch.cuda.synchronize()
    finally:
        kops.packed_superstep = original
    if "examples_rows_superstep" not in capture:
        fail(f"the examples' dense rerun made no launch of "
             f"{engine.source_batch} rows")
    if again != [dense for _, _, dense in answers]:
        fail("the examples' dense rerun answered otherwise than its run")
    return {"launches_recorded": seen[0],
            "heaviest_transition_words": capture["examples_superstep_live"],
            "heaviest_rows_transition_words":
                capture["examples_rows_superstep_live"]}


def phase_examples(smi: str, capture: dict) -> dict:
    """Phase 15: ``repro_torch.examples.quickstart`` and
    ``.wikidata_style_queries`` through their ``main`` on the card, at
    the JAX package's defaults (nothing cut: the metro graph; 5,000
    nodes, 40,000 edges, 16 predicates, 25 queries, ``limit=100_000``),
    each with the counts set to 0 just before and read just after, the
    largest ``nfa_step`` launch's inputs kept in ``capture["examples_X"]``
    and ``["examples_bwd"]``.  Then, the timed runs over, every answer
    of both engines is held to the host oracle, ``eval_oracle_by_label``
    on a graph built anew (the Wikidata-style example itself compares
    only the engines' counts), and the dense engine's queries are rerun
    to keep its heaviest ``packed_superstep`` launches
    (:func:`record_example_launch`).  The line gives the per-pattern ms
    of each engine beside the card's name and power limit."""
    import io

    import torch
    from repro_torch.core.fixtures import scale_free_graph
    from repro_torch.core.oracle import eval_oracle_by_label
    from repro_torch.core.patterns import generate_workload
    from repro_torch.examples import quickstart
    from repro_torch.examples import wikidata_style_queries as wikidata
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import ops as kops
    t_phase = time.perf_counter()
    print(smi, flush=True)
    out = {"phase": "examples", "device": smi}
    d = wikidata.DEFAULTS
    workload = generate_workload(d["queries"], d["preds"], d["nodes"],
                                 seed=wikidata.WORKLOAD_SEED).queries
    original = kops.nfa_step

    def recording(X, bwd):     # keep the largest launch's inputs
        if X.shape[0] > capture.get("examples_N", -1):
            capture.update(examples_N=X.shape[0], examples_X=X.clone(),
                           examples_bwd=bwd.clone())
        return original(X, bwd)

    records = {}
    kops.nfa_step = recording
    try:
        for name, mod in (("quickstart", quickstart), ("wikidata", wikidata)):
            rec, text = {}, io.StringIO()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = mod.main([], record=rec)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            if rc != 0:
                fail(f"the {name} example exited {rc}:\n{text.getvalue()}")
            records[name] = rec
            out[name] = {"seconds": seconds, "queries": len(rec["answers"]),
                         "kernel_launches": {k: launches[k]
                                             for k in EXAMPLE_KERNELS},
                         "stdout_lines": len(text.getvalue().splitlines())}
    finally:
        kops.nfa_step = original
    for k in EXAMPLE_KERNELS:
        if not sum(out[n]["kernel_launches"][k] for n in records):
            fail(f"the examples launched no {k} kernel")
    if "examples_X" not in capture:
        fail("the examples' nfa_step launches went past the recorder")
    wd = records["wikidata"]
    if [q for q, _, _ in wd["answers"]] != [tuple(q) for q in workload]:
        fail("the Wikidata-style example ran other queries than the "
             "oracle's")
    t0 = time.perf_counter()
    graph = scale_free_graph(d["nodes"], d["preds"], d["edges"],
                             seed=wikidata.GRAPH_SEED)
    qs = records["quickstart"]
    wants = {"quickstart": [eval_oracle_by_label(qs["graph"], *q)
                            for q, _, _ in qs["answers"]],
             "wikidata": [eval_oracle_by_label(graph, *q[:3],
                                               limit=wikidata.LIMIT)
                          for q in workload]}
    out["oracle_s"] = time.perf_counter() - t0
    for name, rec in records.items():
        for (q, ring, dense), want in zip(rec["answers"], wants[name]):
            if ring != want or dense != want:
                fail(f"the {name} example's answers to {q} differ from the "
                     f"host oracle's: ring {len(ring)}, dense {len(dense)}, "
                     f"oracle {len(want)} pairs")
        out[name]["answers_equal_to_oracle"] = True
        out[name]["answer_pairs"] = sum(len(w) for w in wants[name])
    out["wikidata"]["rerun"] = record_example_launch(
        wd["engines"]["dense"], wd["answers"], capture)
    g = wd["graph"]
    out["wikidata"]["config"] = {
        "nodes": g.num_nodes, "edges": int(g.s.size), "preds": g.num_preds,
        "queries": len(workload), "limit": wikidata.LIMIT}
    out["wikidata"]["per_pattern"] = {
        p: {"n": wd["counts"][p], "ring_ms": v["ring"],
            "dense_ms": v["dense"]} for p, v in sorted(wd["ms"].items())}
    out["kernel_launches"] = {k: sum(out[n]["kernel_launches"][k]
                                     for n in records)
                              for k in EXAMPLE_KERNELS}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the kernels line ----------------------------------------------------------
KERNEL_SOURCES = {   # name -> (CUDA source, the TPU kernel it replaces)
    "nfa_step": ("src/repro_torch/kernels/csrc/nfa_step.cu",
                 "src/repro/kernels/nfa_step.py:54"),
    "packed_superstep": ("src/repro_torch/kernels/csrc/packed_superstep.cu",
                         "src/repro/kernels/nfa_step.py:54 + "
                         "src/repro/kernels/segment_or.py:43 (and the "
                         "XLA superstep src/repro/core/dense.py:136)"),
    "segment_or": ("src/repro_torch/kernels/csrc/segment_or.cu",
                   "src/repro/kernels/segment_or.py:43"),
    "segmented_or_scan": ("src/repro_torch/kernels/csrc/segment_or.cu",
                          "src/repro/kernels/segment_or.py:43"),
    "superblock_popcounts": ("src/repro_torch/kernels/csrc/rank_popcount.cu",
                             "src/repro/kernels/rank_popcount.py:36"),
    "rank1": ("src/repro_torch/kernels/csrc/rank_popcount.cu",
              "src/repro/kernels/rank_popcount.py:61"),
}


def segment_extras(errs: dict, capture: dict, seg_args, scan_args):
    """The kernels line's extra fields of ``segment_or`` (on
    ``seg_args``, the heaviest superstep's values) and
    ``segmented_or_scan`` (on ``scan_args``): see :func:`kernels_line`."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_or as kseg
    vals, seg_ids, V = seg_args
    seg_floors = capture["segment_floor_ms"]
    perm = torch.from_numpy(np.random.default_rng(22).permutation(
        vals.shape[0])).to(vals.device)
    perm_args = (vals[perm].contiguous(), seg_ids[perm].contiguous(), V)
    permuted = check_and_time(errs, "segment_or", kseg.segment_or_cuda,
                              ref.segment_or_ref, perm_args,
                              "the heaviest superstep's values, permuted")
    segment_extra = {
        "floor_ms": seg_floors["segment_or"],
        "longest_run_of_ids": longest_run(seg_ids),
        "longest_run_of_nonzero_rows": longest_run(
            seg_ids[(vals != 0).any(1)]),
        "cuda_launches_per_call": cuda_launches_per_call(
            lambda: kseg.segment_or_cuda(*seg_args)),
        "permuted": permuted}
    scan_extra = {
        "floor_ms": seg_floors["segmented_or_scan"],
        "cuda_launches_per_call": cuda_launches_per_call(
            lambda: kseg.segmented_or_scan_cuda(*scan_args))}
    if PARENT is not None:
        segment_extra.update(PARENT.turns_of(
            "segment_or", seg_args, ref.segment_or_ref(*seg_args),
            lambda: kseg.segment_or_cuda(*seg_args)))
        permuted.update(PARENT.turns_of(
            "segment_or", perm_args, ref.segment_or_ref(*perm_args),
            lambda: kseg.segment_or_cuda(*perm_args)))
        scan_extra.update(PARENT.turns_of(
            "segmented_or_scan", scan_args,
            ref.segmented_or_scan_ref(*scan_args),
            lambda: kseg.segmented_or_scan_cuda(*scan_args)))
    return segment_extra, scan_extra


def kernels_line(capture: dict, launches: dict, errs: dict,
                 superstep_paths: dict, nfa_paths: dict, audit: dict):
    """One entry per kernel, timed at the largest launch of its path:
    ``nfa_step`` at phase 2's, ``packed_superstep`` at phase 5's heaviest
    superstep (the most non-zero transition words), with its phase-1 time
    at the dense path's R = 16 rows beside it (``rows``) and its launches
    on each path (``launches_by_path``), ``segment_or`` (on no path since
    ``packed_superstep`` took its place) on that superstep's values, the
    rank kernels at phase 6's largest level, ``segmented_or_scan`` (on no
    path) at phase 1's full size.  ``shard``: ``nfa_step`` at phase 8's
    largest shard launch (and ``serving``: at phase 9 (a)'s largest
    launch), ``packed_superstep`` at phase 8 (b)'s heaviest
    shard launch (R = 16 rows, the shard's local state and edges, the
    gathered frontier; ``record_shard_launch``), each with its launches
    on the mesh path.  ``dense``: ``packed_superstep`` at phase 7's
    heaviest real R = 16 launch (``record_dense_launch``).  ``bfs``:
    ``packed_superstep`` at phase 13 (a)'s heaviest shard superstep (the
    ring-rpq size, R = 1; :func:`bfs_heaviest_superstep`).
    ``examples``: ``nfa_step`` at phase 15's largest launch and
    ``packed_superstep`` at its dense engine's heaviest launch and
    heaviest launch of 8 rows (``rows``; :func:`record_example_launch`),
    each with its launches there.  Each
    ``packed_superstep`` point has its bound over the grouped inputs, the
    edge pass's bound and the bytes its design moves beside it
    (:func:`superstep_bounds`) and, with ``--parent``, the parent's time
    in the same call (``parent_ms``).  ``superblock_popcounts``: the
    one-launch directory (``directory``) and the launch floors of both
    modes; ``rank1``: its L2 sector bytes, the same offsets sorted
    (``sorted``) and its launch floor; with ``--parent``, the parent's
    ``rank1`` and ``build_rank_directory`` in turns.  ``segment_or`` and
    ``segmented_or_scan``: their launch floors (``floor_ms``, phase 1),
    the ``cudaLaunchKernel`` calls of one call (``cuda_launches_per_call``:
    the scan's own launch; the scatter's and the zero fill's) and, with
    ``--parent``, the parent's kernels in turns; ``segment_or`` also the
    longest runs of equal ids in its input (over all rows, and over the
    rows with a non-zero word) and the same input with its rows
    permuted (``permuted``: ids in no order), bit for bit.  ``audit``:
    each kernel's launches in phase 14's trace audit, counted apart from
    its path's.  ``library_ms`` is null throughout: no single PyTorch
    call ORs or popcounts packed words."""
    import torch
    from repro_torch.kernels import nfa_step as knfa
    from repro_torch.kernels import rank_popcount as krank
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_or as kseg
    X, bwd = capture["X"], capture["bwd"]
    sup = superstep_check_and_time(errs, capture["packed_superstep"],
                                   "the heaviest superstep")
    sup_args = capture["packed_superstep"]
    vals, seg_ids, V = capture["segment_or"]
    scan_vals, flags = capture["segmented_or_scan"]
    words, directory, q = capture["rank"]
    level = {"where": "phase 6's largest level", "NW": int(words.shape[0])}
    rank = {order: rank1_check(errs, words, directory, qo, order=order,
                               Q=int(q.shape[0]), **level)
            for order, qo in (("random", q), ("sorted", torch.sort(q)[0]))}
    directory_line = directory_check(errs, words, **level)[1]
    floors = capture["rank_floor_ms"]
    seg_args, scan_args = (vals, seg_ids, V), (scan_vals, flags)
    segment_extra, scan_extra = segment_extras(errs, capture, seg_args,
                                               scan_args)

    def rank_part(line, keys=("ms", "plain_ms", "bound_ms", "bound_by",
                              "l2_sector_bytes", "l2_tb_s",
                              "word_walk_sector_bytes", "parent_ms",
                              "turns_ms", "parent_equal")):
        return {k: line[k] for k in keys if k in line}

    def checked(name, kernel, plain, args):
        return lambda: check_and_time(errs, name, kernel, plain, args,
                                      "its path's input")

    timed = {
        "nfa_step": (checked("nfa_step", knfa.nfa_step_cuda,
                             ref.nfa_step_ref, (X, bwd)),
                     nfa_bound(X, bwd.shape[0]),
                     {"N": int(X.shape[0]), "S": int(bwd.shape[0]),
                      "W": int(X.shape[1]),
                      "layout": knfa.layout(X.shape[1])}),
        "packed_superstep": (
            lambda: sup, (sup["bound_ms"], sup["bound_by"]),
            {"E": int(sup_args[8].subj.shape[0]),
             "V": int(sup_args[0].shape[1]), "S": int(sup_args[7].shape[1]),
             "W": int(sup_args[0].shape[2])}),
        "segment_or": (checked("segment_or", kseg.segment_or_cuda,
                               ref.segment_or_ref, seg_args),
                       segment_or_bound(vals, V),
                       {"E": int(vals.shape[0]), "W": int(vals.shape[1]),
                        "V": V, "nonzero_words": int((vals != 0).sum())}),
        "segmented_or_scan": (checked("segmented_or_scan",
                                      kseg.segmented_or_scan_cuda,
                                      ref.segmented_or_scan_ref, scan_args),
                              scan_bound(scan_vals),
                              {"E": int(scan_vals.shape[0]),
                               "W": int(scan_vals.shape[1])}),
        "superblock_popcounts": (checked("superblock_popcounts",
                                         krank.superblock_popcounts_cuda,
                                         ref.superblock_popcounts_ref,
                                         (words,)),
                                 popcounts_bound(words),
                                 {"NW": int(words.shape[0])}),
        "rank1": (lambda: {k: rank["random"][k] for k in
                           ("max_abs_err", "ms", "plain_ms")},
                  (rank["random"]["bound_ms"], rank["random"]["bound_by"]),
                  {"NW": int(words.shape[0]), "Q": int(q.shape[0]),
                   "order": "random"}),
    }
    rows = capture["rows"]
    sX, sbwd = capture["shard_X"], capture["shard_bwd"]
    shard_nfa_bound = nfa_bound(sX, sbwd.shape[0])
    vX, vbwd = capture["serve_X"], capture["serve_bwd"]
    serve_nfa_bound = nfa_bound(vX, vbwd.shape[0])
    shard_args, gathered = capture["shard_superstep"]
    shard_shape = {"shard": capture["shard_of"], "shards": MESH_SHARDS,
                   "R": int(gathered.shape[0]),
                   "E_local": int(shard_args[8].subj.shape[0]),
                   "V_local": int(shard_args[0].shape[1]),
                   "V_pad": int(gathered.shape[1]),
                   "S": int(shard_args[7].shape[1]),
                   "W": int(gathered.shape[2]),
                   "transition_words": capture["shard_superstep_live"]}
    dense_args, _none = capture["dense_superstep"]
    dense_shape = {"R": int(dense_args[0].shape[0]),
                   "E": int(dense_args[8].subj.shape[0]),
                   "V": int(dense_args[0].shape[1]),
                   "S": int(dense_args[7].shape[1]),
                   "W": int(dense_args[0].shape[2]),
                   "transition_words": capture["dense_superstep_live"]}
    eX, ebwd = capture["examples_X"], capture["examples_bwd"]
    examples_nfa_bound = nfa_bound(eX, ebwd.shape[0])

    def example_point(key, where):
        args, _none = capture[key]
        return {"R": int(args[0].shape[0]), "E": int(args[8].subj.shape[0]),
                "V": int(args[0].shape[1]), "S": int(args[7].shape[1]),
                "W": int(args[0].shape[2]),
                "transition_words": capture[key + "_live"],
                **superstep_check_and_time(errs, args, where)}

    extra = {
        "segment_or": segment_extra,
        "segmented_or_scan": scan_extra,
        "superblock_popcounts": {
            "directory_ms": directory_line["ms"],
            "directory": rank_part(directory_line, (
                "plain_ms", "bound_ms", "bound_by", "parent_ms", "turns_ms",
                "parent_equal")),
            "floor_ms": floors["superblock_popcounts"],
            "directory_floor_ms": floors["directory"]},
        "rank1": {**{k: v for k, v in rank_part(rank["random"]).items()
                     if k not in ("ms", "plain_ms", "bound_ms", "bound_by")},
                  "sorted": rank_part(rank["sorted"]),
                  "floor_ms": floors["rank1"]},
        "nfa_step": {
            "launches_by_path": nfa_paths,
            "shard": {"launches": nfa_paths["mesh"], "N": int(sX.shape[0]),
                      "S": int(sbwd.shape[0]), "W": int(sX.shape[1]),
                      **check_and_time(errs, "nfa_step", knfa.nfa_step_cuda,
                                       ref.nfa_step_ref, (sX, sbwd),
                                       "the mesh's largest shard launch"),
                      "bound_ms": shard_nfa_bound[0],
                      "bound_by": shard_nfa_bound[1]},
            "serving": {"launches": nfa_paths["serving_ring"],
                        "N": int(vX.shape[0]), "S": int(vbwd.shape[0]),
                        "W": int(vX.shape[1]),
                        "layout": knfa.layout(vX.shape[1]),
                        **check_and_time(errs, "nfa_step",
                                         knfa.nfa_step_cuda,
                                         ref.nfa_step_ref, (vX, vbwd),
                                         "the serving ring's largest "
                                         "launch"),
                        "bound_ms": serve_nfa_bound[0],
                        "bound_by": serve_nfa_bound[1]},
            "examples": {"launches": nfa_paths["examples"],
                         "N": int(eX.shape[0]), "S": int(ebwd.shape[0]),
                         "W": int(eX.shape[1]),
                         "layout": knfa.layout(eX.shape[1]),
                         **check_and_time(errs, "nfa_step",
                                          knfa.nfa_step_cuda,
                                          ref.nfa_step_ref, (eX, ebwd),
                                          "the examples' largest launch"),
                         "bound_ms": examples_nfa_bound[0],
                         "bound_by": examples_nfa_bound[1]}},
        "packed_superstep": {
            "launches_by_path": superstep_paths,
            "rows": {k: rows[k] for k in ("R", "S", "live_rows", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "max_abs_err", "edge_pass_bound_ms",
                                          "design_bytes_ms", "parent_ms",
                                          "turns_ms") if k in rows},
            "dense": {"launches": superstep_paths["dense"], **dense_shape,
                      **superstep_check_and_time(
                          errs, dense_args, "the dense path's heaviest "
                          "launch")},
            "shard": {"launches": superstep_paths["mesh"], **shard_shape,
                      **superstep_check_and_time(
                          errs, shard_args, "the mesh's heaviest shard "
                          "launch", gathered=gathered)},
            "bfs": {"launches": superstep_paths["bfs"],
                    **capture["bfs_superstep"]},
            "examples": {"launches": superstep_paths["examples"],
                         **example_point("examples_superstep",
                                         "the examples' heaviest launch"),
                         "rows": example_point(
                             "examples_rows_superstep", "the examples' "
                             "heaviest launch of source_batch rows")}}}
    out = []
    for name, (measure, (b, by), shape) in timed.items():
        times = measure()
        source, replaces = KERNEL_SOURCES[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            **times, "max_abs_err": max(errs[name]),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": shape, **extra.get(name, {}),
            "audit": {"launches": audit.get(name, 0),
                      "where": "phase 14's trace audit (T001 at the JAX "
                               "package's shapes, T002/T004/T005 on 4 x "
                               "the card)"}})
    return {"kernels": out}


def main() -> int:
    global PARENT
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR", help=(
        "a checkout of the parent commit (e.g. unpacked with git archive "
        "into .proof_tree/parent): its own ops.packed_superstep, ops.rank1, "
        "ops.build_rank_directory, ops.segment_or and "
        "ops.segmented_or_scan are loaded, their kernels built, and each "
        "timed in turns with this tree's at every superstep, rank and "
        "segment timing point"))
    opts = ap.parse_args()
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
    # phase 10 (c) runs under deterministic algorithms, which need a fixed
    # cuBLAS workspace before the first cuBLAS call (no earlier phase
    # makes one)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    selection = select_beside()
    if opts.parent is not None:
        PARENT = ParentSuperstep(opts.parent)
    phase_device()
    errs: dict = {}
    capture: dict = {}
    phase_kernels(errs, capture)
    t0 = time.perf_counter()
    sizes, seed = MAIN_GRAPH
    graph = fixtures.scale_free_graph(*sizes, seed=seed)
    graph_s = time.perf_counter() - t0
    engine, queries, answers, skipped, report = run_main_path(
        graph, "cuda", BATCH_DEADLINE_S, selection, capture)
    torch.cuda.synchronize()
    emit({"phase": "main_path", "graph_s": graph_s, **report})
    if report["kernel_launches"] <= 0:
        fail("the main path launched no nfa_step kernel")
    from repro_torch.serve import live_adds     # the serving phases' edges
    adds = live_adds(graph.num_nodes, graph.num_preds)
    emit(phase_serving(engine.ring, queries, answers, adds))
    emit(phase_oracle("cuda"))
    hub_answers: list = []
    packed = phase_packed(graph, queries, answers, skipped, errs, capture,
                          hub_answers)
    emit(packed)
    rank = phase_rank(engine.ring, capture)
    emit(rank)
    dense, dense_engine, stats_s = phase_dense(graph, queries, answers,
                                               skipped, hub_answers, adds,
                                               capture)
    emit(dense)
    mesh = phase_mesh(graph, engine.ring, dense_engine.graph_stats, stats_s,
                      queries, answers, skipped, hub_answers, dense_engine,
                      capture)
    emit(mesh)
    front = phase_serving_front(
        graph, engine.ring, dense_engine.graph_stats,
        report["selection"]["tried"], queries, answers, skipped,
        hub_answers, capture)
    del hub_answers, dense_engine
    emit(front)
    full_checkpoint = phase_lm(smi_line())
    phase_families(smi_line())
    phase_lm_mesh(smi_line())
    join_full_checkpoint(full_checkpoint)
    bfs = phase_dry_run(smi_line(), errs, capture)
    audit = phase_analysis(smi_line())
    emit(audit)
    examples = phase_examples(smi_line(), capture)
    emit(examples)
    served = {k: front[k]["kernel_launches"] for k in ("ring", "dense",
                                                       "mesh")}
    paths = {"packed": packed["kernel_launches"]["packed_superstep"],
             "dense": dense["kernel_launches"]["packed_superstep"],
             "mesh": mesh["kernel_launches"]["packed_superstep"],
             "serving_dense": served["dense"]["packed_superstep"],
             "serving_mesh": served["mesh"]["packed_superstep"],
             "bfs": bfs["packed_superstep"],
             "examples": examples["kernel_launches"]["packed_superstep"]}
    nfa_paths = {"ring": report["kernel_launches"],
                 "mesh": mesh["kernel_launches"]["nfa_step"],
                 "serving_ring": served["ring"]["nfa_step"],
                 "examples": examples["kernel_launches"]["nfa_step"]}
    kernels = kernels_line(capture, {
        "nfa_step": sum(nfa_paths.values()),
        "packed_superstep": sum(paths.values()),
        "segment_or": packed["kernel_launches"]["segment_or"] +
        dense["kernel_launches"]["segment_or"] +
        mesh["kernel_launches"]["segment_or"] +
        sum(v["segment_or"] for v in served.values()),
        **rank["kernel_launches"]}, errs, paths, nfa_paths,
        audit["kernel_launches"])
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit(kernels)                      # the line before the last
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
