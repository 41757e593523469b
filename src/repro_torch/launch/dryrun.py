"""Multi-pod dry run: the JAX package's ``launch/dryrun.py`` (its
"deliverable e") for the port.

For every (architecture x input shape x production mesh) cell it tells
what each device holds, computes and sends, with no allocation.  The
JAX package lowers and compiles each step and reads XLA's memory and
cost analyses; the port has no compiler to ask, so it runs its own eager
step on the meta device (shapes only) over the production mesh
(``launch/mesh.py`` ``make_production_mesh``) and reads:

  * **resident bytes a device**: the arguments (params, optimizer
    moments and step, batch, decode cache, tokens) laid out by the
    training or serving rules, exactly, at full depth, from the specs
    (``sharding.spec_bytes``);
  * **saved bytes a device**: what autograd keeps for the backward
    (``cost.count_saved``: saved tensors, and the inputs of each
    rematerialised layer);
  * **FLOPs, bytes and collective wire bytes a device**, by kind
    (``cost.CostMode``; the collectives with the transposes autograd
    runs for them);
  * the trace's seconds, and whether resident + saved fits the H100's
    80 GB.

A mesh runs every coordinate in turn on one host (``sharding.py``), so
a trace at full depth would take minutes a cell.  A cell is therefore
traced at one and two periods of its family's layer pattern (with the
embedding, head and loss each time) and extrapolated linearly to the
config's depth: exact when the layers of a period are identical (each
is its own ``nn.Module`` of the same shapes; the tests hold the
extrapolation to a full-depth trace).  The patterns: a layer (dense,
moe, vlm, ssm); a mamba layer and the hybrid's shared block apart; the
encoder and decoder layers apart (encdec).  ``--full-depth`` traces
the whole config instead.  The record names its method.

``ring-rpq`` (the paper's own workload, ``configs/ring_rpq.py``) is
worked out, not traced: its only device work is ``packed_superstep``, a
CUDA kernel with no meta implementation (:func:`lower_rpq`).

Artifacts go under ``artifacts/dryrun_torch/`` (the JAX package's own
sweep writes ``artifacts/dryrun/``).  ``launch/roofline.py`` reads them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--jobs 8]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import sharding as shd
from ..configs import ALL_ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ShapeSpec
from ..configs.ring_rpq import CONFIG as RPQ_CONFIG
from ..kernels import packed_superstep as ksup
from ..models import api
from ..models.layers import _chunk_mask
from ..train import optim
from ..train import step as tstep
from .cost import KINDS, CostMode, count_saved, wire_bytes
from .mesh import make_production_mesh

ART = "artifacts/dryrun_torch"
# NVIDIA H100 80GB HBM3: the card's memory, as its data sheet gives it
H100_MEMORY_BYTES = 80e9


def _dp_size(mesh) -> int:
    return shd.axes_size(mesh, shd.data_axes(mesh))


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(arch: str, shape_name) -> dict:
    """Meta tensors of every input of the cell's step, the reference's
    ``input_specs``: train ``{"state", "batch"}`` (f32 params and
    moments keyed by name, an int32 ``step``), prefill ``{"params",
    "batch"}`` and decode ``{"params", "cache", "tokens"}`` (bf16
    serving weights; one token against a ``seq_len + 8`` cache).  No
    allocation."""
    cfg = get_config(arch)
    shape = _shape(shape_name)
    if shape.kind == "train":
        return {"state": tstep.state_struct(cfg),
                "batch": api.batch_struct(cfg, shape)}
    params = api.param_struct(cfg, torch.bfloat16)
    if shape.kind == "prefill":
        return {"params": params, "batch": api.batch_struct(cfg, shape)}
    return {"params": params,
            "cache": api.cache_struct(cfg, shape.global_batch,
                                      shape.seq_len + 8),
            "tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                  device="meta")}


def _rules(cfg, shape, mesh, serving: bool):
    small = shape.global_batch < _dp_size(mesh)
    return shd.make_rules(mesh, cfg, small_batch=small, serving=serving), \
        small


def _tree_bytes(tree, specs, mesh) -> int:
    """Bytes one coordinate holds of the tensors of ``tree`` laid out by
    the matching ``specs`` (host ints, the cache's ``len``, hold none)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if not isinstance(tree, torch.Tensor):
        return 0
    return shd.spec_bytes(tree.shape, tree.dtype, specs, mesh)


def resident(arch: str, shape_name, mesh) -> Dict[str, int]:
    """Bytes a coordinate holds of each input of the cell's step, by
    part, and their ``total``: :func:`input_specs` at full depth laid out
    by the training rules (train) or the serving rules (prefill, decode),
    sanitized as the steps lay them out."""
    cfg = get_config(arch)
    shape = _shape(shape_name)
    specs = input_specs(arch, shape)
    rules, small = _rules(cfg, shape, mesh, serving=shape.kind != "train")
    ps = api.param_specs(cfg, rules)
    out: Dict[str, int] = {}
    if shape.kind == "train":
        st = specs["state"]
        out["params"] = _tree_bytes(st["params"], ps, mesh)
        out["opt_moments"] = _tree_bytes(
            {"mu": st["opt"]["mu"], "nu": st["opt"]["nu"]},
            {"mu": ps, "nu": ps}, mesh)
        out["opt_step"] = _tree_bytes(st["opt"]["step"], shd.spec(rules),
                                      mesh)
        out["batch"] = _tree_bytes(specs["batch"],
                                   api.batch_specs(cfg, rules), mesh)
    elif shape.kind == "prefill":
        out["params"] = _tree_bytes(specs["params"], ps, mesh)
        out["batch"] = _tree_bytes(specs["batch"],
                                   api.batch_specs(cfg, rules), mesh)
    else:
        out["params"] = _tree_bytes(specs["params"], ps, mesh)
        out["cache"] = _tree_bytes(specs["cache"],
                                   api.cache_specs(cfg, rules), mesh)
        tok = (None, None) if small else shd.spec(rules, "batch", None)
        out["tokens"] = _tree_bytes(specs["tokens"], tok, mesh)
    out["total"] = sum(out.values())
    return out


# -- tracing -------------------------------------------------------------------

def _laid_out(batch: dict, specs: dict, mesh) -> dict:
    return {k: shd.shard(t, mesh, shd.sanitize_spec(specs[k], t.shape, mesh))
            for k, t in batch.items()}


def _counters() -> Dict[str, int]:
    fwd, bwd = shd.collective_bytes(), shd.transposed_bytes()
    return {**{f"fwd_{k}": v for k, v in fwd.items()},
            **{f"bwd_{k}": v for k, v in bwd.items()}}


def trace_step(cfg, shape, mesh) -> Dict[str, float]:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (meta, or real
    devices for a comparison), traced once under :class:`CostMode`:
    sums over every coordinate of FLOPs, bytes, ops, saved bytes and
    collective bytes by kind (``fwd_*``: the forward calls, a
    rematerialised forward counted again; ``bwd_*``: autograd's
    transposes), and the trace's seconds.  Set-up (the state laid out)
    is not counted."""
    shape = _shape(shape)
    dev = shd.device(mesh, shd.coords(mesh)[0])
    serving = shape.kind != "train"
    rules, small = _rules(cfg, shape, mesh, serving)
    ctx = tstep._ctx(cfg, mesh, small, serving)
    B, T = shape.global_batch, shape.seq_len

    def on(tree):       # the batch on the mesh's device (zeros off meta)
        return {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                for k, v in tree.items()}

    if shape.kind == "train":
        state = tstep.init_state(cfg, 0, dev, mesh=mesh)
        fn = tstep.make_train_step(cfg, optim.AdamWConfig(), mesh=mesh,
                                   small_batch=small)
        args = (state, _laid_out(on(api.batch_struct(cfg, shape)),
                                 api.batch_specs(cfg, rules), mesh))
        keep = [t for sh in state["params"].values()
                for t in sh.parts.values()]
    else:
        params = api.shard_params(api.init_params(cfg, 0, dev), cfg, ctx,
                                  dtype=torch.bfloat16)
        keep = [t for sh in params.values() for t in sh.parts.values()]
        if shape.kind == "prefill":
            fn = tstep.make_prefill_step(cfg, T + 8, mesh=mesh,
                                         small_batch=small)
            args = (params, _laid_out(on(api.batch_struct(cfg, shape)),
                                      api.batch_specs(cfg, rules), mesh))
        else:
            fn = tstep.make_serve_step(cfg, mesh=mesh, small_batch=small)
            cache = api.init_cache(cfg, B, T + 8, dev, ctx=ctx)
            cache["len"] = T
            tok = (None, None) if small else shd.spec(rules, "batch", None)
            tokens = shd.shard(torch.zeros((B, 1), dtype=torch.int32,
                                           device=dev), mesh,
                               shd.sanitize_spec(tok, (B, 1), mesh))
            args = (params, cache, tokens)
    _chunk_mask.cache_clear()       # a warm mask cache would skip ops
    shd.reset_collective_bytes()
    mode = CostMode()
    t0 = time.perf_counter()
    with shd.counting_transposes(), count_saved(exclude=keep) as saved, \
            mode:
        fn(*args)
    seconds = time.perf_counter() - t0
    c = mode.counts
    return {"flops": c.flops, "dot_flops": c.dot_flops, "bytes": c.bytes,
            "ops": c.ops, "saved_bytes": saved["bytes"], **_counters(),
            "seconds": seconds}


def _pattern(cfg):
    """The traces of a cell and how they combine: ``(cuts, solve)``,
    ``cuts`` the config overrides of each trace and ``solve(results)``
    the full-depth sums (a linear combination of the traces with
    integer weights, exact for integers)."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        E = cfg.enc_layers
        cuts = [{"enc_layers": 1, "num_layers": 1},
                {"enc_layers": 2, "num_layers": 1},
                {"enc_layers": 1, "num_layers": 2}]
        # a = base + e + d, b = a + e, c = a + d
        w = [1 - (E - 1) - (L - 1), E - 1, L - 1]
        return cuts, w, (f"extrapolated: traced (encoder, decoder) layers "
                         f"(1, 1), (2, 1), (1, 2); full {E} + {L}")
    if cfg.family == "hybrid" and cfg.attn_period:
        k = cfg.attn_period
        G = L // k
        cuts = [{"num_layers": 1, "attn_period": 1},
                {"num_layers": 2, "attn_period": 1},
                {"num_layers": 2, "attn_period": 2}]
        # a = base + m + s, b = base + 2m + 2s, c = base + 2m + s; every
        # trace applies the shared block (its gradient accumulates from
        # the second application on): m = c - a, s = b - c, base = 2a - b,
        # and the full depth is base + L m + G s
        w = [2 - L, G - 1, L - G]
        return cuts, w, (f"extrapolated: traced (mamba layers, shared-block "
                         f"applications) (1, 1), (2, 2), (2, 1); full "
                         f"({L}, {G})")
    cuts = [{"num_layers": 1}, {"num_layers": 2}]
    return cuts, [2 - L, L - 1], (f"extrapolated: traced 1 and 2 layers; "
                                  f"full {L}")


def trace_cell(arch: str, shape, mesh, full_depth: bool = False,
               cfg=None) -> dict:
    """The cell's step traced (:func:`trace_step`) at one and two
    periods of its layer pattern and extrapolated to full depth, or
    traced once at ``full_depth``.  Returns the sums over the
    coordinates, the ``method`` and each trace's seconds."""
    cfg = cfg or get_config(arch)
    if full_depth:
        r = trace_step(cfg, shape, mesh)
        return {**r, "method": "full depth, one trace",
                "traces": [{"cut": {}, "seconds": r["seconds"]}],
                "trace_seconds": r["seconds"]}
    cuts, weights, method = _pattern(cfg)
    results = [trace_step(replace(cfg, **cut), shape, mesh) for cut in cuts]
    out = {k: sum(w * r[k] for w, r in zip(weights, results))
           for k in results[0] if k != "seconds"}
    out.update({"method": method, "traces": [
        {"cut": cut, "seconds": r["seconds"]}
        for cut, r in zip(cuts, results)],
        "trace_seconds": sum(r["seconds"] for r in results)})
    return out


def analyse(sums: dict, mesh) -> dict:
    """A device's share of a cell's sums (the coordinates run the same
    ops on the same shapes), collectives by the reference's kind names."""
    n = len(shd.coords(mesh))
    fwd = {KINDS[k]: sums[f"fwd_{k}"] / n for k in KINDS}
    bwd = {KINDS[k]: sums[f"bwd_{k}"] / n for k in KINDS}
    by_kind = {k: fwd[k] + bwd[k] for k in fwd}
    out = {
        "num_devices": n, "mesh": dict(mesh.shape),
        "method": sums["method"], "traces": sums["traces"],
        "trace_seconds": sums["trace_seconds"],
        "flops_per_device": sums["flops"] / n,
        "dot_flops_per_device": sums["dot_flops"] / n,
        "bytes_per_device": sums["bytes"] / n,
        "ops_per_device": sums["ops"] / n,
        "saved_bytes_per_device": sums["saved_bytes"] / n,
        "collectives": {
            "bytes_by_kind": by_kind,
            "forward_bytes_by_kind": fwd,
            "transposed_bytes_by_kind": bwd,
            "forward_bytes_all_coordinates": {
                k: sums[f"fwd_{k}"] for k in KINDS},
            "total_wire_bytes_per_device": sum(by_kind.values()),
            "rule": "ring model a device: all-reduce 2*size*(n-1)/n, "
                    "all-gather and reduce-scatter size*(n-1)/n; forward "
                    "calls (a rematerialised forward counted again) plus "
                    "autograd's transposes (an all-gather's is a "
                    "reduce-scatter, a reduce-scatter's an all-gather, a "
                    "sum all-reduce's an all-reduce), counted as the "
                    "backward reaches each output"},
    }
    # what launch/roofline.py reads, under the reference's names
    out["est"] = {"flops_per_device": out["flops_per_device"],
                  "bytes_per_device": out["bytes_per_device"],
                  "collective_wire_bytes_per_device":
                      out["collectives"]["total_wire_bytes_per_device"],
                  "collective_bytes_by_kind": by_kind}
    return out


# -- ring-rpq ------------------------------------------------------------------

def lower_rpq(mesh, tiles: Optional[int] = None,
              edges_kept: Optional[int] = None,
              gather_devices: Optional[int] = None) -> dict:
    """The paper's workload on ``mesh`` worked out from
    ``configs/ring_rpq.py`` (V = 2^25, E = 2^29, L = 1,024 labels, S =
    16, 8 supersteps; shards = the data axes): ``make_bfs`` as the JAX
    package's dry run lowers it, and as the port runs it.

    * ``reference_argument_bytes_per_device``: its int8 planes (frontier,
      visited) and edge arrays split over the data axes, B and PRED
      replicated (the JAX package's ``lower_rpq`` shardings);
    * ``port_working_set_per_shard``: ``packed_superstep.working_set_bytes``
      for a shard (``tiles``: its worklist's tiles, by default the most
      its edges can need, ``ceil(E_l / 32)`` plus one for each object
      holding edges, at most ``min(E_l, V_pad)``; ``edges_kept``: its
      edges off the inert label, by default all; either may be a list,
      one a shard, the largest then standing for a shard), and
      ``port_held_bytes_all_shards``: every shard's words, grouped
      edges and worklist, and the gathered frontier and tables once a
      device;
    * ``gather_bytes_per_superstep``: what ``shard_superstep`` counts,
      the gathered [1, V_pad, 1] words once a device (``gather_devices``,
      by default one a data shard), the port's all-gather of those
      words a device by the ring model (``port_wire_per_device``, the
      collective term of ``est``), and the reference's all-gather of
      its int8 planes a device (``reference_wire_per_device``);
    * ``kernel_bytes_per_superstep``: ``packed_superstep``'s edge-pass
      byte model, all live (every word and edge), a shard."""
    c = RPQ_CONFIG
    daxes = shd.data_axes(mesh)
    shards = shd.axes_size(mesh, daxes)
    Vl, El = c.num_nodes // shards, c.num_edges // shards
    Vp, S, L = Vl * shards, c.nfa_states, c.num_labels
    W = (S + 31) // 32
    def each(x, default):
        x = default if x is None else x
        return list(x) if isinstance(x, (list, tuple)) else [x] * shards

    kept = each(edges_kept, El)
    tiles = each(tiles, -(-El // ksup.TILE) + min(El, Vp))
    ref_args = {"planes": 2 * Vl * S, "edges": 3 * El * 4,
                "B": (L + 1) * S, "PRED": S * S}
    ref_args["total"] = sum(ref_args.values())
    per = [ksup.working_set_bytes(1, Vl, W, Vp, e, t, L + 1, S)
           for e, t in zip(kept, tiles)]
    ws = max(per, key=lambda w: w["total"])
    devices = shards if gather_devices is None else gather_devices
    held = sum(w["words"] + w["grouped_edges"] + w["scratch"] for w in per) \
        + devices * (ws["gathered"] + ws["tables"])
    wire = wire_bytes("all-gather", 4 * Vp * W, shards)
    kbytes, kops = ksup.edge_pass_cost_all_live(1, Vl, W, El, L + 1, S,
                                                Vg=Vp)
    return {
        "num_devices": len(shd.coords(mesh)), "mesh": dict(mesh.shape),
        "method": "worked out: configs/ring_rpq.py through the port's "
                  "byte models (packed_superstep has no meta "
                  "implementation to trace)",
        "config": {"num_nodes": c.num_nodes, "num_edges": c.num_edges,
                   "num_labels": L, "nfa_states": S,
                   "supersteps": c.supersteps, "shards": shards,
                   "data_axes": list(daxes), "nodes_per_shard": Vl,
                   "edges_per_shard": El, "worklist_tiles": tiles,
                   "edges_kept": kept},
        "reference_argument_bytes_per_device": ref_args,
        "port_working_set_per_shard": ws,
        "port_held_bytes_all_shards": held,
        "gather_bytes_per_superstep": {
            "port_all_devices": devices * 4 * Vp * W,
            "port_per_device": 4 * Vp * W,
            "port_wire_per_device": wire,
            "reference_wire_per_device": wire_bytes(
                "all-gather", Vp * S, shards)},
        "kernel_bytes_per_superstep_all_live": kbytes,
        "kernel_ops_per_superstep_all_live": kops,
        "resident_bytes_per_device": ws["total"],
        "resident_by_part": {"reference_arguments": ref_args["total"],
                             "port_working_set": ws["total"]},
        "saved_bytes_per_device": 0,
        "fits_h100": ws["total"] <= H100_MEMORY_BYTES,
        "trace_seconds": 0.0,
        "est": {"flops_per_device": kops * c.supersteps,
                "bytes_per_device": kbytes * c.supersteps,
                "collective_wire_bytes_per_device": c.supersteps * wire,
                "collective_bytes_by_kind": {
                    "all-gather": c.supersteps * wire}},
    }


# -- cells ---------------------------------------------------------------------

def _tag(arch, shape_name, multi_pod) -> str:
    return f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             verbose: bool = True, full_depth: bool = False) -> dict:
    """One cell's record, written to ``out_dir/<tag>.json`` (a cached
    record is read back instead).  A shape the reference skips is
    skipped with its reason; a failure is recorded, not raised."""
    tag = _tag(arch, shape_name, multi_pod)
    path = Path(out_dir) / f"{tag}.json"
    if path.exists():
        if verbose:
            print(f"[skip-cached] {tag}")
        return json.loads(path.read_text())
    cfg = get_config(arch) if arch != "ring-rpq" else None
    if cfg is not None:
        ok, why = shape_applicable(cfg, SHAPES[shape_name])
        if not ok:
            rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                   "skipped": why}
            path.write_text(json.dumps(rec, indent=1))
            if verbose:
                print(f"[skip] {tag}: {why}")
            return rec
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        if arch == "ring-rpq":
            rec = lower_rpq(mesh)
        else:
            rec = analyse(trace_cell(arch, shape_name, mesh, full_depth),
                          mesh)
            res = resident(arch, shape_name, mesh)
            rec.update({
                "kind": SHAPES[shape_name].kind,
                "small_batch": SHAPES[shape_name].global_batch
                < _dp_size(mesh),
                "resident_bytes_per_device": res["total"],
                "resident_by_part": res,
                "fits_h100": res["total"] + rec["saved_bytes_per_device"]
                <= H100_MEMORY_BYTES})
        rec.update({"arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "ok": True,
                    "memory_limit_bytes": H100_MEMORY_BYTES,
                    "total_seconds": time.perf_counter() - t0})
    except Exception as e:  # recorded: failures are bugs to fix
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    path.write_text(json.dumps(rec, indent=1))
    if verbose and rec.get("ok"):
        print(f"[ok] {tag}: trace {rec['trace_seconds']:.1f}s  "
              f"flops/dev {rec['est']['flops_per_device']:.3e}  "
              f"resident {rec['resident_bytes_per_device'] / 1e9:.2f}GB  "
              f"saved {rec['saved_bytes_per_device'] / 1e9:.2f}GB  "
              f"coll {rec['est']['collective_wire_bytes_per_device'] / 1e9:.2f}GB"
              f"  fits {rec['fits_h100']}", flush=True)
    return rec


def cells(both_meshes: bool, multi_pod: bool = False):
    for mp in ([False, True] if both_meshes else [multi_pod]):
        for a in ALL_ARCHS + ["ring-rpq"]:
            for s in (list(SHAPES) if a != "ring-rpq" else ["train_4k"]):
                yield a, s, mp


def _run_one(job):
    a, s, mp, out, full = job
    torch.set_num_threads(1)
    return run_cell(a, s, mp, Path(out), full_depth=full)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace the whole config, no extrapolation")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each (--all)")
    ap.add_argument("--out", type=str, default=ART)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.all:
        t0 = time.perf_counter()
        jobs = [(a, s, mp, str(out), args.full_depth)
                for a, s, mp in cells(args.both_meshes, args.multipod)]
        if args.jobs > 1:
            import multiprocessing as mp_
            with mp_.get_context("spawn").Pool(args.jobs) as pool:
                recs = pool.map(_run_one, jobs, chunksize=1)
        else:
            recs = [_run_one(j) for j in jobs]
        failed = [r for r in recs if not r.get("ok") and not r.get("skipped")]
        print(json.dumps({"cells": len(recs), "ok": sum(
            1 for r in recs if r.get("ok")), "skipped": sum(
            1 for r in recs if r.get("skipped")), "failed": len(failed),
            "wall_seconds": time.perf_counter() - t0}))
        return 1 if failed else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = run_cell(args.arch, args.shape, args.multipod, out,
                   full_depth=args.full_depth)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=1))
    return 0 if rec.get("ok") or rec.get("skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
