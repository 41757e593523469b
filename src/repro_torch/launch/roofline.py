"""Roofline over the port's dry-run artifacts: the JAX package's
``launch/roofline.py`` (its "deliverable g") with an H100's figures.

Three terms a (arch x shape x mesh) cell, in seconds a step, from the
record ``launch/dryrun.py`` wrote (a device's FLOPs, bytes and
collective wire bytes):

    compute    = FLOPs a device / 989e12      (bf16 dense peak)
    memory     = bytes a device / 3.35e12     (HBM3)
    collective = wire bytes a device / 50e9   (one 400 Gb/s network
                 port a card: the conservative link a 16-wide axis
                 crosses between hosts of 8)

The figures are NVIDIA's data sheet for the H100 SXM5 80GB HBM3 at
700 W; none is measured here.  A second collective column puts the
traffic on NVLink (450e9 B/s each way), the link inside a host of 8.
MODEL_FLOPS is 6·N·D for a train step and 2·N·D otherwise (the true,
unpadded config; active parameters for the MoE), and MODEL/counted
exposes what the eager port computes beyond the model (replicated
attention, padded heads and experts, the rematerialised forward, the
optimizer).  The bytes are the eager port's unfused traffic, op by op,
so the memory term is what the port moves, not what a fused step
would.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--art artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, H100 SXM5
HBM_BW = 3.35e12         # B/s, HBM3
NET_BW = 50e9            # B/s: one 400 Gb/s port a card
NVLINK_BW = 450e9        # B/s each way, NVLink 4 within a host
DEVICE = "NVIDIA H100 80GB HBM3, 700 W (data sheet)"


def model_flops_per_device(arch: str, shape_name: str,
                           num_devices: int) -> float:
    from ..configs import SHAPES, get_config
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    N = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * N * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * N * shape.global_batch * shape.seq_len
    else:  # decode: one token a sequence
        total = 2.0 * N * shape.global_batch
    return total / num_devices


def analyse_artifact(rec: dict) -> Optional[dict]:
    if rec.get("skipped") or not rec.get("ok"):
        return None
    est = rec["est"]
    flops = est["flops_per_device"]
    bts = est["bytes_per_device"]
    wire = est["collective_wire_bytes_per_device"]
    t_c, t_m, t_x = flops / PEAK_FLOPS, bts / HBM_BW, wire / NET_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    row = {"arch": rec["arch"], "shape": rec["shape"],
           "mesh": "2x16x16" if rec.get("multi_pod") else "16x16",
           "devices": rec["num_devices"],
           "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
           "t_collective_nvlink_s": wire / NVLINK_BW, "dominant": dom,
           "counted_flops_per_dev": flops, "collective_bytes": wire,
           "resident_bytes": rec["resident_bytes_per_device"],
           "saved_bytes": rec["saved_bytes_per_device"],
           "fits_h100": rec["fits_h100"]}
    if rec["arch"] == "ring-rpq":
        row.update({"model_flops_per_dev": None, "model_over_counted": None,
                    "roofline_fraction": None})
        return row
    mf = model_flops_per_device(rec["arch"], rec["shape"],
                                rec["num_devices"])
    bound = max(t_c, t_m, t_x)
    row.update({"model_flops_per_dev": mf,
                "model_over_counted": mf / flops if flops > 0
                else float("nan"),
                # useful model FLOPs against what the card could do in
                # the bound time
                "roofline_fraction": (mf / PEAK_FLOPS) / bound if bound > 0
                else float("nan")})
    return row


def suggest(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if (row["model_over_counted"] or 1.0) < 0.6:
            return ("compute-bound with low MODEL/counted: cut replicated "
                    "attention, padded heads and experts, remat recompute")
        return "compute-bound near the model's own FLOPs"
    if d == "memory":
        return ("memory-bound: the eager port's unfused traffic; fuse "
                "elementwise chains, larger per-device batch")
    return ("collective-bound: overlap or shrink traffic (reduce-scatter "
            "instead of all-reduce, bf16 gradients, NVLink placement)")


def load_rows(art_dir: str) -> List[dict]:
    rows = []
    for p in sorted(Path(art_dir).glob("*.json")):
        row = analyse_artifact(json.loads(p.read_text()))
        if row:
            rows.append(row)
    return rows


def _f(x, fmt):
    return "n/a" if x is None else format(x, fmt)


def to_markdown(rows: List[dict]) -> str:
    """One row a cell: a device's resident and saved GB, counted TFLOP
    and collective GB, the three terms' seconds (the collective on the
    network port; NVLink's beside it), the dominant term, MODEL/counted
    and whether resident + saved fits 80 GB."""
    hdr = ("| arch | shape | mesh | resident GB | saved GB | TFLOP | "
           "collective GB | compute s | memory s | collective s (network; "
           "NVLink) | dominant | MODEL/counted | fits |\n|"
           + "---|" * 13 + "\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['resident_bytes'] / 1e9:.3f} | {r['saved_bytes'] / 1e9:.3f} "
            f"| {r['counted_flops_per_dev'] / 1e12:.2f} | "
            f"{r['collective_bytes'] / 1e9:.3f} | "
            f"{r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | "
            f"{r['t_collective_s']:.3e}; {r['t_collective_nvlink_s']:.3e} "
            f"| {r['dominant']} | {_f(r['model_over_counted'], '.3f')} | "
            f"{'yes' if r['fits_h100'] else 'no'} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--art", default="artifacts/dryrun_torch")
    ap.add_argument("--out", default="artifacts/roofline_torch")
    args = ap.parse_args(argv)
    rows = load_rows(args.art)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "roofline.json").write_text(json.dumps(rows, indent=1))
    md = to_markdown(rows)
    (out / "roofline.md").write_text(md)
    print(f"figures: {DEVICE}: {PEAK_FLOPS:.3e} bf16 FLOP/s, "
          f"{HBM_BW:.3e} B/s HBM, {NET_BW:.3e} B/s network a card, "
          f"{NVLINK_BW:.3e} B/s NVLink")
    print(md)
    ranked = sorted((r for r in rows if r["roofline_fraction"] is not None),
                    key=lambda r: r["roofline_fraction"])[:5]
    print("\nworst roofline fractions:")
    for r in ranked:
        print(f"  {r['arch']} {r['shape']} {r['mesh']}: "
              f"frac={r['roofline_fraction']:.3f} dom={r['dominant']} -> "
              f"{suggest(r)}")
    print(json.dumps({"rows": len(rows), "dominant": {
        d: sum(1 for r in rows if r["dominant"] == d)
        for d in ("compute", "memory", "collective")}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
