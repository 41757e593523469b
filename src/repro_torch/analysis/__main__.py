"""CLI for the port's static invariant analyzer.

    python -m repro_torch.analysis                  # all layers, on the card
    python -m repro_torch.analysis --layer lint     # AST rules only (no torch)
    python -m repro_torch.analysis --layer semantic # dataflow C/B rules only
    python -m repro_torch.analysis --layer trace    # run-time audit only
    python -m repro_torch.analysis --device cpu --mesh-devices 4
    python -m repro_torch.analysis --json out.json --sarif out.sarif
    python -m repro_torch.analysis --update-baseline

``--lint``/``--trace``/``--all`` are kept as aliases of ``--layer``.
Exit status 0 iff no finding survives the baseline filter — this is the
CI gate.  The trace layer runs on ``--device`` (default ``cuda``, which
raises without a card; the tests pass ``cpu``) over a mesh of
``--mesh-devices`` devices (``cuda:0 .. N-1``, the visible cards in turn,
so one card stands for N; or N repeats of the host);
it imports torch, which is why its import happens inside ``main``.  The
lint and semantic layers need no device and are pure-AST: they behave
identically under the full and minimal dependency sets.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .findings import (Finding, filter_new, load_baseline, render_report,
                       to_json, to_sarif, update_baseline, write_baseline)
from .lint import run_lint
from .semantic import run_semantic

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
LAYERS = ("lint", "semantic", "trace")


def _find_root(start: Path) -> Path:
    """Repo root = nearest ancestor holding src/repro_torch (falls back
    to cwd, which run_lint tolerates: missing dirs are skipped)."""
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="run-time trace audit + repo lint + semantic "
                    "dataflow gate, over the port")
    ap.add_argument("--layer", action="append", choices=(*LAYERS, "all"),
                    metavar="{lint,semantic,trace,all}",
                    help="layer(s) to run (repeatable; default: all)")
    ap.add_argument("--lint", action="store_true",
                    help="alias for --layer lint (R001-R006)")
    ap.add_argument("--trace", action="store_true",
                    help="alias for --layer trace (T001-T006)")
    ap.add_argument("--all", action="store_true",
                    help="alias for --layer all (default when no layer "
                         "is given)")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help="baseline allowlist JSON (default: the checked-in "
                         "src/repro_torch/analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from the current finding "
                         "set and exit 0")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings, "
                         "keeping justifications of entries that still "
                         "fire and PRUNING stale fingerprints; prints the "
                         "pruned count and exits 0")
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="also write the full finding list as JSON (with "
                         "the trace layer's per-check results and T005 "
                         "numbers under 'trace')")
    ap.add_argument("--sarif", type=Path, default=None, metavar="PATH",
                    help="also write post-baseline findings as SARIF 2.1.0 "
                         "(GitHub code-scanning annotations)")
    ap.add_argument("--no-trace-cache", action="store_true",
                    help="bypass the trace-audit result cache (always "
                         "re-run)")
    ap.add_argument("--device", default="cuda",
                    help="device the trace layer runs on (default: cuda, "
                         "which raises without a card; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--mesh-devices", type=int, default=0, metavar="N",
                    help="mesh of N devices for the sharded checks "
                         "(cuda:0..N-1 over the visible cards in turn, "
                         "or N repeats of the host); with fewer than 2, "
                         "T005 is a skip note")
    args = ap.parse_args(argv)

    layers = set(args.layer or ())
    if args.lint:
        layers.add("lint")
    if args.trace:
        layers.add("trace")
    if args.all or "all" in layers or not layers:
        layers = set(LAYERS)
    root = args.root or _find_root(Path.cwd())

    findings: list[Finding] = []
    notes: list[str] = []
    trace = None      # the trace layer's report, when it runs
    if "lint" in layers:
        findings += run_lint(root)
    if "semantic" in layers:
        s_findings, s_notes = run_semantic(root)
        findings += s_findings
        notes += s_notes
    if "trace" in layers:
        from .trace_audit import run_trace_audit  # torch import lives here
        t_findings, t_notes, trace = run_trace_audit(
            root, use_cache=not args.no_trace_cache, device=args.device,
            mesh_devices=args.mesh_devices)
        findings += t_findings
        notes += t_notes

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"baseline written: {args.baseline} "
              f"({len(findings)} finding(s) allowlisted)")
        return 0
    if args.update_baseline:
        kept, added, pruned = update_baseline(args.baseline, findings)
        print(f"baseline updated: {args.baseline} ({kept} kept, "
              f"{added} added, {pruned} stale fingerprint(s) pruned)")
        return 0

    baseline = load_baseline(args.baseline)
    new = filter_new(findings, baseline)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "new": to_json(new),
            "baselined": len(findings) - len(new),
            "notes": notes,
            "trace": trace,
        }, indent=1) + "\n")
    if args.sarif:
        args.sarif.parent.mkdir(parents=True, exist_ok=True)
        args.sarif.write_text(json.dumps(to_sarif(new), indent=1) + "\n")
    print(render_report(new, baselined=len(findings) - len(new),
                        notes=notes))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
