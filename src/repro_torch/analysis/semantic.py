"""Layer 3: semantic consistency + bounds analysis, over the
port's own tree.

Runs the C-rules (:mod:`consistency`) and B-rules (:mod:`bounds`) over
the same directory set the lint layer gates, wired into the shared
findings/baseline/noqa machinery.  Pure-AST — no torch import — so it
runs identically under the full and minimal dependency sets.

Besides findings, the layer emits *proof notes*: B001 does not only
fail on overflow, it reports how much int64 headroom the packed-key
arithmetic has left under the declared dictionary bounds and the |V| at
which the proof would break (the binding constraint).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import dataflow as df
from .bounds import (analyze_packing, rule_b002, rule_b003, rule_b004,
                     word_shifts)
from .consistency import C_RULES
from .findings import Finding
from .lint import DEFAULT_LINT_DIRS, source_files

# Same scope as the lint gate: core + kernels + the analyzer itself +
# obs + launch + the serving front (tests stay exempt — they poke
# internals by design).
SEMANTIC_DIRS = DEFAULT_LINT_DIRS

_B_RULES = (rule_b002, rule_b003, rule_b004)  # B001 runs via packing


def analyze_file(path: Path, rel: str) -> List[Finding]:
    findings, _ = _analyze_file(path, rel)
    return findings


def _analyze_file(path: Path, rel: str, shifts: Optional[List] = None
                  ) -> Tuple[List[Finding], List[Dict]]:
    source = path.read_text()
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(rel, exc.lineno or 0, "C000",
                        f"file does not parse: {exc.msg}", "",
                        f"syntax-error:{exc.msg}")], []
    df.attach_parents(tree)
    lines = source.splitlines()
    raw: List[Finding] = []
    for rule in C_RULES:
        raw.extend(rule(tree, rel, lines))
    if shifts is not None:
        shifts.extend((rel, n.lineno) for n in word_shifts(tree, rel))
    b001, sites = analyze_packing(tree, rel, lines)
    raw.extend(b001)
    for rule in _B_RULES:
        raw.extend(rule(tree, rel, lines))
    out = [f for f in sorted(raw, key=lambda f: (f.line, f.rule, f.message))
           if f.rule not in df.noqa_rules(lines, f.line)]
    return out, sites


def run_semantic(root: Path, dirs: Optional[Sequence[str]] = None
                 ) -> Tuple[List[Finding], List[str]]:
    """Analyze every ``*.py`` under ``dirs`` (repo-relative; defaults
    to :data:`SEMANTIC_DIRS`).  Returns (findings, proof notes)."""
    root = Path(root)
    if dirs is None:
        dirs = SEMANTIC_DIRS
    findings: List[Finding] = []
    sites: List[Dict] = []
    shifts: List[Tuple[str, int]] = []
    files = 0
    for path in source_files(root, dirs):
        rel = path.relative_to(root).as_posix()
        f, s = _analyze_file(path, rel, shifts)
        findings.extend(f)
        sites.extend(s)
        files += 1
    notes = [f"semantic layer analyzed {files} file(s); "
             f"{len(sites)} packed-key site(s) proven within int64",
             f"B002/B004 read {len(shifts)} shift(s) on words in "
             f"{len({r for r, _ in shifts})} word file(s)"]
    if sites:
        tight = max(sites, key=lambda s: s["hi"])
        note = (f"B001 tightest packing site {tight['file']}:"
                f"{tight['line']} uses {tight['headroom_pct']:.1f}% of "
                "int64 headroom under |V|<=2^26, P2<=2^10")
        if tight["binding"]:
            note += f"; {tight['binding']}"
        notes.append(note)
    return findings, notes
