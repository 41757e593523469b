"""Finding model, report rendering, SARIF export, and the baseline
allowlist.

A :class:`Finding` is one analyzer hit: ``file:line``, a rule id
(``R00x`` for the AST lint layer, ``T00x`` for the lowering-time trace
audit, ``C00x``/``B00x`` for the semantic consistency/bounds layer), a
message, and a fix hint.  Findings are *fingerprinted* by
``(file, rule, hash of the stripped source snippet)`` — deliberately not
by line number, so unrelated edits that shift a pre-existing finding
down the file do not make it look new.

The baseline file is a checked-in JSON allowlist of fingerprints: the CI
gate fails only on findings whose fingerprint is not baselined, so
pre-existing debt can be grandfathered per-entry (each entry carries a
justification) while every NEW violation still fails the build.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Set, Tuple


@dataclass(frozen=True)
class Finding:
    """One analyzer hit.  ``snippet`` is the stripped source line (or a
    stable descriptor for trace-audit findings) — the fingerprint input."""

    file: str           # repo-relative posix path
    line: int           # 1-based; 0 = whole-file / non-source finding
    rule: str           # R00x lint, T00x trace, C00x/B00x semantic
    message: str
    hint: str = ""
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        digest = hashlib.sha256(self.snippet.strip().encode()).hexdigest()
        return f"{self.file}:{self.rule}:{digest[:16]}"

    def render(self) -> str:
        out = f"{self.file}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def load_baseline(path: Path) -> Set[str]:
    """Fingerprints allowlisted by the checked-in baseline (empty set
    when the file is absent — absence means 'nothing grandfathered')."""
    path = Path(path)
    if not path.exists():
        return set()
    doc = json.loads(path.read_text())
    return {entry["fingerprint"] for entry in doc.get("findings", [])}


def write_baseline(path: Path, findings: Sequence[Finding],
                   justification: str = "grandfathered pre-existing finding"
                   ) -> None:
    """Regenerate the baseline from the current finding set.  Every entry
    records the finding it allowlists plus a justification placeholder —
    review and edit the justifications before committing."""
    doc = {
        "comment": "Allowlisted pre-existing findings; the gate fails "
                   "only on fingerprints not in this file.  Regenerate "
                   "with `python -m repro_torch.analysis --write-baseline`.",
        "findings": [
            {
                "fingerprint": f.fingerprint,
                "file": f.file,
                "rule": f.rule,
                "message": f.message,
                "justification": justification,
            }
            for f in sorted(findings, key=lambda f: (f.file, f.rule, f.line))
        ],
    }
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def update_baseline(path: Path, findings: Sequence[Finding],
                    justification: str = "grandfathered pre-existing "
                                         "finding"
                    ) -> Tuple[int, int, int]:
    """Rewrite the baseline from the current finding set, *preserving*
    the justification of every entry that still fires and *pruning*
    fingerprints no findings match anymore (stale entries otherwise
    accumulate silently as the code they allowlisted gets fixed).

    Returns ``(kept, added, pruned)`` entry counts.
    """
    path = Path(path)
    existing: Dict[str, str] = {}
    if path.exists():
        doc = json.loads(path.read_text())
        existing = {e["fingerprint"]: e.get("justification", justification)
                    for e in doc.get("findings", [])}
    current: Dict[str, Finding] = {}
    for f in sorted(findings, key=lambda f: (f.file, f.rule, f.line)):
        current.setdefault(f.fingerprint, f)
    kept = sum(1 for fp in current if fp in existing)
    added = len(current) - kept
    pruned = sum(1 for fp in existing if fp not in current)
    doc = {
        "comment": "Allowlisted pre-existing findings; the gate fails "
                   "only on fingerprints not in this file.  Refresh "
                   "with `python -m repro_torch.analysis --update-baseline` "
                   "(prunes stale entries, keeps justifications).",
        "findings": [
            {
                "fingerprint": fp,
                "file": f.file,
                "rule": f.rule,
                "message": f.message,
                "justification": existing.get(fp, justification),
            }
            for fp, f in current.items()
        ],
    }
    path.write_text(json.dumps(doc, indent=1) + "\n")
    return kept, added, pruned


def filter_new(findings: Iterable[Finding],
               baseline: Set[str]) -> List[Finding]:
    """Findings not covered by the baseline — what the gate fails on."""
    return [f for f in findings if f.fingerprint not in baseline]


def to_json(findings: Sequence[Finding]) -> List[Dict]:
    return [dict(asdict(f), fingerprint=f.fingerprint) for f in findings]


SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings: Sequence[Finding],
             tool_version: str = "0") -> Dict:
    """SARIF 2.1.0 log of ``findings`` — one run, one result per
    finding, fingerprinted with the analyzer's own stable fingerprint
    so GitHub code scanning tracks findings across line drift the same
    way the baseline does."""
    ordered = sorted(findings, key=lambda f: (f.file, f.line, f.rule))
    rules = sorted({f.rule for f in ordered})
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "repro_torch-analysis",
                    "version": tool_version,
                    "rules": [{"id": r,
                               "shortDescription": {"text": r}}
                              for r in rules],
                },
            },
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message + (
                    f"\nhint: {f.hint}" if f.hint else "")},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.file},
                        "region": {"startLine": max(f.line, 1)},
                    },
                }],
                "partialFingerprints": {
                    "reproAnalysis/v1": f.fingerprint,
                },
            } for f in ordered],
        }],
    }


def render_report(findings: Sequence[Finding],
                  baselined: int = 0,
                  notes: Sequence[str] = ()) -> str:
    lines: List[str] = []
    for note in notes:
        lines.append(f"note: {note}")
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        lines.append(f.render())
    if baselined:
        lines.append(f"({baselined} pre-existing finding(s) allowlisted "
                     "by the baseline)")
    if findings:
        lines.append(f"FAIL: {len(findings)} new finding(s)")
    else:
        lines.append("OK: no new findings")
    return "\n".join(lines)
