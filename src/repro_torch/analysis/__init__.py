"""Static invariant analyzer for the port: trace audit + lint + semantic
dataflow, the counterpart of the JAX package's ``repro.analysis``.

Three layers (run all with ``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.trace_audit` (layer 1) runs the hot entry
  points on small inputs under a ``TorchDispatchMode`` that sees every
  aten op, on the CPU or the card (dtype contracts, host round-trips,
  pow2 padding, retrace budgets, collective bytes) — rules T001–T006,
  with a content-hash-keyed result cache so unchanged entry points skip
  re-running.
* :mod:`repro_torch.analysis.lint` (layer 2) walks the port's ASTs for
  determinism and dispatch-contract violations ordinary linters cannot
  see — rules R001–R007.
* :mod:`repro_torch.analysis.semantic` (layer 3) runs intraprocedural
  dataflow/effect analysis: epoch/COW snapshot consistency over the
  serving stack (C001–C006, :mod:`repro_torch.analysis.consistency`)
  and symbolic bounds/overflow proofs over the bit-parallel packing
  arithmetic (B001–B004, :mod:`repro_torch.analysis.bounds`).

Findings are gated against the checked-in ``baseline.json`` allowlist
and exportable as SARIF; see :mod:`repro_torch.analysis.findings`.

This module deliberately does NOT import the torch-heavy trace-audit
layer at package-import time, so ``from repro_torch.analysis import
lint`` stays cheap inside editors and pre-commit hooks — and the
lint/semantic layers run identically under minimal installs.
"""
from .findings import (Finding, filter_new, load_baseline, to_sarif,
                       update_baseline, write_baseline)
from .lint import DEFAULT_LINT_DIRS, lint_file, run_lint
from .semantic import SEMANTIC_DIRS, analyze_file, run_semantic

__all__ = [
    "DEFAULT_LINT_DIRS",
    "Finding",
    "SEMANTIC_DIRS",
    "analyze_file",
    "filter_new",
    "lint_file",
    "load_baseline",
    "run_lint",
    "run_semantic",
    "to_sarif",
    "update_baseline",
    "write_baseline",
]
