"""Tests for the port's static invariant analyzer
(``repro_torch.analysis``): the counterpart of ``tests/test_analysis.py``.

Per-rule positive/negative fixtures for the AST lint layer, each source
also given to the JAX package's analyzer, which must report the same
(rule, line, fingerprint); the port's translations (torch's host syncs
for R002, R003 over ``KERNELS``, ``msgpack`` for R004); the trace audit
(``audit_step`` on hand-built steps, the repo's checks on the CPU and on
a CPU mesh of four, each fired by a deliberate regression); the baseline
and noqa mechanics, and the repo-is-clean gate."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as jlint  # noqa: E402
from repro_torch.analysis import trace_audit as ta  # noqa: E402
from repro_torch.analysis.findings import (Finding, filter_new,  # noqa: E402
                                           load_baseline, write_baseline)
from repro_torch.analysis.lint import lint_file, run_lint  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}


def _port_rel(rel: str) -> str:
    return rel.replace("src/repro/", "src/repro_torch/", 1)


def _lint_source(tmp_path: Path, source: str, rel: str = "pkg/mod.py"):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(source))
    return lint_file(path, rel)


def _rules(findings):
    return sorted(f.rule for f in findings)


def _cli(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, timeout=timeout, env=ENV)


# ---------------------------------------------------------------------
# the JAX package's fixtures (rel paths in its tree), shared by the
# counterpart tests and the parity test
# ---------------------------------------------------------------------

R001_BAD = """\
    import numpy as np

    class Overlay:
        def __init__(self):
            self.tomb = set()
            self.by_pred = {}

        def bad_rows(self):
            rows = []
            for t in self.tomb:          # flagged: for-append over set
                rows.append(t)
            return rows

    def bad_comp():
        s = {3, 1, 2}
        return [x + 1 for x in s]        # flagged: list from set

    def bad_fromiter(s):
        keys = set(s)
        return np.fromiter((k for k in keys), dtype=np.int64)
    """

R001_OK = """\
    import numpy as np

    def ok_sorted(s):
        items = set(s)
        a = [x for x in sorted(items)]          # sorted first: ok
        b = np.fromiter((k for k in sorted(items)), dtype=np.int64)
        total = sum(x for x in items)           # order-free reduction
        return a, b, total, len(items)

    def ok_dict(d):
        # dict iteration is insertion-ordered — deterministic
        return [v for v in d], [d[k] for k in d]

    def ok_set_result(s):
        # building a SET from a set is order-free
        return {x + 1 for x in s}
    """

R001_DICT_OF_SET = """\
    from typing import Dict, Set, Tuple

    class Overlay:
        def __init__(self):
            self._tomb: Dict[int, Set[Tuple[int, int]]] = {}

        def bad(self, p):
            return [e for e in self._tomb.get(p, set())]

        def good(self, p):
            return sorted(self._tomb.get(p, set()))
    """

R002_BAD = """\
    import numpy as np

    def drive(step, frontier):
        it = 0
        while it < 64:
            frontier = step(frontier)
            alive = int(frontier.sum())      # flagged
            host = np.asarray(frontier)      # flagged
            it += 1
        return frontier
    """

R002_OK = """\
    import numpy as np

    def drive(step, frontier, max_steps):
        it = 0
        # the convergence check in the loop TEST is the designed sync
        while it < max_steps and bool((frontier > 0).any()):
            frontier = step(frontier)
            it += 1
        return frontier

    def host_only(values):
        # no step/chunk dispatch in the body: plain host loop, exempt
        total = 0
        while values:
            total += int(values.pop())
        return total
    """

R004_SHIM = """\
    try:
        import zstandard
    except ImportError:
        zstandard = None

    def _resolve():
        from jax.experimental.shard_map import shard_map
        return shard_map
    """

R005_BAD = """\
    def add_edges(engine, edges):
        engine.delta.apply(edges, [])    # flagged twice: .apply +
                                         # add_edges w/o router

    def sneak(ov):
        ov._insert_tomb(0, 1, 2)         # flagged
    """

R005_OK = """\
    from .delta import apply_engine_updates

    def add_edges(engine, edges):
        apply_engine_updates(engine, edges, [])
    """

R005_DELTA = """\
    def _fold(ov):
        ov._insert_tomb(0, 1, 2)
    """

R006_BAD = """\
    import time
    import time as _time

    def drive(stepper):
        t_total = 0.0
        while stepper.pending():
            t0 = time.perf_counter()       # flagged
            stepper.step()
            t_total += time.perf_counter() - t0   # flagged
            _time.monotonic()              # flagged (aliased module)
        return t_total
    """

R006_BENCH = """\
    import time

    def run_bench(stepper):
        while stepper.pending():
            t0 = time.perf_counter()
            stepper.step()
    """

R006_OK_CORE = """\
    import time
    from ..obs import trace as otrace

    def tick(self):
        while self.pending():
            now = self.clock()             # injectable clock: ok
            with otrace.span("scheduler.superstep"):
                self.slots.step()

    def summarize(events):
        t0 = time.perf_counter()           # outside any loop: ok
        n = 0
        while events:                      # no dispatch call in body
            events.pop()
            time.monotonic()
            n += 1
        return n, time.perf_counter() - t0
    """

R006_NOQA = """\
    import time

    def drive(stepper):
        while stepper.pending():
            t0 = time.monotonic()  # repro: noqa R006 — boot-time probe
            stepper.step()
    """

R007_BAD = """\
    def drive(self):
        while self.pending():
            self.step()
            self.counters["steps"] += 1
    """

NOQA_NAMED = """\
    def drive(step, x):
        while True:
            x = step(x)
            v = int(x)  # repro: noqa R002 — deadline sync by design
            w = int(x)  # repro: noqa R001 — wrong rule id
            if v + w:
                break
        return x
    """

LINT_CASES = {
    "r001_bad": (R001_BAD, "pkg/mod.py"),
    "r001_ok": (R001_OK, "pkg/mod.py"),
    "r001_dict_of_set": (R001_DICT_OF_SET, "pkg/mod.py"),
    "r002_bad": (R002_BAD, "pkg/mod.py"),
    "r002_ok": (R002_OK, "pkg/mod.py"),
    "r004_shim": (R004_SHIM, "pkg/mod.py"),
    "r005_bad": (R005_BAD, "pkg/mod.py"),
    "r005_ok": (R005_OK, "pkg/mod.py"),
    "r005_delta": (R005_DELTA, "src/repro/core/delta.py"),
    "r006_bad": (R006_BAD, "src/repro/core/mod.py"),
    "r006_bench": (R006_BENCH, "benchmarks/serving.py"),
    "r006_ok_core": (R006_OK_CORE, "src/repro/core/mod.py"),
    "r006_noqa": (R006_NOQA, "src/repro/core/mod.py"),
    "r007_bad": (R007_BAD, "src/repro/core/mod.py"),
    "noqa_named": (NOQA_NAMED, "pkg/mod.py"),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_agrees_with_reference(tmp_path, case):
    """The same source, at the same place in either package's tree,
    gives the same (rule, line, fingerprint) in both analyzers."""
    source, rel = LINT_CASES[case]
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(source))
    want = sorted((f.rule, f.line, f.fingerprint)
                  for f in jlint.lint_file(path, rel))
    got = sorted((f.rule, f.line, f.fingerprint.replace(
        "src/repro_torch/", "src/repro/", 1))
        for f in lint_file(path, _port_rel(rel)))
    assert got == want


# ---------------------------------------------------------------------
# R001: nondeterministic set iteration
# ---------------------------------------------------------------------

def test_r001_flags_order_sensitive_set_iteration(tmp_path):
    fs = _lint_source(tmp_path, R001_BAD)
    assert _rules(fs) == ["R001", "R001", "R001"]
    assert all("hash" in f.message or "order" in f.message for f in fs)
    assert all(f.line > 0 and f.hint for f in fs)


def test_r001_negatives_sorted_and_dict_iteration(tmp_path):
    assert _lint_source(tmp_path, R001_OK) == []


def test_r001_dict_of_set_attribute(tmp_path):
    fs = _lint_source(tmp_path, R001_DICT_OF_SET)
    assert _rules(fs) == ["R001"]
    assert fs[0].line == 8


# ---------------------------------------------------------------------
# R002: host sync inside superstep loops
# ---------------------------------------------------------------------

def test_r002_flags_host_sync_in_superstep_loop(tmp_path):
    fs = _lint_source(tmp_path, R002_BAD)
    assert _rules(fs) == ["R002", "R002"]
    assert {f.line for f in fs} == {7, 8}


def test_r002_loop_test_and_nondispatch_loops_exempt(tmp_path):
    assert _lint_source(tmp_path, R002_OK) == []


TORCH_SYNCS = {
    "item": "flag.item()",
    "tolist": "frontier.any(dim=1).tolist()",
    "cpu": "frontier.cpu()",
    "numpy": "frontier.numpy()",
    "cuda_synchronize": "torch.cuda.synchronize()",
    "event_synchronize": "done.synchronize()",
}


@pytest.mark.parametrize("kind", sorted(TORCH_SYNCS))
def test_r002_torch_host_syncs(tmp_path, kind):
    """Each of torch's host syncs in a dispatching loop's body is a
    finding; the same call in the loop's test, or in a loop that
    dispatches nothing, is not."""
    call = TORCH_SYNCS[kind]
    fs = _lint_source(tmp_path, f"""\
        import torch

        def drive(step, frontier, flag, done):
            while True:
                frontier = step(frontier)
                seen = {call}
                if seen is None:
                    break
            return frontier
        """)
    assert _rules(fs) == ["R002"] and fs[0].line == 6
    assert kind.split("_")[-1] in fs[0].message
    assert _lint_source(tmp_path, f"""\
        import torch

        def drive(step, frontier, flag, done):
            while {call} is not None:
                frontier = step(frontier)
            return frontier

        def host(frontier, flag, done):
            while frontier is not None:
                frontier = {call}
            return frontier
        """) == []


# ---------------------------------------------------------------------
# R003: kernel parity completeness over the port's KERNELS
# ---------------------------------------------------------------------

def _make_kernel_tree(root: Path):
    k = root / "src/repro_torch/kernels"
    k.mkdir(parents=True)
    (k / "__init__.py").write_text(
        'KERNEL_MODULES = {"foo": "foo"}\n'
        'KERNELS = tuple(KERNEL_MODULES)\n')
    (k / "ref.py").write_text("")
    t = root / "tests"
    t.mkdir()
    (t / "test_torch_kernels.py").write_text("")
    (t / "test_torch_cuda.py").write_text("")


def test_r003_missing_ref_then_cpu_test_then_card_test_then_clean(tmp_path):
    _make_kernel_tree(tmp_path)
    dirs = ["src/repro_torch/kernels"]
    fs = run_lint(tmp_path, dirs=dirs)
    assert _rules(fs) == ["R003"]
    assert "no plain version 'foo_ref'" in fs[0].message

    (tmp_path / "src/repro_torch/kernels/ref.py").write_text(
        "def foo_ref(x):\n    return x\n")
    fs = run_lint(tmp_path, dirs=dirs)
    assert _rules(fs) == ["R003"]
    assert "never referenced by tests/test_torch_kernels.py" in \
        fs[0].message

    (tmp_path / "tests/test_torch_kernels.py").write_text(
        "def test_foo():\n    from ref import foo_ref\n")
    fs = run_lint(tmp_path, dirs=dirs)
    assert _rules(fs) == ["R003"]
    assert "no card test in tests/test_torch_cuda.py" in fs[0].message

    (tmp_path / "tests/test_torch_cuda.py").write_text(
        "def test_foo_cuda():\n    from foo import foo_cuda\n")
    assert run_lint(tmp_path, dirs=dirs) == []


def test_r003_kernels_not_a_literal(tmp_path):
    _make_kernel_tree(tmp_path)
    (tmp_path / "src/repro_torch/kernels/__init__.py").write_text(
        "KERNELS = make_names()\n")
    fs = run_lint(tmp_path, dirs=["src/repro_torch/kernels"])
    assert _rules(fs) == ["R003"] and "KERNELS tuple missing" in \
        fs[0].message


def test_r003_repair_each_ref_is_named_by_the_cpu_suite(tmp_path):
    """R003 on the tree: every ``KERNELS`` entry's ``_ref`` is named by
    ``tests/test_torch_kernels.py`` (``segment_or_ref`` and
    ``packed_superstep_ref`` were not until their CPU tests were
    added); without those names the gate fires on both."""
    assert [f for f in run_lint(REPO_ROOT) if f.rule == "R003"] == []
    _make_kernel_tree(tmp_path)
    kernels = REPO_ROOT / "src/repro_torch/kernels"
    for name in ("__init__.py", "ref.py"):
        (tmp_path / "src/repro_torch/kernels" / name).write_text(
            (kernels / name).read_text())
    cpu = (REPO_ROOT / "tests/test_torch_kernels.py").read_text()
    for gone in ("segment_or_ref", "packed_superstep_ref"):
        cpu = cpu.replace(gone, "removed")
    (tmp_path / "tests/test_torch_kernels.py").write_text(cpu)
    (tmp_path / "tests/test_torch_cuda.py").write_text(
        (REPO_ROOT / "tests/test_torch_cuda.py").read_text())
    fs = run_lint(tmp_path, dirs=["src/repro_torch/kernels"])
    assert sorted(f.message.split("'")[1] for f in fs) == \
        ["packed_superstep", "segment_or"]


# ---------------------------------------------------------------------
# R004: optional-dep imports
# ---------------------------------------------------------------------

def test_r004_top_level_vs_shim(tmp_path):
    fs = _lint_source(tmp_path, """\
        import hypothesis
        from msgpack import packb
        """)
    assert _rules(fs) == ["R004", "R004"]
    assert _lint_source(tmp_path, R004_SHIM) == []


@pytest.mark.parametrize("where,flagged", [
    ("import msgpack\n", True),
    ("import msgpack.ext\n", True),
    ("try:\n    import msgpack\nexcept ImportError:\n    msgpack = None\n",
     False),
    ("def codec():\n    import msgpack\n    return msgpack\n", False),
    ("from jax.experimental.shard_map import shard_map\n", False),
])
def test_r004_msgpack_takes_shard_maps_place(tmp_path, where, flagged):
    """The port's optional import is ``msgpack`` (the GPU machine has
    none); it never imports ``jax.experimental.shard_map``."""
    fs = _lint_source(tmp_path, where)
    assert _rules(fs) == (["R004"] if flagged else [])


# ---------------------------------------------------------------------
# R005: engine mutations must route through the delta overlay
# ---------------------------------------------------------------------

def test_r005_overlay_bypass(tmp_path):
    assert _rules(_lint_source(tmp_path, R005_BAD)) == \
        ["R005", "R005", "R005"]


def test_r005_router_and_delta_module_exempt(tmp_path):
    assert _lint_source(tmp_path, R005_OK) == []
    assert _lint_source(tmp_path, R005_DELTA,
                        rel="src/repro_torch/core/delta.py") == []


# ---------------------------------------------------------------------
# R006: raw wall-clock reads inside superstep loops (core/ only)
# ---------------------------------------------------------------------

def test_r006_flags_raw_timing_in_core_superstep_loop(tmp_path):
    fs = _lint_source(tmp_path, R006_BAD, rel="src/repro_torch/core/mod.py")
    assert _rules(fs) == ["R006", "R006", "R006"]
    assert all("superstep loop" in f.message for f in fs)
    assert all("obs" in f.hint for f in fs)
    # the JAX package's core is not the port's
    assert _lint_source(tmp_path, R006_BAD,
                        rel="src/repro/core/mod.py") == []


def test_r006_negatives(tmp_path):
    assert _lint_source(tmp_path, R006_BENCH,
                        rel="src/repro_torch/launch/serve.py") == []
    assert _lint_source(tmp_path, R006_OK_CORE,
                        rel="src/repro_torch/core/mod.py") == []


def test_r006_noqa_suppresses(tmp_path):
    assert _lint_source(tmp_path, R006_NOQA,
                        rel="src/repro_torch/core/mod.py") == []


# ---------------------------------------------------------------------
# noqa + baseline mechanics
# ---------------------------------------------------------------------

def test_noqa_suppresses_only_named_rule(tmp_path):
    fs = _lint_source(tmp_path, NOQA_NAMED)
    assert _rules(fs) == ["R002"]
    assert fs[0].line == 5


def test_baseline_roundtrip_and_fingerprint_stability(tmp_path):
    old = Finding("a.py", 10, "R001", "msg", "hint", "for t in tomb:")
    drifted = Finding("a.py", 42, "R001", "msg", "hint", "for t in tomb:")
    fresh = Finding("a.py", 11, "R002", "msg2", "hint", "int(x)")
    path = tmp_path / "baseline.json"
    write_baseline(path, [old])
    baseline = load_baseline(path)
    # line drift does not un-baseline a finding; new findings survive
    assert filter_new([drifted, fresh], baseline) == [fresh]
    doc = json.loads(path.read_text())
    assert doc["findings"][0]["justification"]
    assert load_baseline(tmp_path / "absent.json") == set()


# ---------------------------------------------------------------------
# trace audit: audit_step on hand-built steps
# ---------------------------------------------------------------------

def _words(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def test_audit_step_clean_step():
    def good_step(x, bwd):
        return x | bwd[0]

    fs = ta.audit_step(good_step, (_words(8, 2), _words(4, 2)),
                       label="good", file="x.py",
                       expect_out_dtypes=[torch.int32], device="cpu")
    assert fs == []


def test_audit_step_catches_dtype_break():
    def wide_step(x):
        return ((x.to(torch.int64) & 0xFFFFFFFF) << 1) & 0xFFFFFFFF

    fs = ta.audit_step(wide_step, (_words(8, 2),), label="bad",
                       file="x.py", expect_out_dtypes=[torch.int32],
                       device="cpu")
    assert _rules(fs) == ["T001"]
    assert "int64" in fs[0].message


def test_audit_step_catches_host_read():
    def chatty_step(x):
        if x.sum().item() == 0:          # a host read per superstep
            x = x | 1
        return x

    fs = ta.audit_step(chatty_step, (_words(8),), label="chatty",
                       file="x.py", device="cpu")
    assert _rules(fs) == ["T002"]
    assert "_local_scalar_dense" in fs[0].message
    assert "test_torch_analysis.py" in fs[0].message   # where it read
    # the same read, named by the design, is allowed
    assert ta.audit_step(chatty_step, (_words(8),), label="chatty",
                         file="x.py", device="cpu", allowed_syncs=1) == []


def test_audit_step_holds_the_output_to_its_plain_version():
    """T006: an output that differs from the plain version's on host
    copies of the inputs (taken before the step writes them)."""
    def in_place(x):
        x |= 1
        return x

    assert ta.audit_step(in_place, (_words(8, 2),), label="ok",
                         file="x.py", device="cpu",
                         reference=lambda x: x | 1) == []
    fs = ta.audit_step(in_place, (_words(8, 2),), label="off", file="x.py",
                       device="cpu", reference=lambda x: x | 2)
    assert _rules(fs) == ["T006"] and "differs from the plain" in \
        fs[0].message


def test_audit_step_reports_failure_as_finding():
    def broken(x):
        raise ValueError("no step for you")

    fs = ta.audit_step(broken, (_words(8),), label="broken", file="x.py",
                       device="cpu")
    assert _rules(fs) == ["T006"]
    assert "no step for you" in fs[0].message


@pytest.mark.parametrize("step,reads", [
    (lambda x: x[x > 0], 1),               # boolean-mask index
    (lambda x: x.nonzero(), 1),
    (lambda x: torch.unique(x), 1),
    (lambda x: bool(x.any()) and int(x.sum()), 2),
    (lambda x: x + 1, 0),
])
def test_audit_mode_counts_host_round_trips(step, reads):
    mode = ta.AuditMode()
    with mode:
        step(torch.arange(8, dtype=torch.int32))
    assert len(mode.reads) == reads


# ---------------------------------------------------------------------
# trace audit: repo checks fire when invariants are deliberately broken
# ---------------------------------------------------------------------

def test_pow2_check_clean_and_catches_regression(monkeypatch):
    from repro_torch.core.dense import DenseRPQ

    assert ta.check_pow2_padding() == []
    monkeypatch.setattr(DenseRPQ, "_pad_width",
                        staticmethod(lambda S: max(S, 4)))
    broken = ta.check_pow2_padding()
    assert broken and all(f.rule == "T003" for f in broken)


def test_retrace_check_clean_and_budget_fires(monkeypatch):
    assert ta.check_retraces("cpu") == []
    monkeypatch.setitem(ta.RETRACE_BUDGET, "dense", 0)
    fs = ta.check_retraces("cpu")
    assert any(f.rule == "T004" and "dense" in f.message for f in fs)


def test_kernel_contracts_and_sharded_steps_clean():
    """Every KERNELS entry through ``ops`` (the plain versions here), the
    R-row BFS, and the sharded steps on a CPU mesh of four."""
    notes = []
    assert ta.check_kernel_contracts("cpu", notes) == []
    assert ta.check_hetero_bfs("cpu", notes) == []
    assert ta.check_sharded_steps("cpu", 4, notes) == []
    assert any(n.startswith("dense.bfs_rows: ") and "chunk(s)" in n
               for n in notes)


def test_kernel_contracts_hold_each_kernel_to_its_ref(monkeypatch):
    """T006: a kernel wrapper whose output is not its ``ref``'s."""
    from repro_torch.kernels import ops

    real = ops.rank1
    monkeypatch.setattr(ops, "rank1", lambda *a: real(*a) + 1)
    fs = ta.check_kernel_contracts("cpu")
    assert _rules(fs) == ["T006"] and "kernels.ops.rank1" in fs[0].message


def test_sharded_step_held_to_one_device_bfs(monkeypatch):
    """T006: the sharded superstep's planes against one device's
    ``bfs_rows`` on the same inputs (a shard that drops its last node
    row's new words differs)."""
    from repro_torch.core import distributed as dist

    real = dist.shard_superstep

    def drops_a_row(replicas, gathered, flags, tables, n, Vl):
        moved = real(replicas, gathered, flags, tables, n, Vl)
        for r in replicas:
            r.bufs[(n + 1) % 3][:, -1] = 0
        return moved

    assert ta.check_sharded_steps("cpu", 4) == []
    monkeypatch.setattr(dist, "shard_superstep", drops_a_row)
    fs = ta.check_sharded_steps("cpu", 4)
    assert _rules(fs) == ["T006"] and "plane read-back" in fs[0].message


def test_hetero_bfs_reads_counted_against_the_designed_chunks(monkeypatch):
    """T002: the allowed reads follow the designed chunk schedule, not
    the loop's own: a loop that reads the flag after every superstep
    (one chunk, one span a superstep) exceeds it."""
    from repro_torch.core import dense

    # chunks of 1, 2, 4, 8, 16, 16, ...: 1, 3, 7, 15, 31, 47 supersteps
    assert [ta.designed_chunks(n) for n in (0, 1, 2, 3, 4, 7, 8, 15, 16,
                                            31, 32, 47, 48)] == \
        [0, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7]
    monkeypatch.setattr(dense, "_chunk", lambda done, deadline, step: 1)
    fs = ta.check_hetero_bfs("cpu")
    assert _rules(fs) == ["T002"] and "dense.bfs_rows" in fs[0].message


def test_hetero_bfs_flag_read_per_superstep_is_a_finding(monkeypatch):
    """T002: ``bfs_rows`` may read the flag once a chunk; a step that
    reads it every superstep exceeds the designed count."""
    from repro_torch.core import dense

    real = dense.ops.packed_superstep

    def reading(*args, **kw):
        real(*args, **kw)
        args[4].item()

    monkeypatch.setattr(dense.ops, "packed_superstep", reading)
    fs = ta.check_hetero_bfs("cpu")
    assert _rules(fs) == ["T002"] and "dense.bfs_rows" in fs[0].message


def test_sharded_superstep_reads_nothing(monkeypatch):
    """T002: ``_PlaneBFS.run``, the sharded superstep proper, may not
    read the host; only the plane read-back at exit reads the flags."""
    from repro_torch.core import distributed as dist

    real = dist.shard_superstep

    def reading(replicas, gathered, flags, tables, n, Vl):
        moved = real(replicas, gathered, flags, tables, n, Vl)
        max(int(f.item()) for f in flags.values())
        return moved

    monkeypatch.setattr(dist, "shard_superstep", reading)
    fs = ta.check_sharded_steps("cpu", 4)
    assert _rules(fs) == ["T002"] and "superstep" in fs[0].message


def test_collective_bytes_on_cpu_mesh_and_a_second_gather_fires(
        monkeypatch):
    from repro_torch.core import distributed as dist

    notes, data = [], {}
    assert ta.check_collective_bytes(notes, "cpu", 4, data) == []
    assert any(n.startswith("T005 OK") and "int8-plane model" in n
               for n in notes)
    # one int32 word a node row of every shard, R = 4 rows, counted by
    # the audit's copies into the one gathered buffer of the host
    t005 = data["t005"]
    assert t005["gathered_bytes_per_participant_per_superstep"] == \
        4 * t005["R"] * t005["V_pad"]
    assert t005["port_wire_model_bytes"] == \
        4 * t005["R"] * t005["V_pad"] * 3 / 4
    skipped = []
    assert ta.check_collective_bytes(skipped, "cpu", 1) == []
    assert "skipped" in skipped[0]

    real = dist.shard_superstep

    def gathers_twice(replicas, gathered, flags, tables, n, Vl):
        # a second copy of every frontier; the step's own byte count
        # (what it returns) is left as it was
        for G in gathered.values():
            for r in replicas:
                if r.j == 0:
                    G[:, r.k * Vl:(r.k + 1) * Vl].copy_(r.bufs[n % 3])
        return real(replicas, gathered, flags, tables, n, Vl)

    monkeypatch.setattr(dist, "shard_superstep", gathers_twice)
    fs = ta.check_collective_bytes([], "cpu", 4)
    assert _rules(fs) == ["T005"]


def test_trace_layer_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.run_trace_audit(REPO_ROOT, use_cache=False)


# ---------------------------------------------------------------------
# the gate itself
# ---------------------------------------------------------------------

def test_repo_is_clean_under_lint_gate():
    """Regression: the shipped tree passes the lint layer against the
    checked-in baseline (new findings must be fixed or justified)."""
    findings = run_lint(REPO_ROOT)
    baseline = load_baseline(
        REPO_ROOT / "src/repro_torch/analysis/baseline.json")
    new = filter_new(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)


def test_lint_import_loads_no_torch():
    """``import repro_torch.analysis.lint`` (and the semantic layer)
    stays cheap: a fresh interpreter loads no torch."""
    code = ("import sys, repro_torch.analysis.lint, "
            "repro_torch.analysis.semantic, repro_torch.analysis\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_exit_codes_and_json_report(tmp_path):
    """python -m repro_torch.analysis --lint exits 0 on the repo and 1 on
    a tree with a deliberately introduced violation, with a file:line
    finding in the JSON report."""
    r = _cli(["--lint", "--root", str(REPO_ROOT)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK: no new findings" in r.stdout

    bad_root = tmp_path / "badrepo"
    (bad_root / "src/repro_torch/core").mkdir(parents=True)
    (bad_root / "src/repro_torch/core/rogue.py").write_text(
        textwrap.dedent("""\
        def collect(tomb):
            return [t for t in set(tomb)]
        """))
    report = tmp_path / "report.json"
    r = _cli(["--lint", "--root", str(bad_root), "--json", str(report)])
    assert r.returncode == 1, r.stdout + r.stderr
    assert "src/repro_torch/core/rogue.py:2" in r.stdout
    doc = json.loads(report.read_text())
    assert doc["new"][0]["rule"] == "R001"
    assert doc["new"][0]["line"] == 2


def test_gate_lint_and_semantic_exit_0_on_the_tree():
    r = _cli(["--layer", "lint", "--layer", "semantic", "--root",
              str(REPO_ROOT)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK: no new findings" in r.stdout


def test_trace_audit_multidevice_subprocess(tmp_path):
    """The trace audit (with the T005 collective-bytes check against the
    wire model) on a CPU mesh of four: the tree passes (the lint and
    semantic layers are the gate's test above)."""
    r = _cli(["--trace", "--device", "cpu", "--mesh-devices", "4",
              "--root", str(REPO_ROOT), "--no-trace-cache", "--json",
              str(tmp_path / "out.json")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "T005 OK" in r.stdout
    assert "4 cpu device(s)" in r.stdout
    assert "OK: no new findings" in r.stdout
    doc = json.loads((tmp_path / "out.json").read_text())
    assert doc["new"] == [] and doc["baselined"] == 0
    # each check's result and T005's bytes as data, not only as notes
    trace = doc["trace"]
    assert sorted(trace["checks"]) == sorted(n for n, _, _ in ta.checks(
        "cpu", 4))
    assert all(c["findings"] == 0 and not c["cached"]
               for c in trace["checks"].values())
    assert trace["t005"]["mesh_devices"] == 4
    assert trace["t005"]["gathered_bytes_per_participant_per_superstep"] \
        <= trace["t005"]["limit_bytes"]
