"""The port stands alone: no JAX, nothing of the JAX package, and no
silent fall back to the CPU."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _forbidden(name: str) -> bool:
    return name.split(".")[0].startswith("jax") or name == "repro" \
        or name.startswith("repro.")


def test_port_imports_leave_no_jax_or_reference_modules():
    """Import every module of the port, and ``chip_smoke``, in a fresh
    interpreter: no ``jax*`` and no ``repro``/``repro.*`` module loads."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.rpq" in mods and "chip_smoke" in mods
    assert "repro_torch.kernels.nfa_step" in mods
    for lm in ("repro_torch.models.transformer", "repro_torch.train.loop",
               "repro_torch.data.pipeline", "repro_torch.launch.path_lm",
               "repro_torch.analysis.trace_audit"):
        assert lm in mods
    assert [m for m in mods if _forbidden(m)] == []


def test_checkpoint_loads_no_msgpack_or_zstandard(tmp_path):
    """In a fresh interpreter, importing ``repro_torch.checkpoint`` and a
    zlib save and restore load neither ``msgpack`` nor ``zstandard`` (the
    GPU machine has neither); reading a zstd checkpoint is what loads
    ``zstandard``."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from repro_torch import checkpoint as ck\n"
        "state = {'x': np.arange(4)}\n"
        f"ck.save({str(tmp_path)!r}, 1, state)\n"
        f"ck.restore({str(tmp_path)!r}, state, device='cpu', verify=True)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.checkpoint" in mods
    assert [m for m in mods if m.split(".")[0] in ("msgpack", "zstandard")] \
        == []


def test_port_sources_name_no_jax_or_reference_imports():
    """Static check, which also covers imports inside functions."""
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(files) > 20
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert bad == []


def test_engine_without_cuda_raises(monkeypatch):
    from repro_torch.core import fixtures
    from repro_torch.core.engines import make_engine
    from repro_torch.core.ring import Ring
    from repro_torch.core.rpq import RingRPQ
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = fixtures.metro_graph()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(g, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RingRPQ(Ring(g))
    eng = make_engine(g, device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng._resolve_threshold() == float("inf")
    assert RingRPQ(Ring(g), device="cpu",
                   kernel_threshold=64)._resolve_threshold() == 64


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device the smoke exits non-zero and prints no
    result; alone in a directory (no port beside it) it does too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = _run_smoke(ROOT, env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path, env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# Every reference suite (``tests/test_*.py`` but ``test_torch_*.py``) is
# read by AST, never imported.  Each of its tests needs a same-named test in
# some ``tests/test_torch_*.py``; or an entry of COUNTERPART_EXCEPTIONS,
# which names a port test ("file::test") that makes every assertion the
# reference test makes, on the same cases or a superset (in the port's
# idiom where the reference asserts on JAX's); or, for the tests of the
# benchmark's regression gate only, an entry of AWAITING_BENCHMARK.
# The seven RPQ suites were the first under the check.
REFERENCE_SUITES = tuple(sorted(
    f.stem[len("test_"):] for f in (ROOT / "tests").glob("test_*.py")
    if not f.name.startswith("test_torch_")))
RPQ_SUITES = ("core", "engines", "hetero_batch", "updates", "planner",
              "obs", "explain")
COUNTERPART_EXCEPTIONS = {
    "test_engines_agree_on_workload":
        "test_torch_dense.py::test_ring_and_dense_agree_on_workload",
    "test_packed_matches_dense":
        "test_torch_packed.py::test_packed_bfs_matches_reference",
    # fails in the reference on jax 0.9.0 (its _shard_map's check_rep)
    "test_sharded_single_device_parity":
        "test_torch_distributed.py::test_engines_on_one_shard_match_reference",
    # fails in the reference on jax 0.9.0 (its _shard_map's check_rep)
    "test_sharded_parity_multidevice_subprocess":
        "test_torch_distributed.py::"
        "test_engines_on_meshes_match_reference_subprocess",
    "test_updates_rebuild_oracle_property_all_engines":
        "test_torch_updates.py::test_live_updates_parity",
    "test_planner_parity_all_plan_shapes":
        "test_torch_planner.py::test_planner_policy_parity",
    "test_analyze_timeline_invariants_across_planner_shapes":
        "test_torch_dense_serving.py::test_analyze_timeline_matches_reference",
    "test_eval_many_delivers_explain_reports":
        "test_torch_dense_serving.py::test_eval_many_delivers_analyze_reports",
    # tests/test_kernels.py: the same sizes, each against the JAX package
    # and its oracles, and the reference test's own checks (the
    # directory's steps, rank1 against a prefix sum, the packed shape)
    "test_rank_kernel":
        "test_torch_kernels.py::test_superblock_popcounts_and_directory",
    "test_rank1_matches_ref":
        "test_torch_kernels.py::test_rank1_matches_reference",
    # the whole scan against the oracle (the Pallas kernel's is one tile)
    "test_segmented_scan_matches_associative_scan":
        "test_torch_kernels.py::test_segmented_or_scan_matches_reference",
    "test_pack_unpack_roundtrip":
        "test_torch_kernels.py::test_pack_unpack_match_reference",
    # tests/test_system.py: the port reads no HLO; its wire model is held
    # to the reference's parser on the reference's lines and stated bytes
    "test_hlo_collective_parser":
        "test_torch_dryrun.py::test_wire_bytes_match_reference_hlo_model",
    "test_sharding_sanitize":
        "test_torch_sharding.py::"
        "test_sanitize_matches_the_reference_system_cases",
    # tests/test_analysis.py: the same fixtures in the port's idiom (the
    # port's R003 also wants a card test; its trace audit runs a step
    # under a dispatch mode, where a host read stands for a callback and
    # int64 for a signed word)
    "test_r003_missing_ref_then_missing_test_then_clean":
        "test_torch_analysis.py::"
        "test_r003_missing_ref_then_cpu_test_then_card_test_then_clean",
    "test_audit_jaxpr_clean_step":
        "test_torch_analysis.py::test_audit_step_clean_step",
    "test_audit_jaxpr_catches_dtype_break":
        "test_torch_analysis.py::test_audit_step_catches_dtype_break",
    "test_audit_jaxpr_catches_host_callback":
        "test_torch_analysis.py::test_audit_step_catches_host_read",
    "test_audit_jaxpr_reports_lowering_failure_as_finding":
        "test_torch_analysis.py::test_audit_step_reports_failure_as_finding",
}
# reference tests of ``benchmarks/compare.py`` (loaded by
# ``tests/test_scheduler.py``'s ``_compare_mod``), the benchmark's
# regression gate, which a benchmark PR ports with the benchmark itself
AWAITING_BENCHMARK = {
    "test_compare_gate_fails_on_injected_slowdown":
        "the regression gate of benchmarks/compare.py, ported with the "
        "benchmark",
    "test_compare_gate_skips_without_previous":
        "the regression gate of benchmarks/compare.py, ported with the "
        "benchmark",
}


def _functions(path: Path) -> dict:
    return {n.name: n for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _test_names(path: Path) -> set:
    return {n for n in _functions(path) if n.startswith("test_")}


def _suite(name: str) -> Path:
    return ROOT / "tests" / f"test_{name}.py"


def _check_counterparts(suites) -> None:
    """Each ``test_*`` of ``suites`` has a same-named test in some
    ``tests/test_torch_*.py``, an entry of ``COUNTERPART_EXCEPTIONS``
    whose counterpart exists, or one of ``AWAITING_BENCHMARK``; and no
    entry of either map is stale (names a reference test that now has a
    same-named port test, or none at all)."""
    tests = ROOT / "tests"
    port = {f.name: _test_names(f) for f in tests.glob("test_torch_*.py")}
    every_port = set().union(*port.values())
    everywhere = set().union(*(_test_names(_suite(s))
                               for s in REFERENCE_SUITES))
    reference = set().union(*(_test_names(_suite(s)) for s in suites))
    missing = sorted(reference - every_port - set(COUNTERPART_EXCEPTIONS)
                     - set(AWAITING_BENCHMARK))
    assert missing == [], missing
    assert not set(COUNTERPART_EXCEPTIONS) & set(AWAITING_BENCHMARK)
    for name, counterpart in COUNTERPART_EXCEPTIONS.items():
        assert name in everywhere and name not in every_port, name
        file, test = counterpart.split("::")
        assert test in port.get(file, set()), (name, counterpart)
    for name in AWAITING_BENCHMARK:
        assert name in everywhere and name not in every_port, name


def test_every_reference_test_has_a_counterpart():
    """All fourteen reference suites, read by AST (never imported)."""
    assert len(REFERENCE_SUITES) == 14, REFERENCE_SUITES
    assert set(RPQ_SUITES) < set(REFERENCE_SUITES)
    assert sum(len(_test_names(_suite(s))) for s in REFERENCE_SUITES) > 200
    _check_counterparts(REFERENCE_SUITES)


def test_every_reference_rpq_test_has_a_counterpart():
    """The seven RPQ suites, the first under the check."""
    assert sum(len(_test_names(_suite(s))) for s in RPQ_SUITES) > 80
    _check_counterparts(RPQ_SUITES)


def test_awaiting_benchmark_holds_only_compare_gate_tests():
    """``AWAITING_BENCHMARK`` holds exactly the tests of
    ``tests/test_scheduler.py`` whose bodies call ``_compare_mod()`` (the
    loader of ``benchmarks/compare.py``), read by AST: the map parks no
    test that the port could fail."""
    fns = _functions(_suite("scheduler"))

    def loads_compare(fn) -> bool:
        return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                   and n.func.id == "_compare_mod" for n in ast.walk(fn))

    gate = {n for n, fn in fns.items()
            if n.startswith("test_") and loads_compare(fn)}
    assert "_compare_mod" in fns
    assert set(AWAITING_BENCHMARK) == gate == {
        "test_compare_gate_fails_on_injected_slowdown",
        "test_compare_gate_skips_without_previous"}
