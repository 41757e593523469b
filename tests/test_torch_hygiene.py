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


# reference RPQ tests without a same-named test_torch_* counterpart: the
# counterpart under another name ("file::test"), or why there is none
REFERENCE_SUITES = ("core", "engines", "hetero_batch", "updates", "planner",
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
}


def _test_names(path: Path) -> set:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name.startswith("test_")}


def test_every_reference_rpq_test_has_a_counterpart():
    """Each ``test_*`` of the reference's RPQ suites, read by AST (never
    imported), has a same-named test in some ``tests/test_torch_*.py``,
    or an entry of ``COUNTERPART_EXCEPTIONS`` whose counterpart exists;
    and no exception is stale (its name has no same-named port test)."""
    tests = ROOT / "tests"
    port = {f.name: _test_names(f) for f in tests.glob("test_torch_*.py")}
    every_port = set().union(*port.values())
    reference = set()
    for suite in REFERENCE_SUITES:
        reference |= _test_names(tests / f"test_{suite}.py")
    assert len(reference) > 80
    missing = sorted(reference - every_port - set(COUNTERPART_EXCEPTIONS))
    assert missing == [], missing
    for name, counterpart in COUNTERPART_EXCEPTIONS.items():
        assert name in reference and name not in every_port, name
        file, test = counterpart.split("::")
        assert test in port.get(file, set()), (name, counterpart)
