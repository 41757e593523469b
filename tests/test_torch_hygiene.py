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
    assert [m for m in mods if _forbidden(m)] == []


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
