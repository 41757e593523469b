"""The port's query examples (``python -m repro_torch.examples.<name>``)
against the JAX package's (``examples/*.py``), both on the CPU: the
quickstart prints the reference's stdout line for line, and the
Wikidata-style workload the reference's graph, ring size and per-pattern
query counts (timing columns stripped), with the reference's answers.
Every port answer equals the port's brute-force oracle."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.oracle import eval_oracle  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    wikidata_style_queries as wikidata)

ROOT = Path(__file__).resolve().parents[1]
WIKIDATA_SMALL = ["--nodes", "500", "--edges", "4000", "--queries", "10"]


def _reference(script, *args):
    """The reference example's stdout (it does ``sys.path.insert(0,
    "src")``, so it runs from the repository root)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, f"examples/{script}", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_quickstart_prints_the_reference_output(capsys):
    record = {}
    assert quickstart.main(["--device", "cpu"], record=record) == 0
    got = capsys.readouterr().out
    assert got.splitlines() == _reference("quickstart.py").splitlines()
    g = record["graph"]
    assert len(record["answers"]) == 1 + len(quickstart.QUERIES)
    for (expr, s, o), ring, dense in record["answers"]:
        assert ring == dense == eval_oracle(g, expr, s, o), expr


def _strip_times(text):
    """Every line with its timings taken out: the ring's build seconds,
    the ms columns of the table and the totals' seconds."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"ring built in [0-9.]+s ", "ring built ", line)
        line = re.sub(r"(ring|dense) [0-9.]+s", r"\1", line)
        line = re.sub(r"^(\s*\S.*?\s+\d+)\s+[0-9.]+\s+[0-9.]+$", r"\1", line)
        out.append(re.sub(r"\s+ring ms\s+dense ms$", "", line))
    return out


def test_wikidata_style_queries_match_the_reference(capsys):
    """At ``--nodes 500 --edges 4000 --queries 10``: the reference's
    lines with the timings stripped, the reference dense engine's
    answer sets, and the oracle's answers on both port engines."""
    from repro.core.dense import DenseRPQ as RDense
    from repro.core.fixtures import scale_free_graph as rscale_free
    want_text = _reference("wikidata_style_queries.py", *WIKIDATA_SMALL)
    record = {}
    assert wikidata.main(["--device", "cpu", *WIKIDATA_SMALL],
                         record=record) == 0
    got_text = capsys.readouterr().out
    assert _strip_times(got_text) == _strip_times(want_text)
    assert len(_strip_times(got_text)) == len(got_text.splitlines())
    ref = RDense(rscale_free(500, 16, 4000, seed=3), source_batch=8)
    g = record["graph"]
    assert len(record["answers"]) == 10
    for (expr, s, o, pat), ring, dense in record["answers"]:
        want = ref.eval(expr, subject=s, obj=o, limit=wikidata.LIMIT)
        assert ring == dense == want, (expr, pat)
        assert ring == eval_oracle(g, expr, s, o), (expr, pat)
    assert sum(record["counts"].values()) == 10
    assert set(record["ms"]) == set(record["counts"])


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device`` each example asks for the card, and raises
    without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((quickstart, []), (wikidata, WIKIDATA_SMALL)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv)
