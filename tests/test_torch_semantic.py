"""The port's layer-3 semantic analyzer (``repro_torch.analysis``): the
counterpart of ``tests/test_semantic.py``.

One positive (seeded violation) and one negative (canonical idiom)
fixture per C/B rule — so deleting a rule's checker fails exactly that
rule's test — each fixture also given to the JAX package's analyzer,
which must report the same (rule, line, fingerprint); B002/B004 on the
port's words (``int32`` views and int64 masked to 32 bits); the
determinism contract (two runs, byte-identical findings JSON), the
repo-is-clean gate, SARIF export, baseline pruning, and the trace-audit
result cache."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import ast
import functools

import pytest

from repro.analysis import semantic as jsem
from repro_torch.analysis import (Finding, analyze_file, filter_new,
                                  load_baseline, run_semantic, to_sarif,
                                  update_baseline, write_baseline)
from repro_torch.analysis import bounds, semantic
from repro_torch.analysis import dataflow as df
from repro_torch.analysis.bounds import INT64_MAX

REPO_ROOT = Path(__file__).resolve().parent.parent
BASELINE = REPO_ROOT / "src/repro_torch/analysis/baseline.json"


def _analyze(tmp_path, source, rel="src/repro_torch/core/mod.py"):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(source))
    return analyze_file(path, rel)


def _rules(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------
# C001: step-scope reads must flow from pinned snapshots
# ---------------------------------------------------------------------

def test_c001_flags_live_engine_reads_in_step_scope(tmp_path):
    src = """\
        class Stepper:
            def __init__(self, eng):
                self.eng = eng

            def step(self):
                eng = self.eng
                ov = eng.delta            # live overlay, not the pin
                edges = self.eng._edges() # live edge resolve
                return ov, edges
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C001", "C001"]
    assert {f.line for f in fs} == {7, 8}


def test_c001_allows_pinned_snapshots_and_free_functions(tmp_path):
    src = """\
        def step(eng):
            return eng.delta  # free function: jit closure, not step scope

        class Stepper:
            def add_job(self, job):
                job.ring = self.eng.ring  # admission-time pin: allowed

            def step(self, job):
                bwd = job.ring            # reads flow from the pin
                snap = job.ov
                return bwd, snap
        """
    assert _analyze(tmp_path, src) == []


# ---------------------------------------------------------------------
# C002: COW routing — clone() -> apply_engine_updates
# ---------------------------------------------------------------------

def test_c002_flags_unrouted_overlay_mutations(tmp_path):
    src = """\
        def submit_update(eng, add, remove):
            apply_engine_updates(eng, add, remove)  # no COW swap first

        def sneaky(eng, add):
            ov = eng.delta
            ov.apply(add, [])                        # aliased mutation

        class Eng:
            def rebind(self, other):
                self.delta = other.delta             # non-clone rebind
        """
    assert _rules(_analyze(tmp_path, src)) == ["C002", "C002", "C002"]


def test_c002_allows_clone_swap_discipline(tmp_path):
    src = """\
        def apply_engine_updates(engine, add, remove):
            pass

        def submit_update(eng, add, remove):
            eng.delta = eng.delta.clone()
            apply_engine_updates(eng, add, remove)

        class Eng:
            def __init__(self):
                self.delta = None
        """
    assert _analyze(tmp_path, src) == []


def test_c002_exempts_the_delta_module_itself(tmp_path):
    src = """\
        class Eng:
            def rebind(self, other):
                self.delta = other.delta
        """
    assert _analyze(tmp_path, src, rel="src/repro_torch/core/delta.py") == []


# ---------------------------------------------------------------------
# C003: slot acquire/release pairing
# ---------------------------------------------------------------------

def test_c003_flags_unpaired_module_add_slot(tmp_path):
    src = """\
        class Stepper:
            def add_job(self, job, plan):
                job.offset = self.bundle.add_slot(plan, 8)
                self.jobs.append(job)
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C003"]
    assert "free_slot" in fs[0].message


def test_c003_flags_early_exit_before_publish(tmp_path):
    src = """\
        class Sched:
            def admit_one(self, plan, start):
                handle = self.slots.admit(plan, start)
                if self.closed:
                    return None
                self.active.append(handle)
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C003"]
    assert "early exit" in fs[0].message


def test_c003_flags_never_settled_handle(tmp_path):
    src = """\
        class Sched:
            def grab(self, plan):
                handle = self.slots.admit(plan)
                self.stats.grabs += 1
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C003"]
    assert "never" in fs[0].message


def test_c003_flags_remove_without_release(tmp_path):
    src = """\
        class Sched:
            def expire(self, now):
                for a in list(self.active):
                    if a.deadline < now:
                        self.active.remove(a)
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C003"]
    assert "remove" in fs[0].message


def test_c003_allows_paired_and_transferred_ownership(tmp_path):
    src = """\
        class Stepper:
            def add_job(self, job, plan):
                job.offset = self.bundle.add_slot(plan, 8)
                self.jobs.append(job)

            def remove_job(self, job):
                job.done = True
                self.bundle.free_slot(job.offset)
                if job in self.jobs:
                    self.jobs.remove(job)

        class Sched:
            def admit_one(self, ticket, plan, start):
                handle = self.slots.admit(plan, start)
                active = _Active(ticket=ticket, handle=handle)
                self.active.append(active)

            def harvest_done(self):
                for a in list(self.active):
                    self.slots.release(a.handle)
                    self.active.remove(a)
        """
    assert _analyze(tmp_path, src) == []


# ---------------------------------------------------------------------
# C004: epoch pinned once, at admission, beside its snapshot
# ---------------------------------------------------------------------

def test_c004_flags_stray_pins_and_mutation_in_window(tmp_path):
    src = """\
        def harvest(tickets, eng):
            for ticket in tickets:
                ticket.epoch = eng.epoch      # pin outside admission

        class Sched:
            def _admit_one(self, ticket, eng, add, remove):
                ticket.epoch = eng.epoch
                eng.submit_update(add, remove)  # mutates inside window
                snap = self.slots.snapshot()
                self.slots.admit(snap)
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C004", "C004"]
    assert any("outside an admission path" in f.message for f in fs)
    assert any("submit_update" in f.message for f in fs)


def test_c004_allows_admission_pin_and_telemetry(tmp_path):
    src = """\
        class Sched:
            def _admit_one(self, ticket, eng, plan, start):
                ticket.epoch = eng.epoch
                handle = self.slots.admit(plan, start, self.slots.snapshot())
                active = _Active(ticket=ticket, handle=handle)
                self.active.append(active)

            def telemetry(self, stats, eng):
                stats.epoch = eng.epoch  # recording, not a ticket pin

            def finish(self, ticket, out):
                return (out, ticket.epoch)  # reads are always fine
        """
    assert _analyze(tmp_path, src) == []


# ---------------------------------------------------------------------
# C005: streamed-result state only grows
# ---------------------------------------------------------------------

def test_c005_flags_shrinking_streamed_state(tmp_path):
    src = """\
        class Stepper:
            def reset(self, job):
                job.reported = set()      # rebind outside __init__

            def compact(self, job):
                job.reported.clear()      # shrink
        """
    assert _rules(_analyze(tmp_path, src)) == ["C005", "C005"]


def test_c005_allows_monotone_growth(tmp_path):
    src = """\
        class _Job:
            def __init__(self):
                self.reported = set()

        class Stepper:
            def harvest_new(self, a, rows):
                new = rows - a.seen
                a.seen |= new
                a.reported.update(new)
                return new
        """
    assert _analyze(tmp_path, src) == []


# ---------------------------------------------------------------------
# C006: no await between capture and admission
# ---------------------------------------------------------------------

def test_c006_flags_await_in_capture_window(tmp_path):
    src = """\
        class Server:
            async def submit(self, q):
                epoch = self.engine.epoch
                await self.flush()
                self.scheduler.admit(q, epoch)
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C006"]
    assert fs[0].line == 4


def test_c006_allows_awaits_outside_the_window(tmp_path):
    src = """\
        class Server:
            async def submit(self, q):
                await self.flush()
                snap = self.engine.snapshot()
                self.scheduler.admit(q, snap)
                await self.pump()
        """
    assert _analyze(tmp_path, src) == []


# ---------------------------------------------------------------------
# B001: packed-key overflow proofs + binding constraint
# ---------------------------------------------------------------------

def test_b001_flags_overflowing_packed_key(tmp_path):
    src = """\
        def pack_bad(s, p, o, num_nodes):
            return (o * num_nodes + p) * num_nodes * num_nodes + s
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["B001"]
    assert "int64" in fs[0].message


def test_b001_proves_canonical_key_and_emits_binding(tmp_path):
    src = """\
        def pack_keys(s, p, o, num_nodes, num_preds_completed):
            return (o * num_preds_completed + p) * num_nodes + s
        """
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(src))
    findings, sites = semantic._analyze_file(path,
                                             "src/repro_torch/core/mod.py")
    assert findings == []
    assert len(sites) == 1
    assert 0 < sites[0]["hi"] <= INT64_MAX
    assert "int64 binds at |V| ~ 2^" in sites[0]["binding"]


# ---------------------------------------------------------------------
# B002: data-derived shift amounts on uint32 words
# ---------------------------------------------------------------------

KERNEL_REL = "src/repro_torch/kernels/mod.py"


def test_b002_flags_unbounded_and_overwide_shifts(tmp_path):
    src = """\
        import jax.numpy as jnp

        def mask_unproven(x, inword):
            return x >> (jnp.uint32(32) - jnp.uint32(inword))

        def mask_reaches_32(x, i):
            inword = i & 31
            return x >> (jnp.uint32(32) - jnp.uint32(inword))
        """
    fs = _analyze(tmp_path, src, rel=KERNEL_REL)
    assert _rules(fs) == ["B002", "B002"]
    assert any("cannot statically bound" in f.message for f in fs)
    assert any("reach 32" in f.message for f in fs)


def test_b002_allows_proven_inword_shifts(tmp_path):
    src = """\
        import numpy as np
        import jax.numpy as jnp

        def unpack(x, j, packed):
            w, b = divmod(j, 32)
            lo = x >> jnp.uint32(b)
            hi = x >> jnp.uint32(5)
            bits = (packed >> np.arange(32, dtype=np.uint32)) & 1
            return lo, hi, bits
        """
    assert _analyze(tmp_path, src, rel=KERNEL_REL) == []


def test_b002_scope_is_kernels_only(tmp_path):
    src = """\
        import jax.numpy as jnp

        def helper(x, k):
            return x >> jnp.uint32(k)
        """
    assert _analyze(tmp_path, src, rel="src/repro_torch/core/mod.py") == []


# ---------------------------------------------------------------------
# B003: pow2 padding + best-fit reuse discipline
# ---------------------------------------------------------------------

def test_b003_flags_broken_pad_and_bestfit_idioms(tmp_path):
    src = """\
        class Bundle:
            def slot_bucket(self, size):
                w = 3                      # non-pow2 base
                while w < size:
                    w *= 2
                return w

            def padded(self, total):
                w = 32
                while w <= total:          # '<=' doubles past minimal
                    w *= 2
                return w

            def padded_capped(self, total, cap):
                w = 32
                while w < total and w < cap:  # can exit below live width
                    w *= 2
                return w

            def pick(self, size):
                best = None
                for fi, bi in enumerate(self._free):
                    if self.sizes[bi] >= size:  # raw size, not bucketed
                        best = (fi, bi)
                return best
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["B003", "B003", "B003", "B003"]
    assert any("power of two" in f.message for f in fs)
    assert any("'<='" in f.message for f in fs)
    assert any("extra conjuncts" in f.message for f in fs)
    assert any("bucket" in f.message for f in fs)


def test_b003_allows_canonical_pad_and_bucketed_bestfit(tmp_path):
    src = """\
        class Bundle:
            def slot_bucket(self, size):
                w = 4
                while w < size:
                    w *= 2
                return w

            def pick(self, size):
                bucket = self.slot_bucket(size)
                best = None
                for fi, bi in enumerate(self._free):
                    if self.sizes[bi] >= bucket and (
                            best is None
                            or self.sizes[bi] < self.sizes[best[1]]):
                        best = (fi, bi)
                return best
        """
    assert _analyze(tmp_path, src) == []


# ---------------------------------------------------------------------
# B004: kernel loop structure vs the 32-bit word
# ---------------------------------------------------------------------

def test_b004_flags_overwide_word_splits_and_loops(tmp_path):
    src = """\
        import jax.numpy as jnp

        def bad_split(x, j):
            w, b = divmod(j, 64)
            return x >> jnp.uint32(b)

        def bad_loop(x):
            acc = x
            for b in range(64):
                acc = acc | (x << jnp.uint32(b))
            return acc
        """
    fs = _analyze(tmp_path, src, rel=KERNEL_REL)
    assert _rules(fs) == ["B004", "B004", "B004"]
    assert any("divmod" in f.message for f in fs)
    assert any("loop-structured" in f.message for f in fs)


def test_b004_allows_word_sized_splits(tmp_path):
    src = """\
        import jax.numpy as jnp

        def split(x, j):
            w, b = divmod(j, 32)
            out = x
            for k in range(32):
                out = out | (x << jnp.uint32(k))
            return out >> jnp.uint32(b)
        """
    assert _analyze(tmp_path, src, rel=KERNEL_REL) == []


# ---------------------------------------------------------------------
# noqa mechanics on the semantic layer
# ---------------------------------------------------------------------

def test_semantic_noqa_suppresses_only_named_rule(tmp_path):
    src = """\
        class Stepper:
            def step(self):
                eng = self.eng
                a = eng.delta  # repro: noqa C001 — fixture suppression
                b = eng.delta  # repro: noqa C002 — wrong rule id
                return a, b
        """
    fs = _analyze(tmp_path, src)
    assert _rules(fs) == ["C001"]
    assert fs[0].line == 5


# ---------------------------------------------------------------------
# determinism + the repo-is-clean gate
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree_run():
    return run_semantic(REPO_ROOT)


def test_semantic_runs_are_byte_identical():
    """Two full runs over the real tree serialize to identical bytes —
    the CI artifact must not churn without a source change."""
    from repro_torch.analysis.findings import to_json
    f1, n1 = _tree_run()
    f2, n2 = run_semantic(REPO_ROOT)
    blob1 = json.dumps({"new": to_json(f1), "notes": n1}).encode()
    blob2 = json.dumps({"new": to_json(f2), "notes": n2}).encode()
    assert blob1 == blob2


def test_repo_is_semantically_clean():
    """Acceptance gate: the shipped tree produces no new C/B findings,
    and the proof notes report at least one packed-key site with its
    binding constraint."""
    findings, notes = _tree_run()
    new = filter_new(findings, load_baseline(BASELINE))
    assert new == [], "\n".join(f.render() for f in new)
    assert any("packed-key site(s) proven within int64" in n
               for n in notes)
    assert any("int64 binds at |V|" in n for n in notes)
    # B001 keeps proving the packed key of the port's delta overlay
    assert any("B001 tightest packing site src/repro_torch/core/delta.py:"
               in n and "50.0% of int64 headroom" in n and
               "|V| ~ 2^27" in n for n in notes)


# ---------------------------------------------------------------------
# SARIF export
# ---------------------------------------------------------------------

def test_to_sarif_structure():
    fs = [Finding("src/x.py", 12, "C001", "msg", "do it", "snip"),
          Finding("src/y.py", 0, "B002", "msg2", "", "snip2")]
    doc = to_sarif(fs, tool_version="1.2")
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "repro_torch-analysis"
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == \
        ["B002", "C001"]
    res = {r["ruleId"]: r for r in run["results"]}
    loc = res["C001"]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "src/x.py"
    assert loc["region"]["startLine"] == 12
    # line-0 (whole-file) findings clamp to a valid SARIF region
    assert res["B002"]["locations"][0]["physicalLocation"]["region"][
        "startLine"] == 1
    assert res["C001"]["partialFingerprints"]["reproAnalysis/v1"] == \
        fs[0].fingerprint
    assert "hint: do it" in res["C001"]["message"]["text"]


# ---------------------------------------------------------------------
# baseline pruning (--update-baseline)
# ---------------------------------------------------------------------

def test_update_baseline_keeps_justifications_and_prunes(tmp_path):
    f1 = Finding("a.py", 3, "C002", "m", "h", "snippet-one")
    f2 = Finding("b.py", 9, "B001", "m2", "h", "snippet-two")
    path = tmp_path / "bl.json"
    write_baseline(path, [f1], justification="reviewed: fixture")
    assert update_baseline(path, [f1, f2]) == (1, 1, 0)
    doc = json.loads(path.read_text())
    by_fp = {e["fingerprint"]: e["justification"]
             for e in doc["findings"]}
    assert by_fp[f1.fingerprint] == "reviewed: fixture"
    # f1 gets fixed: its fingerprint is pruned, f2's entry survives
    assert update_baseline(path, [f2]) == (1, 0, 1)
    doc = json.loads(path.read_text())
    assert [e["fingerprint"] for e in doc["findings"]] == [f2.fingerprint]


# ---------------------------------------------------------------------
# trace-audit lowering cache (stub checks: no real lowering)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ta():
    pytest.importorskip("torch")
    from repro_torch.analysis import trace_audit
    return trace_audit


def _hits_misses(results):
    hits = sum(r["cached"] for r in results.values())
    return hits, len(results) - hits


def test_trace_cache_hit_miss_and_invalidation(tmp_path, ta):
    dep = tmp_path / "dep.py"
    dep.write_text("x = 1\n")
    calls = []
    finding = Finding("k.py", 1, "T001", "m", "h", "snip")

    def chk(notes, data):
        calls.append(1)
        notes.append("lowered")
        data["bytes"] = 16384
        return [finding]

    checks = [("fake_check", chk, ("dep.py",))]
    cache_dir = tmp_path / "cache"
    f1, n1, r1 = ta._run_checks_cached(tmp_path, checks, cache_dir, True)
    assert _hits_misses(r1) == (0, 1) and f1 == [finding] and "lowered" in n1
    assert r1["fake_check"]["data"] == {"bytes": 16384}
    f2, n2, r2 = ta._run_checks_cached(tmp_path, checks, cache_dir, True)
    assert _hits_misses(r2) == (1, 0) and len(calls) == 1
    assert f2 == [finding] and "lowered" in n2  # replay is lossless
    assert r2["fake_check"] == {"findings": 1, "seconds": None,
                                "cached": True, "data": {"bytes": 16384}}
    dep.write_text("x = 2\n")  # source churn invalidates the key
    _, _, r3 = ta._run_checks_cached(tmp_path, checks, cache_dir, True)
    assert _hits_misses(r3) == (0, 1) and len(calls) == 2
    # disabled cache always re-runs
    _, _, r4 = ta._run_checks_cached(tmp_path, checks, None, False)
    assert _hits_misses(r4) == (0, 1) and len(calls) == 3
    # the key holds the torch version, the device's name and the mesh:
    # another signature misses, and the first still hits
    _, _, r5 = ta._run_checks_cached(tmp_path, checks, cache_dir, True,
                                     "other-torch:NVIDIA H100:4")
    assert _hits_misses(r5) == (0, 1) and len(calls) == 4
    _, _, r6 = ta._run_checks_cached(tmp_path, checks, cache_dir, True)
    assert _hits_misses(r6) == (1, 0) and len(calls) == 4
    assert ta.signature("cpu", 4).endswith(":cpu:4")


def test_trace_cache_skips_unresolvable_deps(tmp_path, ta):
    calls = []

    def chk(notes, data):
        calls.append(1)
        return []

    checks = [("ghost", chk, ("no/such/dir",))]
    cache_dir = tmp_path / "cache"
    for _ in range(2):  # uncacheable: misses both times
        _, _, results = ta._run_checks_cached(tmp_path, checks, cache_dir,
                                              True)
        assert _hits_misses(results) == (0, 1)
    assert len(calls) == 2
    assert not (cache_dir / "trace_audit.json").exists()


# ---------------------------------------------------------------------
# CLI: --layer semantic, --sarif, --update-baseline
# ---------------------------------------------------------------------

def _cli(args, timeout=240):
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, timeout=timeout, env=env)


def test_cli_semantic_layer_clean_on_repo():
    r = _cli(["--layer", "semantic", "--root", str(REPO_ROOT)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK: no new findings" in r.stdout
    assert "packed-key site(s) proven within int64" in r.stdout


def _seed_bad_tree(tmp_path):
    bad_root = tmp_path / "badrepo"
    (bad_root / "src/repro_torch/core").mkdir(parents=True)
    (bad_root / "src/repro_torch/core/rogue.py").write_text(
        textwrap.dedent("""\
        def submit_update(eng, add, remove):
            apply_engine_updates(eng, add, remove)
        """))
    return bad_root


def test_cli_semantic_fails_on_seeded_violation_with_sarif(tmp_path):
    bad_root = _seed_bad_tree(tmp_path)
    sarif = tmp_path / "out.sarif"
    r = _cli(["--layer", "semantic", "--root", str(bad_root),
              "--baseline", str(tmp_path / "bl.json"),
              "--sarif", str(sarif)])
    assert r.returncode == 1, r.stdout + r.stderr
    assert "src/repro_torch/core/rogue.py:1" in r.stdout
    assert "C002" in r.stdout
    doc = json.loads(sarif.read_text())
    assert doc["version"] == "2.1.0"
    results = doc["runs"][0]["results"]
    assert results and results[0]["ruleId"] == "C002"
    assert results[0]["partialFingerprints"]["reproAnalysis/v1"]


def test_cli_update_baseline_prunes_stale_entries(tmp_path):
    bad_root = _seed_bad_tree(tmp_path)
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"findings": [{
        "fingerprint": "stale:R001:deadbeefdeadbeef",
        "file": "gone.py", "rule": "R001", "message": "fixed long ago",
        "justification": "obsolete",
    }]}))
    r = _cli(["--layer", "semantic", "--root", str(bad_root),
              "--baseline", str(bl), "--update-baseline"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 stale fingerprint(s) pruned" in r.stdout
    doc = json.loads(bl.read_text())
    fps = [e["fingerprint"] for e in doc["findings"]]
    assert fps and all("deadbeef" not in fp for fp in fps)
    assert all(e["rule"] == "C002" for e in doc["findings"])
    # the refreshed baseline now grandfathers the violation
    r = _cli(["--layer", "semantic", "--root", str(bad_root),
              "--baseline", str(bl)])
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------
# the JAX package's fixtures give the same findings in both analyzers
# ---------------------------------------------------------------------

def _reference_fixtures():
    """(test name, source, rel) of every fixture the JAX package's
    ``tests/test_semantic.py`` analyzes, read from that file: each
    ``src`` given to its ``_analyze`` (at its rel) or ``_analyze_file``."""
    path = REPO_ROOT / "tests/test_semantic.py"
    tree = ast.parse(path.read_text())
    consts = {n.targets[0].id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and len(n.targets) == 1
              and isinstance(n.targets[0], ast.Name)
              and isinstance(n.value, ast.Constant)}
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        srcs = {n.targets[0].id: n.value.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Constant)
                and isinstance(n.value.value, str)}
        if "src" not in srcs:
            continue
        rels = []
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call)
                    and df.call_name(call.func) in ("_analyze",
                                                    "_analyze_file")):
                continue
            rel = None
            if df.call_name(call.func) == "_analyze_file":
                rel = call.args[1].value
            elif len(call.args) > 2:
                rel = call.args[2]
            for kw in call.keywords:
                if kw.arg == "rel":
                    rel = kw.value
            if isinstance(rel, ast.Name):
                rel = consts[rel.id]
            elif isinstance(rel, ast.Constant):
                rel = rel.value
            rels.append(rel or "src/repro/core/mod.py")
        for i, rel in enumerate(dict.fromkeys(rels)):
            out.append((f"{fn.name}-{i}", srcs["src"], rel))
    return out


REFERENCE_FIXTURES = _reference_fixtures()


def test_reference_fixtures_are_all_read():
    """Every C/B rule test of the JAX package's file with a fixture is
    read (26 tests, one of them at two rels)."""
    assert len({name.rsplit("-", 1)[0]
                for name, _, _ in REFERENCE_FIXTURES}) == 26


@pytest.mark.parametrize("name,source,rel", REFERENCE_FIXTURES,
                         ids=[f[0] for f in REFERENCE_FIXTURES])
def test_semantic_agrees_with_reference(tmp_path, name, source, rel):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(source))
    want = sorted((f.rule, f.line, f.fingerprint)
                  for f in jsem.analyze_file(path, rel))
    got = sorted((f.rule, f.line, f.fingerprint.replace(
        "src/repro_torch/", "src/repro/", 1))
        for f in analyze_file(path, rel.replace("src/repro/",
                                                "src/repro_torch/", 1)))
    assert got == want


# ---------------------------------------------------------------------
# B002/B004 on the port's words: int32 views, int64 masked to 32 bits
# ---------------------------------------------------------------------

PORT_WORD_CASES = {
    # a widened word shifted by an amount nothing bounds
    "widen_unbounded": ("""\
        from .ref import widen

        def bit(words, k):
            x = widen(words)
            return (x >> k) & 1
        """, ["B002"]),
    # the same, proven by the in-word mask
    "widen_masked": ("""\
        from .ref import widen

        def bit(words, k):
            x = widen(words)
            return (x >> (k & 31)) & 1
        """, []),
    # a word built in int64 and narrowed: a bit placed at i % 32 cannot
    # be proven (the evaluator needs both operands), i & 31 can
    "narrow_mod": ("""\
        from .ref import narrow

        def pack(planes, S):
            out = planes.new_zeros(planes.shape[:-1])
            for i in range(S):
                out |= planes[..., i] << (i % 32)
            return narrow(out)
        """, ["B002"]),
    "narrow_and": ("""\
        from .ref import narrow

        def pack(planes, S):
            out = planes.new_zeros(planes.shape[:-1])
            for i in range(S):
                out |= planes[..., i] << (i & 31)
            return narrow(out)
        """, []),
    # an int32 view shifted by a constant past the word
    "int32_view_32": ("""\
        import numpy as np

        def high(words):
            w = words.view(np.int32)
            return w >> 32
        """, ["B002"]),
    # a mask ANDed into a masked word, sized by the word
    "mask_beside_word": ("""\
        WORD_MASK = 0xFFFFFFFF

        def low_bits(x, i):
            partial = (1 << (i & 31)) - 1
            return (x & WORD_MASK) & partial
        """, []),
    # a loop over 64 bit positions of a widened word
    "widen_loop_64": ("""\
        from .ref import widen

        def bits(words):
            x = widen(words)
            out = []
            for b in range(64):
                out.append((x >> b) & 1)
            return out
        """, ["B004"]),
    "widen_loop_32": ("""\
        from .ref import widen

        def bits(words):
            x = widen(words)
            out = []
            for b in range(32):
                out.append((x >> b) & 1)
            return out
        """, []),
    # Python ints of any width are out of scope, as in the JAX package
    "python_int": ("""\
        def words_of(m, W):
            shifted = int(m) << 40
            return [(shifted >> (32 * w)) & 0xFFFFFFFF for w in range(W)]
        """, []),
    # a shift on nothing that is a word is out of scope
    "not_a_word": ("""\
        def rows(i):
            return i >> 40
        """, []),
}


@pytest.mark.parametrize("case", sorted(PORT_WORD_CASES))
def test_b002_b004_on_the_ports_words(tmp_path, case):
    source, rules = PORT_WORD_CASES[case]
    assert _rules(_analyze(tmp_path, source, rel=KERNEL_REL)) == rules
    # the packed BFS is a word file too; the rest of core is not
    assert _rules(_analyze(tmp_path, source,
                           rel="src/repro_torch/core/packed.py")) == rules
    assert _analyze(tmp_path, source) == []


def _word_shift_lines(rel):
    tree = ast.parse((REPO_ROOT / rel).read_text())
    df.attach_parents(tree)
    return {n.lineno for n in bounds.word_shifts(tree, rel)}


def test_ref_word_shifts_are_each_read_and_proven():
    """Every shift on a word in the plain versions is one B002/B004
    read (and the tree has no finding, so each is proven < 32): the
    transition's bit reads, the scatter's and scan's per-bit passes and
    the rank masks."""
    rel = "src/repro_torch/kernels/ref.py"
    lines = (REPO_ROOT / rel).read_text().splitlines()
    want = {i + 1 for i, text in enumerate(lines) if any(
        k in text for k in ("(x[:, w] >> k)", "(x >> b)", "bit << b",
                            ".to(torch.int64) << b", "(1 << (i64 & 31)"))}
    assert len(want) == 8
    assert want <= _word_shift_lines(rel)
    assert [f for f in _tree_run()[0] if f.rule in ("B002", "B004")] == []


def test_b002_repairs_in_the_port(tmp_path):
    """B002's repairs: the plane packers and the popcount mask place a
    bit at ``i & 31`` (``i % 32`` cannot be proven), and the int64 sort
    key's ``o << 32`` is not a word shift (``# repro: noqa B002``).  Put
    back, each is a finding again."""
    for rel, was, now in (
            ("src/repro_torch/kernels/ops.py", "(i & 31)", "(i % 32)"),
            ("src/repro_torch/kernels/packed_superstep.py", "(S & 31)",
             "(S % 32)"),
            ("src/repro_torch/kernels/packed_superstep.py",
             "  # repro: noqa B002", "")):
        text = (REPO_ROOT / rel).read_text()
        assert was in text
        path = tmp_path / "mod.py"
        path.write_text(text)
        assert [f for f in analyze_file(path, rel)
                if f.rule == "B002"] == []
        path.write_text(text.replace(was, now))
        assert "B002" in _rules(analyze_file(path, rel))
