"""Epoch/COW consistency rules (C001-C006, layer 3).

Intraprocedural dataflow checks over the serving stack's copy-on-write
snapshot discipline.  The invariant being defended: a query admitted at
epoch E must compute against the overlay/ring object pinned at
admission, while ``submit_update`` swaps the engine's live pointer to a
clone — so in-flight steps never observe a half-applied update.

C001  step-scope reads of graph state must flow from the pinned
      snapshot (``_Job.ring``/``_Job.ov``/``_Active``'s admission
      snapshot), never from live ``self.eng.*`` fields that
      ``submit_update`` swaps.
C002  every overlay/engine mutation routes through
      ``DeltaOverlay.clone()`` -> ``apply_engine_updates`` — the
      dataflow generalization of lint R005: direct ``.delta``
      reassignment, ``.apply()`` through a local alias of an engine's
      overlay, and a ``submit_update`` missing the COW swap are all
      mutations that in-flight snapshots would observe.
C003  every slot acquisition (``add_slot``/``admit``/``add_job``) is
      matched by a publish or release on all paths, including the
      preemption/exception edges — a refcount leak detector.
C004  a ticket's epoch is assigned exactly once, at admission, and no
      engine mutation (or await) slips between the epoch pin and the
      snapshot the slot will read.
C005  streamed-result state (``reported``/``seen``/``_emitted``) only
      grows: no ``.clear()``/``.remove()``/rebind outside construction
      — dedup against shrinking state would re-stream or drop rows.
C006  no await re-entry window between snapshot/epoch capture and slot
      admission inside async code — another task could mutate the
      engine mid-capture.

Each rule is a generator ``rule(tree, rel, lines) -> Iterable[Finding]``
driven by :mod:`repro_torch.analysis.semantic`.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Sequence, Set

from . import dataflow as df
from .findings import Finding

# C001 -----------------------------------------------------------------
STEP_SCOPE_NAMES = {"step", "_step_impl", "_harvest"}
ENGINE_ALIASES = {"eng", "engine", "rpq"}
LIVE_STATE_ATTRS = {"ring", "delta"}
LIVE_STATE_CALLS = {"_edges", "effective_graph"}

# C003 -----------------------------------------------------------------
ACQUIRE_CALLS = {"add_slot", "admit", "add_job"}
RELEASE_CALLS = {"free_slot", "release", "remove_job"}
PUBLISH_CALLS = {"append", "appendleft", "add", "insert"}
TRACKED_CONTAINERS = {"active", "jobs", "slots"}
RETIRE_FLAGS = {"done", "active"}

# C004 -----------------------------------------------------------------
ENGINE_MUTATORS = {"submit_update", "apply_engine_updates", "add_edges",
                   "remove_edges", "compact", "load_overlay"}

# C005 -----------------------------------------------------------------
MONOTONE_ATTRS = {"reported", "seen", "_emitted"}
SHRINK_METHODS = {"clear", "remove", "discard", "difference_update",
                  "intersection_update", "pop"}

# C006 -----------------------------------------------------------------
ADMISSION_CALLS = {"admit", "add_job", "_admit_one"}


def _is_delta_module(rel: str) -> bool:
    return rel.replace("\\", "/").endswith("core/delta.py")


# ---------------------------------------------------------------------
# C001: step-scope reads must flow from pinned snapshots
# ---------------------------------------------------------------------

def _engine_tainted_names(fn: ast.AST) -> Set[str]:
    """Local names aliasing the live engine inside ``fn``: parameters
    named like an engine, plus assignment chains from ``self.eng``-style
    attributes or other tainted names."""
    tainted: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            if a.arg in ENGINE_ALIASES:
                tainted.add(a.arg)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name, val = node.targets[0].id, node.value
            if name in tainted:
                continue
            if _is_engine_expr(val, tainted):
                tainted.add(name)
                changed = True
    return tainted


def _is_engine_expr(node: ast.expr, tainted: Set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        return (isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in ENGINE_ALIASES)
    return False


def rule_c001(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    hint = ("read graph state from the snapshot pinned at admission "
            "(job.ring/job.ov/slot.edges) — live engine fields are "
            "swapped mid-flight by submit_update")
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        if fn.name not in STEP_SCOPE_NAMES:
            continue
        if not isinstance(df.parent(fn), ast.ClassDef):
            continue  # free functions / jit closures are not step scope
        tainted = _engine_tainted_names(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load) and \
                    node.attr in LIVE_STATE_ATTRS and \
                    _is_engine_expr(node.value, tainted):
                yield Finding(
                    rel, node.lineno, "C001",
                    f"step-scope read of live engine state "
                    f"'.{node.attr}' — in-flight work must use its "
                    "pinned admission snapshot",
                    hint, df.snippet(lines, node.lineno))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in LIVE_STATE_CALLS and \
                    _is_engine_expr(node.func.value, tainted):
                yield Finding(
                    rel, node.lineno, "C001",
                    f"step-scope call '.{node.func.attr}()' resolves "
                    "against live engine state, not the pinned snapshot",
                    hint, df.snippet(lines, node.lineno))


# ---------------------------------------------------------------------
# C002: COW routing — clone() -> apply_engine_updates, nothing else
# ---------------------------------------------------------------------

def _is_clone_of_delta(value: ast.expr) -> bool:
    return (isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "clone"
            and isinstance(value.func.value, ast.Attribute)
            and value.func.value.attr == "delta")


def rule_c002(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    if _is_delta_module(rel):
        return  # the router owns its own internals
    hint = ("swap copy-on-write first (eng.delta = eng.delta.clone()) "
            "and route the mutation through "
            "delta.apply_engine_updates(engine, add, remove)")
    # (a) `.delta` may only be rebound to None (init) or its own clone
    for node in ast.walk(tree):
        targets: List[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for tgt in targets:
            if not (isinstance(tgt, ast.Attribute) and tgt.attr == "delta"):
                continue
            if isinstance(value, ast.Constant) and value.value is None:
                continue
            if _is_clone_of_delta(value):
                continue
            yield Finding(
                rel, node.lineno, "C002",
                "'.delta' rebound to something other than None or "
                "'.delta.clone()' — in-flight snapshots now alias "
                "mutable state",
                hint, df.snippet(lines, node.lineno))
    # (b) `.apply()` through a local alias of an engine overlay — the
    # dataflow hole R005's name list cannot see
    delta_aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Attribute) and \
                node.value.attr == "delta":
            delta_aliases.add(node.targets[0].id)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "apply" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in delta_aliases:
            yield Finding(
                rel, node.lineno, "C002",
                f"overlay .apply() through alias "
                f"'{node.func.value.id}' of an engine's '.delta' — "
                "mutates the overlay in-flight snapshots point at",
                hint, df.snippet(lines, node.lineno))
    # (c) a submit_update that applies without the COW swap
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name == "submit_update"):
            continue
        calls = {df.call_name(c.func) for c in ast.walk(fn)
                 if isinstance(c, ast.Call)}
        if "apply_engine_updates" not in calls:
            continue
        has_swap = any(
            isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Attribute)
            and n.targets[0].attr == "delta"
            and _is_clone_of_delta(n.value)
            for n in ast.walk(fn))
        if not has_swap:
            yield Finding(
                rel, fn.lineno, "C002",
                "submit_update() applies engine updates without first "
                "swapping '.delta' to a clone — in-flight jobs will "
                "observe the mutation",
                hint, df.snippet(lines, fn.lineno))


# ---------------------------------------------------------------------
# C003: slot acquire/release pairing (refcount leak detector)
# ---------------------------------------------------------------------

def _acquire_call(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call)
            and df.call_name(node.func) in ACQUIRE_CALLS)


def _contains_acquire(node: ast.expr) -> bool:
    return any(_acquire_call(n) for n in ast.walk(node))


def _name_in_args(call: ast.Call, holder: str) -> bool:
    for arg in (*call.args, *[kw.value for kw in call.keywords]):
        if isinstance(arg, ast.Name) and arg.id == holder:
            return True
        if isinstance(arg, ast.Attribute) and \
                df.base_name(arg) == holder:
            return True
    return False


def _settles(stmt: ast.stmt, holder: str) -> bool:
    """Does this statement publish, release, or return the holder?"""
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call):
            name = df.call_name(node.func)
            if name in PUBLISH_CALLS | RELEASE_CALLS and \
                    _name_in_args(node, holder):
                return True
        elif isinstance(node, ast.Return) and node.value is not None:
            if any(isinstance(n, ast.Name) and n.id == holder
                   for n in ast.walk(node.value)):
                return True
    return False


def _transfer_target(stmt: ast.stmt, holder: str) -> str:
    """``active = _Active(..., handle=holder, ...)`` moves ownership
    into the constructed object — continue tracking the new name."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
            isinstance(stmt.targets[0], ast.Name) and \
            isinstance(stmt.value, ast.Call) and \
            _name_in_args(stmt.value, holder):
        return stmt.targets[0].id
    return ""


def rule_c003(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    hint = ("pair every slot acquisition with free_slot/release on all "
            "paths (including early returns and exception edges), or "
            "publish the handle to the container the harvest loop "
            "releases from")
    # (a) module-level pairing: an object that acquires slots must also
    # free them somewhere in the module
    acquires: Dict[str, ast.Call] = {}
    releases: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        recv = df.unparse(node.func.value)
        if node.func.attr == "add_slot" and recv not in acquires:
            acquires[recv] = node
        elif node.func.attr == "free_slot":
            releases.add(recv)
    for recv in sorted(set(acquires) - releases):
        call = acquires[recv]
        yield Finding(
            rel, call.lineno, "C003",
            f"'{recv}.add_slot()' has no matching "
            f"'{recv}.free_slot()' anywhere in this module — slot "
            "refcounts can only grow",
            hint, df.snippet(lines, call.lineno))
    # (b) path check: between acquiring a handle and settling it
    # (publish/release/return), an early return/raise leaks the slot
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stmts = df.func_statements(fn)
        for i, stmt in enumerate(stmts):
            # only *captured* acquisitions need settling: a bare
            # `stepper.add_job(job)` hands ownership to the callee, and
            # `return self.stepper.add_job(...)` hands it to the caller
            holder = ""
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and _contains_acquire(stmt.value):
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name):
                    holder = tgt.id
                elif isinstance(tgt, ast.Attribute):
                    holder = df.base_name(tgt)
            if not holder:
                continue
            settled = False
            for later in stmts[i + 1:]:
                if _settles(later, holder):
                    settled = True
                    break
                moved = _transfer_target(later, holder)
                if moved:
                    holder = moved
                    continue
                if isinstance(later, (ast.Return, ast.Raise)):
                    yield Finding(
                        rel, later.lineno, "C003",
                        f"early exit between acquiring slot handle "
                        f"'{holder}' (line {stmt.lineno}) and "
                        "publishing/releasing it — the refcount leaks "
                        "on this path",
                        hint, df.snippet(lines, later.lineno))
                    settled = True  # report once per acquisition
                    break
            if not settled:
                yield Finding(
                    rel, stmt.lineno, "C003",
                    f"slot handle '{holder}' is acquired but never "
                    "published to a tracked container or released in "
                    "this function",
                    hint, df.snippet(lines, stmt.lineno))
    # (c) removal from a tracked container without a preceding release
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "remove"
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr in TRACKED_CONTAINERS
                    and node.args
                    and isinstance(node.args[0], ast.Name)):
                continue
            victim = node.args[0].id
            released = False
            for other in ast.walk(fn):
                if getattr(other, "lineno", 1 << 31) >= node.lineno:
                    continue
                if isinstance(other, ast.Call) and \
                        df.call_name(other.func) in RELEASE_CALLS and \
                        _name_in_args(other, victim):
                    released = True
                elif isinstance(other, ast.Assign) and \
                        len(other.targets) == 1 and \
                        isinstance(other.targets[0], ast.Attribute) and \
                        other.targets[0].attr in RETIRE_FLAGS and \
                        df.base_name(other.targets[0]) == victim and \
                        isinstance(other.value, ast.Constant):
                    released = True
            if not released:
                yield Finding(
                    rel, node.lineno, "C003",
                    f"'.{node.func.value.attr}.remove({victim})' "
                    "without releasing the slot first — the handle's "
                    "refcount (and its plane rows) leak",
                    hint, df.snippet(lines, node.lineno))


# ---------------------------------------------------------------------
# C004: epoch pinned once, at admission, beside its snapshot
# ---------------------------------------------------------------------

def _ticketish(recv: ast.expr) -> bool:
    """Does this expression look like a query ticket?  (``ticket``,
    ``self.ticket``, ``a.ticket`` ...)"""
    if isinstance(recv, ast.Name):
        return "ticket" in recv.id
    if isinstance(recv, ast.Attribute):
        return "ticket" in recv.attr
    return False


def rule_c004(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    if _is_delta_module(rel):
        return  # the overlay's own epoch bookkeeping lives there
    hint = ("pin ticket.epoch exactly once, inside the admission path, "
            "with no engine mutation between the epoch read and the "
            "snapshot() the slot will compute against")
    epoch_assigns: List[ast.stmt] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            # ticket epochs only — `stats.epoch = ...` telemetry
            # recording is not an admission pin
            if not any(isinstance(t, ast.Attribute) and t.attr == "epoch"
                       and _ticketish(t.value) for t in targets):
                continue
            fn = df.enclosing_function(node)
            fn_name = getattr(fn, "name", "")
            if "admit" not in fn_name and fn_name != "__init__":
                yield Finding(
                    rel, node.lineno, "C004",
                    f"ticket epoch assigned outside an admission path "
                    f"(in '{fn_name or '<module>'}') — the epoch must "
                    "be pinned exactly once, at admission",
                    hint, df.snippet(lines, node.lineno))
            elif fn is not None:
                epoch_assigns.append(node)
    # mutation/await between the epoch pin and the snapshot capture
    for assign in epoch_assigns:
        fn = df.enclosing_function(assign)
        snaps = [n.lineno for n in ast.walk(fn)
                 if isinstance(n, ast.Call)
                 and df.call_name(n.func) == "snapshot"
                 and n.lineno > assign.lineno]
        if not snaps:
            continue
        lo, hi = assign.lineno, min(snaps)
        for node in ast.walk(fn):
            line = getattr(node, "lineno", 0)
            if not lo < line <= hi:
                continue
            if isinstance(node, ast.Await):
                yield Finding(
                    rel, line, "C004",
                    "await between the epoch pin and the snapshot "
                    "capture — another task can mutate the engine here",
                    hint, df.snippet(lines, line))
            elif isinstance(node, ast.Call) and \
                    df.call_name(node.func) in ENGINE_MUTATORS:
                yield Finding(
                    rel, line, "C004",
                    f"engine mutation '{df.call_name(node.func)}()' "
                    "between the epoch pin and the snapshot capture — "
                    "the recorded epoch no longer matches the snapshot "
                    "the slot reads",
                    hint, df.snippet(lines, line))


# ---------------------------------------------------------------------
# C005: streamed-result state only grows
# ---------------------------------------------------------------------

def rule_c005(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    hint = ("streamed-dedup state must be append-only (use |=, .add, "
            ".update); shrinking or rebinding it re-streams rows "
            "already delivered to clients")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in SHRINK_METHODS and \
                isinstance(node.func.value, ast.Attribute) and \
                node.func.value.attr in MONOTONE_ATTRS:
            yield Finding(
                rel, node.lineno, "C005",
                f"'.{node.func.value.attr}.{node.func.attr}()' shrinks "
                "streamed-result state — results already emitted would "
                "stream again",
                hint, df.snippet(lines, node.lineno))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if not (isinstance(tgt, ast.Attribute)
                        and tgt.attr in MONOTONE_ATTRS):
                    continue
                fn = df.enclosing_function(node)
                if getattr(fn, "name", "") == "__init__":
                    continue  # construction, not a reset
                yield Finding(
                    rel, node.lineno, "C005",
                    f"'.{tgt.attr}' rebound outside __init__ — "
                    "streamed-result state must only grow",
                    hint, df.snippet(lines, node.lineno))


# ---------------------------------------------------------------------
# C006: no await window between capture and admission (async)
# ---------------------------------------------------------------------

def rule_c006(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    hint = ("capture the snapshot/epoch and admit in one synchronous "
            "block — an await in between yields to tasks that may "
            "submit_update and shift the epoch under the capture")
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        captures = [n.lineno for n in ast.walk(fn)
                    if (isinstance(n, ast.Call)
                        and df.call_name(n.func) == "snapshot")
                    or (isinstance(n, ast.Attribute)
                        and n.attr == "epoch"
                        and isinstance(n.ctx, ast.Load))]
        uses = [n.lineno for n in ast.walk(fn)
                if isinstance(n, ast.Call)
                and df.call_name(n.func) in ADMISSION_CALLS]
        if not captures or not uses:
            continue
        flagged: Set[int] = set()
        for cap in captures:
            for use in uses:
                if use <= cap:
                    continue
                for node in ast.walk(fn):
                    line = getattr(node, "lineno", 0)
                    if isinstance(node, ast.Await) and \
                            cap < line <= use and line not in flagged:
                        flagged.add(line)
                        yield Finding(
                            rel, line, "C006",
                            "await between snapshot/epoch capture "
                            f"(line {cap}) and admission (line {use}) "
                            "— re-entry can mutate the engine inside "
                            "the capture window",
                            hint, df.snippet(lines, line))


C_RULES = (rule_c001, rule_c002, rule_c003, rule_c004, rule_c005,
           rule_c006)
