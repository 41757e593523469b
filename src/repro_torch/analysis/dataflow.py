"""Shared AST dataflow infrastructure for the semantic layer (layer 3).

The C/B rules in :mod:`consistency` and :mod:`bounds` are
*intraprocedural dataflow* checks, not syntax greps, so they share a
small toolkit here:

* parent links + enclosing-scope lookups (the lint layer re-exports the
  same helpers so both layers agree on AST topology);
* the ``# repro: noqa`` regex, widened to accept C/B/T rule ids next to
  the lint layer's R ids;
* :class:`Interval` / :class:`IntervalScope` — a conservative interval
  evaluator over a function body used by the bounds rules (B001-B004).
  It resolves single-assignment locals, ``for v in range(C)`` loop
  variables, ``w, b = divmod(x, K)`` word splits, ``& mask`` clamps and
  dtype casts.  Anything it cannot prove evaluates to ``None`` — rules
  must treat "unknown" as "do not flag" (or flag explicitly when the
  contract demands a proof).

Every interval carries three provenance bits that the rules dispatch on:

``loopish``   the value derives from loop structure (a ``range()`` loop
              variable or a ``divmod`` word split) — B004 territory;
``dimful``    the value derives from a dictionary-size attribute
              (``num_nodes`` / ``num_preds`` / ...);
``dataful``   the value derives from a data symbol bounded by one of
              those dictionary sizes (a node id, a predicate id).
B001 only reasons about expressions that are both dimful and dataful —
that is what a packed key looks like.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Set

# Widened from the lint layer's R-only pattern: one shared suppression
# syntax across all analyzer layers.
NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa\s+([RCBT]\d{3}(?:\s*,\s*[RCBT]\d{3})*)")


def attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._repro_parent = node  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_repro_parent", None)


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parent(cur)
    return None


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = parent(cur)
    return None


def call_name(func: ast.expr) -> str:
    """Trailing identifier of a call target (`f` for f(...), `m` for
    obj.m(...)); empty string for anything fancier."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def noqa_rules(source_lines: Sequence[str], lineno: int) -> Set[str]:
    if not (1 <= lineno <= len(source_lines)):
        return set()
    m = NOQA_RE.search(source_lines[lineno - 1])
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",")}


def snippet(source_lines: Sequence[str], lineno: int) -> str:
    if 1 <= lineno <= len(source_lines):
        return source_lines[lineno - 1].strip()
    return ""


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def base_name(node: ast.expr) -> str:
    """Leftmost Name of an attribute/subscript chain (``a`` for
    ``a.b.c[i]``); empty string otherwise."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return ""


def func_statements(fn: ast.AST) -> List[ast.stmt]:
    """All statements in a function body (nested suites flattened),
    sorted by source position — the path approximation used by the
    leak-on-early-exit rule (C003)."""
    stmts = [n for n in ast.walk(fn)
             if isinstance(n, ast.stmt) and n is not fn
             and enclosing_function(n) is fn]
    return sorted(stmts, key=lambda s: (s.lineno, s.col_offset))


# ---------------------------------------------------------------------
# interval evaluation
# ---------------------------------------------------------------------

class Interval(NamedTuple):
    lo: int
    hi: int
    loopish: bool = False
    dimful: bool = False
    dataful: bool = False

    def tag(self, **kw) -> "Interval":
        return self._replace(**{k: v or getattr(self, k)
                                for k, v in kw.items()})


def _merge_flags(*ivs: Interval) -> Dict[str, bool]:
    return {
        "loopish": any(i.loopish for i in ivs),
        "dimful": any(i.dimful for i in ivs),
        "dataful": any(i.dataful for i in ivs),
    }


def _combine(a: Interval, b: Interval, op) -> Interval:
    vals = [op(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(vals), max(vals), **_merge_flags(a, b))


# Calls that pass their argument's value through unchanged (dtype casts
# and array wrappers); ``.astype`` receivers are handled separately.
_PASSTHROUGH_CALLS = {
    "int", "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64", "asarray", "array",
}

class IntervalScope:
    """Interval environment for one function body.

    ``dim_bounds``  maps *attribute names* (``num_nodes``, ...) to their
                    declared inclusive upper bound; a bare read of such
                    an attribute evaluates to ``[1, bound]`` tagged
                    dimful.
    ``data_bounds`` maps *plain names* (``s``, ``o``, ``p``, ...) to an
                    exclusive-bound attribute name: the symbol is a
                    member of that dictionary, so it evaluates to
                    ``[0, dim_bounds[attr] - 1]`` tagged dataful.  The
                    seed applies only to names the function never
                    rebinds (params and free names) — an assigned local
                    always follows its assignment.
    """

    def __init__(self, fn: ast.AST,
                 dim_bounds: Optional[Dict[str, int]] = None,
                 data_bounds: Optional[Dict[str, str]] = None):
        self.fn = fn
        self.dim_bounds = dict(dim_bounds or {})
        self.data_bounds = dict(data_bounds or {})
        # name -> list of bound value expressions (only single-binding
        # names resolve); divmod splits and range loops are special.
        self.bindings: Dict[str, List[ast.expr]] = {}
        self.range_vars: Dict[str, ast.Call] = {}
        self.divmod_rem: Dict[str, int] = {}    # name -> split width K
        self.divmod_quot: Dict[str, ast.expr] = {}
        self._memo: Dict[int, Optional[Interval]] = {}
        self._stack: Set[str] = set()
        self._collect()

    # -- environment construction ------------------------------------
    def _bind(self, name: str, value: ast.expr) -> None:
        self.bindings.setdefault(name, []).append(value)

    def _collect(self) -> None:
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
                if isinstance(tgt, ast.Name):
                    if (isinstance(val, ast.Call)
                            and call_name(val.func) == "divmod"):
                        continue  # malformed single-target divmod: skip
                    self._bind(tgt.id, val)
                elif isinstance(tgt, ast.Tuple):
                    if (isinstance(val, ast.Call)
                            and call_name(val.func) == "divmod"
                            and len(tgt.elts) == 2
                            and len(val.args) == 2):
                        q, r = tgt.elts
                        k = val.args[1]
                        if (isinstance(k, ast.Constant)
                                and isinstance(k.value, int)):
                            if isinstance(r, ast.Name):
                                self.divmod_rem[r.id] = k.value
                            if isinstance(q, ast.Name):
                                self.divmod_quot[q.id] = val.args[0]
                    elif (isinstance(val, ast.Tuple)
                          and len(val.elts) == len(tgt.elts)):
                        for t, v in zip(tgt.elts, val.elts):
                            if isinstance(t, ast.Name):
                                self._bind(t.id, v)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                # any augmented assignment makes the name multi-bound
                self._bind(node.target.id, node)  # type: ignore[arg-type]
            elif isinstance(node, ast.For) and \
                    isinstance(node.target, ast.Name) and \
                    isinstance(node.iter, ast.Call) and \
                    call_name(node.iter.func) == "range":
                self.range_vars[node.target.id] = node.iter

    # -- evaluation ---------------------------------------------------
    def lookup(self, name: str) -> Optional[Interval]:
        if name in self._stack:
            return None  # cycle
        binds = self.bindings.get(name)
        if binds is not None:
            if len(binds) != 1 or isinstance(binds[0], ast.AugAssign):
                return None  # multi-bound: no single value to reason on
            self._stack.add(name)
            try:
                return self.eval(binds[0])
            finally:
                self._stack.discard(name)
        if name in self.divmod_rem:
            k = self.divmod_rem[name]
            if k < 1:
                return None
            return Interval(0, k - 1, loopish=True)
        if name in self.divmod_quot:
            self._stack.add(name)
            try:
                base = self.eval(self.divmod_quot[name])
            finally:
                self._stack.discard(name)
            if base is None or base.lo < 0:
                return None
            # need the K it was split by — find any divmod binding pair
            return None if base is None else Interval(
                0, base.hi, loopish=True)
        if name in self.range_vars:
            rng = self.range_vars[name]
            iv = self._range_interval(rng)
            return iv.tag(loopish=True) if iv else None
        if name in self.data_bounds:
            dim_attr = self.data_bounds[name]
            bound = self.dim_bounds.get(dim_attr)
            if bound:
                return Interval(0, bound - 1, dataful=True)
        if name in self.dim_bounds:
            return Interval(1, self.dim_bounds[name], dimful=True)
        return None

    def _range_interval(self, rng: ast.Call) -> Optional[Interval]:
        args = [self.eval(a) for a in rng.args]
        if len(args) == 1 and args[0] is not None:
            return Interval(0, max(0, args[0].hi - 1))
        if len(args) == 2 and all(a is not None for a in args):
            return Interval(args[0].lo, max(args[0].lo, args[1].hi - 1))
        return None

    def eval(self, node: ast.expr) -> Optional[Interval]:
        key = id(node)
        if key in self._memo:
            return self._memo[key]
        self._memo[key] = None  # cycle guard
        iv = self._eval(node)
        self._memo[key] = iv
        return iv

    def _eval(self, node: ast.expr) -> Optional[Interval]:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or \
                    not isinstance(node.value, int):
                return None
            return Interval(node.value, node.value)
        if isinstance(node, ast.Name):
            return self.lookup(node.id)
        if isinstance(node, ast.Attribute):
            bound = self.dim_bounds.get(node.attr)
            if bound:
                return Interval(1, bound, dimful=True)
            return None
        if isinstance(node, ast.Subscript):
            return self.eval(node.value)  # indexing keeps element bounds
        if isinstance(node, ast.IfExp):
            a, b = self.eval(node.body), self.eval(node.orelse)
            if a is None or b is None:
                return None
            return Interval(min(a.lo, b.lo), max(a.hi, b.hi),
                            **_merge_flags(a, b))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            iv = self.eval(node.operand)
            if iv is None:
                return None
            return Interval(-iv.hi, -iv.lo, iv.loopish, iv.dimful,
                            iv.dataful)
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        if isinstance(node, ast.BinOp):
            return self._eval_binop(node)
        return None

    def _eval_call(self, node: ast.Call) -> Optional[Interval]:
        name = call_name(node.func)
        if name == "arange" and node.args:
            stop = self.eval(node.args[0])
            if stop is not None and len(node.args) == 1:
                return Interval(0, max(0, stop.hi - 1))
            return None
        if name == "astype" and isinstance(node.func, ast.Attribute):
            return self.eval(node.func.value)
        if name in _PASSTHROUGH_CALLS and node.args:
            return self.eval(node.args[0])
        if name in {"min", "max"} and len(node.args) >= 2:
            ivs = [self.eval(a) for a in node.args]
            if any(i is None for i in ivs):
                return None
            pick = min if name == "min" else max
            return Interval(pick(i.lo for i in ivs),
                            pick(i.hi for i in ivs),
                            **_merge_flags(*ivs))
        return None

    def _eval_binop(self, node: ast.BinOp) -> Optional[Interval]:
        a, b = self.eval(node.left), self.eval(node.right)
        if isinstance(node.op, ast.BitAnd):
            # x & C clamps to [0, C] for any x when C >= 0 — this is the
            # in-word index idiom (i & 31), provable without knowing x.
            for mask, other in ((b, a), (a, b)):
                if mask is not None and mask.lo == mask.hi and \
                        mask.lo >= 0:
                    flags = _merge_flags(mask, other) if other else \
                        _merge_flags(mask)
                    return Interval(0, mask.lo, **flags)
            return None
        if a is None or b is None:
            return None
        if isinstance(node.op, ast.Add):
            return _combine(a, b, lambda x, y: x + y)
        if isinstance(node.op, ast.Sub):
            return _combine(a, b, lambda x, y: x - y)
        if isinstance(node.op, ast.Mult):
            return _combine(a, b, lambda x, y: x * y)
        if isinstance(node.op, ast.FloorDiv):
            if b.lo <= 0:
                return None
            return _combine(a, b, lambda x, y: x // y)
        if isinstance(node.op, ast.Mod):
            if b.lo <= 0:
                return None
            return Interval(0, b.hi - 1, **_merge_flags(a, b))
        if isinstance(node.op, ast.LShift):
            if b.lo < 0 or b.hi > 128:
                return None
            return _combine(a, b, lambda x, y: x << y)
        if isinstance(node.op, ast.BitOr):
            if a.lo < 0 or b.lo < 0:
                return None
            # |x|y| <= x+y for non-negatives — loose but sound
            return Interval(max(a.lo, b.lo), a.hi + b.hi,
                            **_merge_flags(a, b))
        return None
