"""Repo-specific AST lint rules (layer 2 of the static analyzer), over
the port's own tree.

The JAX package's rules, translated to the port's idioms: torch's host
syncs for R002, the port's ``KERNELS`` and its CPU and card tests for
R003, ``msgpack`` for R004, and ``src/repro_torch/core/`` as R006's and
R007's scope.  Seven rules encode invariants that ordinary linters
cannot see because they are about *this* codebase's determinism and
device-dispatch contracts:

R001  nondeterministic iteration: a Python ``set`` iterated in an
      order-sensitive position (list construction, ``np.fromiter``,
      generator feeding an ordered consumer).  Sets hash-order their
      elements, so results built from them differ run-to-run — which
      breaks result determinism and, worse, jit cache keys.  Dict
      iteration is exempt (insertion-ordered since 3.7); wrap set
      iteration in ``sorted(...)`` instead.
R002  host sync inside a wavefront superstep loop: torch's ``.item()``,
      ``.tolist()``, ``.cpu()``, ``.numpy()``,
      ``torch.cuda.synchronize()`` or ``<event>.synchronize()``,
      ``np.asarray(...)``, or ``bool/int/float(<tensor>)`` in the body
      of a ``while`` loop that dispatches step/chunk work.  Each such
      call blocks the host on the device queue, serialising supersteps.
      The loop *test* is exempt — the convergence check is the one
      designed sync point per iteration.
R003  kernel parity completeness: every kernel named in
      ``src/repro_torch/kernels/__init__.KERNELS`` must have a plain
      version ``<name>_ref`` in ``kernels/ref.py``, a CPU test in
      ``tests/test_torch_kernels.py`` referencing it, and a card test in
      ``tests/test_torch_cuda.py`` referencing the kernel.
R004  optional-dependency imports at module top level: ``hypothesis``,
      ``zstandard`` and ``msgpack`` must be imported behind the repo's
      try/except shim pattern (or inside a function), so minimal
      installs (the GPU machine has neither of the last two) still
      import cleanly.
R005  engine mutation bypassing the delta overlay router: all edge
      add/remove paths outside ``core/delta.py`` must go through
      ``delta.apply_engine_updates`` — direct overlay mutation skips
      epoch bumps and cache invalidation.
R006  raw wall-clock reads (``time.perf_counter()`` /
      ``time.monotonic()``) inside an engine/scheduler superstep loop
      (``src/repro_torch/core/`` only): ad-hoc timing there is invisible
      to the obs layer — route it through
      ``repro_torch.obs.trace.span(...)``
      (attributable, exportable, free when disabled) or the scheduler's
      injectable ``clock``.
R007  ad-hoc per-superstep counters: a ``+=`` into a subscripted
      counter-ish dict (name contains ``count``/``counter``/``tally``/
      ``metric``) inside a dispatching ``while`` loop in
      ``src/repro_torch/core/``.  Such tallies are invisible to
      ``prometheus_text()``, the flight recorder, and ANALYZE — route
      them through the obs registry (``self.metrics.counter(...)``) or
      the per-query ``QueryStats``.

Findings can be suppressed inline with ``# repro: noqa R00X`` on the
flagged line (justification after an em-dash is encouraged), or
grandfathered via the checked-in baseline (see ``findings.py``).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import dataflow as _df
from .findings import Finding

# Directories (and files) the gate lints by default (repo-relative):
# the port's counterparts of the JAX package's.  ``examples/`` holds the
# counterparts of ``examples/quickstart.py`` and
# ``examples/wikidata_style_queries.py``; ``launch/path_lm.py`` is
# ``examples/train_path_lm.py``'s, and ``serve.py`` is
# ``examples/serve_rpq.py``'s.  tests/ are deliberately out of scope:
# they may poke internals (e.g. the delta overlay) to assert on them.
DEFAULT_LINT_DIRS = (
    "src/repro_torch/core",
    "src/repro_torch/kernels",
    "src/repro_torch/analysis",
    "src/repro_torch/obs",
    "src/repro_torch/launch",
    "src/repro_torch/examples",
    "src/repro_torch/serve.py",
)

# Shared with the semantic layer (dataflow.NOQA_RE): one suppression
# syntax accepting R (lint), C/B (semantic), and T (trace) rule ids.
_NOQA_RE = _df.NOQA_RE

# R001 -----------------------------------------------------------------
# Calls whose argument order does not matter — a ListComp/GeneratorExp
# directly inside one of these is not order-sensitive.
_ORDER_EXEMPT_WRAPPERS = {
    "sorted", "set", "frozenset", "sum", "min", "max", "any", "all", "len",
}
# Consumers that materialise a generator in iteration order.
_ORDERED_GEN_CONSUMERS = {
    "list", "tuple", "enumerate", "fromiter", "asarray", "array", "join",
    "stack", "concatenate",
}

# R002 -----------------------------------------------------------------
_HOST_SYNC_NP_FUNCS = {"asarray", "array"}
_NP_MODULE_NAMES = {"np", "numpy", "onp"}
# tensor methods that copy to the host (``.item()`` is the reference's)
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

# R005 -----------------------------------------------------------------
_OVERLAY_MUTATORS = {
    "_add_completed", "_remove_completed", "_insert_extra", "_insert_tomb",
    "_drop_extra", "_drop_tomb",
}
_OVERLAY_RECEIVER_NAMES = {"ov", "overlay", "delta"}

# R004 -----------------------------------------------------------------
# ``msgpack`` takes the place of the JAX package's
# ``jax.experimental.shard_map``, which the port never imports
_OPTIONAL_MODULES = {"hypothesis", "zstandard", "msgpack"}


# AST topology + suppression helpers shared with the semantic layer.
_call_name = _df.call_name
_attach_parents = _df.attach_parents
_parent = _df.parent
_noqa_rules = _df.noqa_rules
_snippet = _df.snippet


# ---------------------------------------------------------------------
# R001: set-typed expression inference
# ---------------------------------------------------------------------

def _ann_str(node: Optional[ast.expr]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def _is_set_annotation(ann: str) -> bool:
    return ann.startswith(("Set[", "set[", "typing.Set[", "FrozenSet[",
                           "frozenset["))


def _is_dict_of_set_annotation(ann: str) -> bool:
    if not ann.startswith(("Dict[", "dict[", "typing.Dict[",
                           "DefaultDict[", "defaultdict[")):
        return False
    return "Set[" in ann or "set[" in ann


class _ClassAttrKinds:
    """Per-class map of ``self.<attr>`` names known to hold sets, or
    dicts whose *values* are sets (so ``self.x[k]`` / ``self.x.get(k)``
    yields a set)."""

    def __init__(self, cls: ast.ClassDef):
        self.set_attrs: Set[str] = set()
        self.dict_of_set_attrs: Set[str] = set()
        for node in ast.walk(cls):
            # self.x: Set[...] = ...   /   self.x: Dict[..., Set[...]]
            if isinstance(node, ast.AnnAssign):
                target = node.target
                name = None
                if isinstance(target, ast.Attribute) and \
                        isinstance(target.value, ast.Name) and \
                        target.value.id == "self":
                    name = target.attr
                elif isinstance(target, ast.Name) and \
                        _parent(node) is cls:
                    name = target.id
                if name:
                    ann = _ann_str(node.annotation)
                    if _is_set_annotation(ann):
                        self.set_attrs.add(name)
                    elif _is_dict_of_set_annotation(ann):
                        self.dict_of_set_attrs.add(name)
            # self.x = set()  (un-annotated)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if isinstance(target, ast.Attribute) and \
                        isinstance(target.value, ast.Name) and \
                        target.value.id == "self" and \
                        _is_set_literalish(node.value):
                    self.set_attrs.add(target.attr)


def _is_set_literalish(node: ast.expr) -> bool:
    """Syntactically-evident set construction (no inference needed)."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and \
            _call_name(node.func) in {"set", "frozenset"}:
        return True
    return False


def _is_set_expr(node: ast.expr, local_sets: Set[str],
                 attrs: Optional[_ClassAttrKinds]) -> bool:
    if _is_set_literalish(node):
        return True
    if isinstance(node, ast.Name):
        return node.id in local_sets
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self" \
            and attrs is not None:
        return node.attr in attrs.set_attrs
    # self.x[k] where x: Dict[..., Set[...]]
    if isinstance(node, ast.Subscript):
        base = node.value
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and base.value.id == "self" \
                and attrs is not None:
            return base.attr in attrs.dict_of_set_attrs
        return False
    # self.x.get(k, ...) on a dict-of-set attribute
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr == "get":
            base = node.func.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and attrs is not None:
                return base.attr in attrs.dict_of_set_attrs
        # set ops returning sets: a.union(b), a.intersection(b), ...
        if node.func.attr in {"union", "intersection", "difference",
                              "symmetric_difference"}:
            return _is_set_expr(node.func.value, local_sets, attrs)
    # set algebra: (a | b) where either side is a set
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
        return (_is_set_expr(node.left, local_sets, attrs) or
                _is_set_expr(node.right, local_sets, attrs))
    return False


def _collect_local_sets(fn: ast.AST) -> Set[str]:
    """Names assigned an evidently-set value anywhere in the function."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _is_set_literalish(node.value):
            names.add(node.targets[0].id)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                _is_set_annotation(_ann_str(node.annotation)):
            names.add(node.target.id)
    return names


_enclosing_class = _df.enclosing_class
_enclosing_function = _df.enclosing_function


def _for_body_is_order_sensitive(for_node: ast.For) -> bool:
    """A for-over-set is flagged only when the body visibly builds an
    ordered result: append/extend on something, or a yield."""
    for node in ast.walk(for_node):
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(node, ast.Call) and \
                _call_name(node.func) in {"append", "extend"}:
            return True
    return False


def _rule_r001(tree: ast.Module, rel: str,
               lines: Sequence[str]) -> Iterable[Finding]:
    attr_cache: Dict[int, _ClassAttrKinds] = {}
    fn_cache: Dict[int, Set[str]] = {}

    def env_for(node: ast.AST) -> Tuple[Set[str], Optional[_ClassAttrKinds]]:
        fn = _enclosing_function(node)
        local = set()
        if fn is not None:
            key = id(fn)
            if key not in fn_cache:
                fn_cache[key] = _collect_local_sets(fn)
            local = fn_cache[key]
        cls = _enclosing_class(node)
        attrs = None
        if cls is not None:
            key = id(cls)
            if key not in attr_cache:
                attr_cache[key] = _ClassAttrKinds(cls)
            attrs = attr_cache[key]
        return local, attrs

    hint = ("iterate sorted(<set>) (or restructure to a list/dict) so "
            "results and jit keys do not depend on hash order")

    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            local, attrs = env_for(node)
            if _is_set_expr(node.iter, local, attrs) and \
                    _for_body_is_order_sensitive(node):
                yield Finding(rel, node.lineno, "R001",
                              "iterating a set in an order-sensitive loop "
                              "(body appends/yields)",
                              hint, _snippet(lines, node.lineno))
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            gens = node.generators
            if not gens:
                continue
            local, attrs = env_for(node)
            if not _is_set_expr(gens[0].iter, local, attrs):
                continue
            parent = _parent(node)
            wrapper = ""
            if isinstance(parent, ast.Call):
                wrapper = _call_name(parent.func)
            if isinstance(node, ast.ListComp):
                if wrapper in _ORDER_EXEMPT_WRAPPERS:
                    continue
                yield Finding(rel, node.lineno, "R001",
                              "list built by iterating a set — element "
                              "order is hash-dependent",
                              hint, _snippet(lines, node.lineno))
            else:  # GeneratorExp: only flag when fed to an ordered consumer
                if wrapper in _ORDERED_GEN_CONSUMERS and \
                        wrapper not in _ORDER_EXEMPT_WRAPPERS:
                    yield Finding(rel, node.lineno, "R001",
                                  f"set iterated through a generator into "
                                  f"ordered consumer {wrapper}()",
                                  hint, _snippet(lines, node.lineno))


# ---------------------------------------------------------------------
# R002: host sync inside superstep loops
# ---------------------------------------------------------------------

def _is_dispatch_name(name: str) -> bool:
    return ("step" in name or "chunk" in name or name.startswith("_bfs"))


def _is_synchronize(call: ast.Call) -> bool:
    """``torch.cuda.synchronize()``, ``<stream or event>.synchronize()``
    and the bare ``synchronize()`` of ``from torch.cuda import ...``."""
    return _call_name(call.func) == "synchronize"


def _rule_r002(tree: ast.Module, rel: str,
               lines: Sequence[str]) -> Iterable[Finding]:
    hint = ("move the sync out of the loop (or into the loop *test*, the "
            "designed once-per-iteration sync point); keep intermediate "
            "values on device")
    for node in ast.walk(tree):
        if not isinstance(node, ast.While):
            continue
        body_calls = [c for stmt in node.body for c in ast.walk(stmt)
                      if isinstance(c, ast.Call)]
        if not any(_is_dispatch_name(_call_name(c.func)) for c in body_calls):
            continue
        for call in body_calls:
            name = _call_name(call.func)
            if name in _HOST_SYNC_METHODS and \
                    isinstance(call.func, ast.Attribute) and \
                    not (isinstance(call.func.value, ast.Name) and
                         call.func.value.id in _NP_MODULE_NAMES):
                yield Finding(rel, call.lineno, "R002",
                              f".{name}() host sync inside a superstep loop",
                              hint, _snippet(lines, call.lineno))
            elif _is_synchronize(call):
                yield Finding(rel, call.lineno, "R002",
                              f"{_df.unparse(call.func)}() blocks the host "
                              "on the device inside a superstep loop",
                              hint, _snippet(lines, call.lineno))
            elif name in _HOST_SYNC_NP_FUNCS and \
                    isinstance(call.func, ast.Attribute) and \
                    isinstance(call.func.value, ast.Name) and \
                    call.func.value.id in _NP_MODULE_NAMES:
                yield Finding(rel, call.lineno, "R002",
                              f"np.{name}() device->host transfer inside a "
                              "superstep loop",
                              hint, _snippet(lines, call.lineno))
            elif name in {"bool", "int", "float"} and \
                    isinstance(call.func, ast.Name) and call.args and \
                    not isinstance(call.args[0], ast.Constant):
                yield Finding(rel, call.lineno, "R002",
                              f"{name}(...) forces a host sync on a device "
                              "value inside a superstep loop",
                              hint, _snippet(lines, call.lineno))


# ---------------------------------------------------------------------
# R003: kernel parity completeness (repo-level, not per-file)
# ---------------------------------------------------------------------

KERNELS_INIT = "src/repro_torch/kernels/__init__.py"
KERNELS_REF = "src/repro_torch/kernels/ref.py"
# the CPU suite that holds each plain version to the JAX package, and the
# card suite that holds each kernel to its plain version
CPU_KERNEL_TESTS = "tests/test_torch_kernels.py"
CARD_KERNEL_TESTS = "tests/test_torch_cuda.py"


def _kernel_names(kernels_init: Path) -> Tuple[int, List[str]]:
    """(lineno, names) of ``KERNELS``: a literal, or ``tuple(<name>)``
    of a module-level literal (the port's ``tuple(KERNEL_MODULES)``, a
    dict whose keys are the names); (0, []) if absent or not that."""
    tree = ast.parse(kernels_init.read_text())
    literals: Dict[str, ast.expr] = {}
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if t.id != "KERNELS":
                literals[t.id] = node.value
                continue
            value = node.value
            if isinstance(value, ast.Call) and \
                    _call_name(value.func) == "tuple" and \
                    len(value.args) == 1 and \
                    isinstance(value.args[0], ast.Name):
                value = literals.get(value.args[0].id, value)
            try:
                names = list(ast.literal_eval(value))
            except (ValueError, TypeError):
                return node.lineno, []
            return node.lineno, [str(n) for n in names]
    return 0, []


def _text(path: Path) -> str:
    return path.read_text() if path.is_file() else ""


def _rule_r003(root: Path) -> Iterable[Finding]:
    kernels_init = root / KERNELS_INIT
    ref_py = root / KERNELS_REF
    if not kernels_init.exists():
        return
    lineno, names = _kernel_names(kernels_init)
    if not names:
        yield Finding(KERNELS_INIT, lineno, "R003",
                      "KERNELS tuple missing or not a literal — the "
                      "kernel-parity contract has no anchor",
                      "declare KERNELS = (\"kernel1\", ...) as a plain "
                      "literal, or tuple() of one", "KERNELS missing")
        return
    ref_defs: Set[str] = set()
    if ref_py.exists():
        for node in ast.walk(ast.parse(ref_py.read_text())):
            if isinstance(node, ast.FunctionDef):
                ref_defs.add(node.name)
    cpu_text = _text(root / CPU_KERNEL_TESTS)
    card_text = _text(root / CARD_KERNEL_TESTS)
    snippet_lines = kernels_init.read_text().splitlines()
    snip = _snippet(snippet_lines, lineno)
    for name in names:
        oracle = f"{name}_ref"
        if oracle not in ref_defs:
            yield Finding(KERNELS_INIT, lineno, "R003",
                          f"kernel '{name}' has no plain version "
                          f"'{oracle}' in kernels/ref.py",
                          f"add {oracle}(...) to kernels/ref.py",
                          f"{snip}::{oracle}:missing-ref")
        elif oracle not in cpu_text:
            yield Finding(KERNELS_INIT, lineno, "R003",
                          f"kernel '{name}' plain version '{oracle}' is "
                          f"never referenced by {CPU_KERNEL_TESTS}",
                          f"add a CPU test holding ref.{oracle} to the "
                          "JAX package's function",
                          f"{snip}::{oracle}:missing-test")
        elif f"{name}_cuda" not in card_text and \
                f"ops.{name}(" not in card_text:
            yield Finding(KERNELS_INIT, lineno, "R003",
                          f"kernel '{name}' has no card test in "
                          f"{CARD_KERNEL_TESTS} (no reference to "
                          f"'{name}_cuda' or 'ops.{name}(')",
                          f"add a cuda-marked test holding {name}_cuda to "
                          f"ref.{oracle}",
                          f"{snip}::{name}:missing-card-test")


# ---------------------------------------------------------------------
# R004: optional-dep imports at module top level
# ---------------------------------------------------------------------

def _rule_r004(tree: ast.Module, rel: str,
               lines: Sequence[str]) -> Iterable[Finding]:
    hint = ("wrap in the repo shim pattern: try/except ImportError with a "
            "None (or fallback) binding, or import inside the function "
            "that needs it")
    for stmt in tree.body:  # module top level only — Try/def bodies exempt
        modules: List[str] = []
        if isinstance(stmt, ast.Import):
            modules = [a.name for a in stmt.names]
        elif isinstance(stmt, ast.ImportFrom) and stmt.module:
            modules = [stmt.module]
        for mod in modules:
            if mod in _OPTIONAL_MODULES or \
                    any(mod.startswith(m + ".") for m in _OPTIONAL_MODULES):
                yield Finding(rel, stmt.lineno, "R004",
                              f"optional dependency '{mod}' imported "
                              "unconditionally at module top level",
                              hint, _snippet(lines, stmt.lineno))


# ---------------------------------------------------------------------
# R005: engine mutations must route through delta.apply_engine_updates
# ---------------------------------------------------------------------

def _is_overlay_apply(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "apply"):
        return False
    recv = call.func.value
    if isinstance(recv, ast.Name):
        return recv.id in _OVERLAY_RECEIVER_NAMES
    if isinstance(recv, ast.Attribute):
        return recv.attr == "delta"
    return False


def _rule_r005(tree: ast.Module, rel: str,
               lines: Sequence[str]) -> Iterable[Finding]:
    if rel.replace("\\", "/").endswith("core/delta.py"):
        return  # the router itself owns these internals
    hint = ("route the mutation through delta.apply_engine_updates(engine, "
            "add, remove) so epochs bump and caches invalidate")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in _OVERLAY_MUTATORS:
                yield Finding(rel, node.lineno, "R005",
                              f"direct overlay mutation via {name}() "
                              "outside core/delta.py",
                              hint, _snippet(lines, node.lineno))
            elif _is_overlay_apply(node):
                yield Finding(rel, node.lineno, "R005",
                              "direct delta-overlay .apply() outside "
                              "core/delta.py bypasses epoch/cache "
                              "invalidation",
                              hint, _snippet(lines, node.lineno))
        elif isinstance(node, ast.FunctionDef) and \
                node.name in {"add_edges", "remove_edges"}:
            calls = {_call_name(c.func) for stmt in node.body
                     for c in ast.walk(stmt) if isinstance(c, ast.Call)}
            if "apply_engine_updates" not in calls:
                yield Finding(rel, node.lineno, "R005",
                              f"{node.name}() does not call "
                              "apply_engine_updates — updates will not "
                              "invalidate caches",
                              hint, _snippet(lines, node.lineno))


# ---------------------------------------------------------------------
# R006: raw wall-clock reads inside superstep loops (core/ only)
# ---------------------------------------------------------------------

_RAW_TIMING_FUNCS = {"perf_counter", "monotonic"}
_TIME_MODULE_NAMES = {"time", "_time"}


def _is_raw_timing_call(call: ast.Call) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute):
        return (func.attr in _RAW_TIMING_FUNCS
                and isinstance(func.value, ast.Name)
                and func.value.id in _TIME_MODULE_NAMES)
    if isinstance(func, ast.Name):
        return func.id in _RAW_TIMING_FUNCS
    return False


def _rule_r006(tree: ast.Module, rel: str,
               lines: Sequence[str]) -> Iterable[Finding]:
    # engine/scheduler internals only — benchmarks and examples time
    # end-to-end wall clock by design
    if not rel.replace("\\", "/").startswith("src/repro_torch/core/"):
        return
    hint = ("wrap the timed region in repro_torch.obs.trace.span(...) — "
            "attributable, Chrome-trace exportable, and free when "
            "disabled — or use the scheduler's injectable clock")
    for node in ast.walk(tree):
        if not isinstance(node, ast.While):
            continue
        body_calls = [c for stmt in node.body for c in ast.walk(stmt)
                      if isinstance(c, ast.Call)]
        if not any(_is_dispatch_name(_call_name(c.func)) for c in body_calls):
            continue
        for call in body_calls:
            if _is_raw_timing_call(call):
                yield Finding(rel, call.lineno, "R006",
                              f"raw time.{_call_name(call.func)}() inside a "
                              "superstep loop — ad-hoc timing invisible to "
                              "the obs tracer",
                              hint, _snippet(lines, call.lineno))


# ---------------------------------------------------------------------
# R007: ad-hoc per-superstep counters inside core loops
# ---------------------------------------------------------------------

_COUNTER_NAME_TOKENS = ("count", "counter", "tally", "metric")


def _counterish_base(node: ast.expr) -> Optional[str]:
    """Name of a subscripted container that smells like a counter."""
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    else:
        return None
    low = name.lower()
    if any(tok in low for tok in _COUNTER_NAME_TOKENS):
        return name
    return None


def _rule_r007(tree: ast.Module, rel: str,
               lines: Sequence[str]) -> Iterable[Finding]:
    # engine/scheduler internals only — benchmarks and examples keep
    # local tallies by design (they ARE the consumer of their numbers)
    if not rel.replace("\\", "/").startswith("src/repro_torch/core/"):
        return
    hint = ("route the per-superstep tally through the obs registry "
            "(self.metrics.counter(...).inc()) or the per-query "
            "QueryStats so prometheus_text(), the flight recorder, and "
            "ANALYZE all see it")
    for node in ast.walk(tree):
        if not isinstance(node, ast.While):
            continue
        body = [n for stmt in node.body for n in ast.walk(stmt)]
        if not any(isinstance(c, ast.Call) and
                   _is_dispatch_name(_call_name(c.func)) for c in body):
            continue
        for n in body:
            if isinstance(n, ast.AugAssign) and \
                    isinstance(n.target, ast.Subscript):
                name = _counterish_base(n.target.value)
                if name:
                    yield Finding(rel, n.lineno, "R007",
                                  f"ad-hoc counter dict '{name}' bumped "
                                  "inside a superstep loop — invisible to "
                                  "the obs registry",
                                  hint, _snippet(lines, n.lineno))


# ---------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------

_PER_FILE_RULES = (_rule_r001, _rule_r002, _rule_r004, _rule_r005,
                   _rule_r006, _rule_r007)


def lint_file(path: Path, rel: str) -> List[Finding]:
    source = path.read_text()
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(rel, exc.lineno or 0, "R000",
                        f"file does not parse: {exc.msg}", "",
                        f"syntax-error:{exc.msg}")]
    _attach_parents(tree)
    lines = source.splitlines()
    out: List[Finding] = []
    for rule in _PER_FILE_RULES:
        for f in rule(tree, rel, lines):
            if f.rule in _noqa_rules(lines, f.line):
                continue
            out.append(f)
    return out


def source_files(root: Path, dirs: Sequence[str]) -> List[Path]:
    """The ``*.py`` files of ``dirs`` under ``root``: each a directory
    (walked, sorted) or a file; missing entries are skipped."""
    out: List[Path] = []
    for d in dirs:
        base = Path(root) / d
        if base.is_file():
            out.append(base)
        elif base.is_dir():
            out.extend(sorted(base.rglob("*.py")))
    return out


def run_lint(root: Path, dirs: Optional[Sequence[str]] = None
             ) -> List[Finding]:
    """Lint every ``*.py`` under ``dirs`` (repo-relative directories or
    files; defaults to :data:`DEFAULT_LINT_DIRS`), plus the repo-level
    R003 parity check when the kernels package is in scope."""
    root = Path(root)
    if dirs is None:
        dirs = DEFAULT_LINT_DIRS
    findings: List[Finding] = []
    for path in source_files(root, dirs):
        rel = path.relative_to(root).as_posix()
        findings.extend(lint_file(path, rel))
    if any(Path(d).as_posix().rstrip("/").endswith("kernels") or
           "src/repro_torch" in Path(d).as_posix() for d in dirs):
        if (root / KERNELS_INIT).exists():
            findings.extend(_rule_r003(root))
    return findings
