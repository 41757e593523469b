"""Symbolic bounds / overflow rules (B001-B004, layer 3).

Interval propagation over the bit-parallel core's packing arithmetic.
The packed representations the paper's space bounds rest on are all
one Python ``*``/``<<`` away from silent wraparound, and jit tracing
erases the Python-int arbitrary precision that masks the bug on small
fixtures:

B001  canonical packed keys (``(o*P2 + p)*V + s`` and friends) proven
      to fit int64 under the declared dictionary-size bounds below;
      the analyzer also *emits the binding constraint* — the dictionary
      size at which the proof would break — as a note, so the scale
      ceiling is explicit instead of discovered in production.
B002  bit shifts on uint32 words proven ``< 32`` when the shift
      amount derives from data (masks, arithmetic); amounts the
      evaluator cannot bound on a word are findings too — the contract
      demands a proof, not an absence of counterexample.  The port
      carries its words as ``int32`` views and computes on them in
      ``int64`` masked to 32 bits (``kernels/ref.py``'s ``widen`` and
      ``narrow``), so the text ``uint32`` alone does not find them: see
      :func:`word_shifts` for what makes a shift one on a word.
B003  pow2 padding discipline: the doubling-loop pad idiom must start
      from a power of two and use a plain ``<`` guard (minimal pow2,
      never below the live width), and best-fit slot reuse must compare
      free-block sizes against the *bucketed* width, not the raw size.
B004  constant-width kernel loop structure consistent with the uint32
      word dtype: a ``divmod(_, K)`` word split must use K == 32, and a
      loop-derived shift amount must stay below 32.

B002 and B004 read ``src/repro_torch/kernels/`` and
``src/repro_torch/core/packed.py``, the port's word files.

Declared dictionary bounds (the B001 proof obligations): these are the
scale targets from ROADMAP's real-KG regime, deliberately generous —
|V| <= 2^26 nodes (~6.7e7), |P| <= 2^9 predicates (so P2 = 2|P| <=
2^10 completed-pred planes), |L| <= 2^10 labels.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import dataflow as df
from .dataflow import Interval, IntervalScope
from .findings import Finding

INT64_MAX = (1 << 63) - 1

# Declared dictionary-size bounds (inclusive), keyed by the attribute
# name the code reads them from.
DIM_BOUNDS: Dict[str, int] = {
    "num_nodes": 1 << 26,
    "num_preds": 1 << 9,
    "num_preds_completed": 1 << 10,
    "num_labels": 1 << 10,
}

# Data symbols bounded by a dictionary: name -> the dimension whose
# size (exclusive) bounds it.  Conventions from core/delta.py and the
# engines: s/o/subj/obj/... are node ids, p/pred/... predicate planes.
DATA_BOUNDS: Dict[str, str] = {
    **{n: "num_nodes" for n in
       ("s", "o", "subj", "obj", "sarr", "oarr", "es", "eo",
        "ds", "do", "base_s", "base_o", "src", "dst", "node", "start",
        "v")},
    **{n: "num_preds_completed" for n in
       ("p", "pred", "dp", "base_p", "lbl", "label")},
}


# the port's word files: the kernels and the packed BFS
WORD_FILES = ("src/repro_torch/kernels/", "src/repro_torch/core/packed.py")


def _is_kernel_file(rel: str) -> bool:
    return rel.replace("\\", "/").startswith(WORD_FILES)


# ---------------------------------------------------------------------
# B001: packed-key fit proofs + binding constraints
# ---------------------------------------------------------------------

def _top_level_binops(fn: ast.AST) -> List[ast.BinOp]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.Add, ast.Mult)) and \
                not isinstance(df.parent(node), ast.BinOp) and \
                any(isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult)
                    for n in ast.walk(node)):
            out.append(node)
    return out


def _binding_constraint(fn: ast.AST, expr: ast.BinOp) -> str:
    """Double |V| until the packing proof breaks; report the breaking
    point (the binding constraint the int64 key imposes)."""
    bound = DIM_BOUNDS["num_nodes"]
    for extra in range(1, 40):
        scaled = dict(DIM_BOUNDS, num_nodes=bound << extra)
        iv = IntervalScope(fn, scaled, DATA_BOUNDS).eval(expr)
        if iv is None:
            return ""
        if iv.hi > INT64_MAX:
            log2v = (bound << extra).bit_length() - 1
            return (f"int64 binds at |V| ~ 2^{log2v} "
                    f"(P2 fixed at {DIM_BOUNDS['num_preds_completed']})")
    return "no binding constraint below |V| = 2^66"


def analyze_packing(tree: ast.Module, rel: str, lines: Sequence[str]
                    ) -> Tuple[List[Finding], List[Dict]]:
    """B001 findings plus per-site proof records for the semantic
    layer's binding-constraint note."""
    findings: List[Finding] = []
    sites: List[Dict] = []
    hint = ("packed keys must fit int64 under the declared dictionary "
            "bounds (|V| <= 2^26, P2 <= 2^10) — widen the key dtype or "
            "tighten/shard the dictionary before packing")
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scope = IntervalScope(fn, DIM_BOUNDS, DATA_BOUNDS)
        for expr in _top_level_binops(fn):
            iv = scope.eval(expr)
            if iv is None or not (iv.dimful and iv.dataful):
                continue  # not packing arithmetic
            if iv.hi > INT64_MAX:
                findings.append(Finding(
                    rel, expr.lineno, "B001",
                    f"packed-key expression can reach {iv.hi:.3e} > "
                    f"int64 max ({INT64_MAX:.3e}) under the declared "
                    "dictionary bounds",
                    hint, df.snippet(lines, expr.lineno)))
            else:
                sites.append({
                    "file": rel, "line": expr.lineno,
                    "hi": iv.hi,
                    "headroom_pct": 100.0 * iv.hi / INT64_MAX,
                    "binding": _binding_constraint(fn, expr),
                })
    return findings, sites


def rule_b001(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    findings, _ = analyze_packing(tree, rel, lines)
    return findings


# ---------------------------------------------------------------------
# B002/B004: shift-amount proofs on uint32 words
# ---------------------------------------------------------------------

def _mentions_uint32(node: ast.AST) -> bool:
    return "uint32" in df.unparse(node)


# The port's word: a uint32 word as an ``int32`` view, or widened to int64
# and masked by 0xFFFFFFFF (``ref.widen``; ``ref.narrow`` takes such a
# value back to its view).
WORD_MASK = 0xFFFFFFFF
WORD_MASK_NAMES = {"WORD_MASK"}
WIDEN_CALLS = {"widen"}
NARROW_CALLS = {"narrow"}
_BITWISE = (ast.BitAnd, ast.BitOr, ast.BitXor)


def _word_marked(node: ast.AST) -> bool:
    """Does ``node`` evidently compute on a word: the 32-bit mask (the
    constant or ``WORD_MASK``), ``widen(...)``, or an ``int32`` view?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and type(n.value) is int and \
                n.value == WORD_MASK:
            return True
        if (isinstance(n, ast.Name) and n.id in WORD_MASK_NAMES) or \
                (isinstance(n, ast.Attribute) and
                 n.attr in WORD_MASK_NAMES):
            return True
        if isinstance(n, ast.Call):
            name = df.call_name(n.func)
            if name in WIDEN_CALLS:
                return True
            if name == "view" and any("int32" in df.unparse(a)
                                      for a in n.args):
                return True
    return False


def _bindings(fn: ast.AST) -> Dict[str, List[ast.expr]]:
    """name -> every value bound to it in ``fn`` (plain and augmented
    assignments, the latter also to a subscript of the name)."""
    out: Dict[str, List[ast.expr]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            out.setdefault(node.targets[0].id, []).append(node.value)
        elif isinstance(node, ast.AugAssign):
            name = df.base_name(node.target)
            if name:
                out.setdefault(name, []).append(node.value)
    return out


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _word_names(fn: ast.AST, binds: Dict[str, List[ast.expr]]) -> Set[str]:
    """Names that hold words in ``fn``: bound to a word expression, given
    to ``narrow``, a bitwise operand beside a word, or feeding a word's
    binding (a mask built to be ANDed into one), to a fixed point."""
    words: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and df.call_name(n.func) in NARROW_CALLS:
            words |= {a.id for a in n.args if isinstance(a, ast.Name)}
    pairs = []   # (one side, the other) of every bitwise op
    for n in ast.walk(fn):
        if isinstance(n, ast.BinOp) and isinstance(n.op, _BITWISE):
            pairs += [(n.left, n.right), (n.right, n.left)]
        elif isinstance(n, ast.AugAssign) and isinstance(n.op, _BITWISE):
            pairs += [(n.target, n.value), (n.value, n.target)]
    changed = True
    while changed:
        before = len(words)
        for name, values in binds.items():
            if name not in words and any(_word_valued(v, words)
                                         for v in values):
                words.add(name)
        for side, other in pairs:
            name = df.base_name(side) if isinstance(
                side, (ast.Name, ast.Subscript, ast.Attribute)) else ""
            if name and name not in words and _word_valued(other, words):
                words.add(name)
        for name in list(words):
            for v in binds.get(name, ()):
                words |= _names_in(v)
        changed = len(words) != before
    return words


def _word_valued(node: ast.AST, words: Set[str]) -> bool:
    return _word_marked(node) or bool(_names_in(node) & words)


def _python_int(node: ast.expr, binds: Dict[str, List[ast.expr]],
                seen: Optional[Set[str]] = None) -> bool:
    """``int(...)``, a shift of one, or a name only ever bound to one: a
    Python int of any width, out of scope as in the JAX package."""
    seen = set() if seen is None else seen
    if isinstance(node, ast.Call):
        return df.call_name(node.func) == "int"
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.LShift, ast.RShift)):
        return _python_int(node.left, binds, seen)
    if isinstance(node, ast.Name) and node.id not in seen:
        values = binds.get(node.id)
        seen.add(node.id)
        return bool(values) and all(_python_int(v, binds, seen)
                                    for v in values)
    return False


def word_shifts(tree: ast.Module, rel: str) -> List[ast.BinOp]:
    """The shifts of a word file that act on a word: the JAX package's
    test (the shift's text says ``uint32``), or, for the port's words,
    a shift whose operand holds a word, that builds a word's binding, or
    that is a bitwise operand beside a word; a shift of a Python int is
    out of scope."""
    if not _is_kernel_file(rel):
        return []
    out: List[ast.BinOp] = []
    cache: Dict[int, Tuple[Dict[str, List[ast.expr]], Set[str],
                           Set[int]]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, (ast.LShift, ast.RShift))):
            continue
        if _mentions_uint32(node):
            out.append(node)
            continue
        fn = df.enclosing_function(node)
        if fn is None:
            continue
        if id(fn) not in cache:
            binds = _bindings(fn)
            words = _word_names(fn, binds)
            built = {id(n) for name in words for v in binds.get(name, ())
                     for n in ast.walk(v)}
            cache[id(fn)] = (binds, words, built)
        binds, words, built = cache[id(fn)]
        if _python_int(node.left, binds):
            continue
        up = df.parent(node)
        beside_word = (isinstance(up, ast.BinOp)
                       and isinstance(up.op, _BITWISE)
                       and _word_valued(up.right if up.left is node
                                        else up.left, words))
        if _word_valued(node.left, words) or beside_word or \
                id(node) in built:
            out.append(node)
    return out


def _shift_findings(tree: ast.Module, rel: str,
                    lines: Sequence[str]) -> Iterable[Finding]:
    hint_data = ("prove the shift amount < 32 (mask with '& 31', or "
                 "guard the 32 case out before the shift) — shifting a "
                 "uint32 by >= 32 is undefined lane garbage")
    hint_loop = ("size the loop/split to the 32-bit word: range bound "
                 "<= 32 and divmod width == 32, so no iteration shifts "
                 "a uint32 word out of range")
    for node in word_shifts(tree, rel):
        fn = df.enclosing_function(node)
        if fn is None:
            continue
        scope = IntervalScope(fn, DIM_BOUNDS, DATA_BOUNDS)
        iv = scope.eval(node.right)
        if iv is None:
            yield Finding(
                rel, node.lineno, "B002",
                "cannot statically bound this uint32 shift amount — "
                "the word-width contract demands a proof",
                hint_data, df.snippet(lines, node.lineno))
        elif iv.hi >= 32:
            if iv.loopish:
                yield Finding(
                    rel, node.lineno, "B004",
                    f"loop-structured shift amount reaches {iv.hi} >= "
                    "32 on a uint32 word — the loop width is "
                    "inconsistent with the word dtype",
                    hint_loop, df.snippet(lines, node.lineno))
            else:
                yield Finding(
                    rel, node.lineno, "B002",
                    f"shift amount can reach {iv.hi} >= 32 on a uint32 "
                    "word",
                    hint_data, df.snippet(lines, node.lineno))


def rule_b002(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    for f in _shift_findings(tree, rel, lines):
        if f.rule == "B002":
            yield f


# ---------------------------------------------------------------------
# B003: pow2 padding + best-fit reuse proofs
# ---------------------------------------------------------------------

def _doubling_while(node: ast.While) -> Optional[Tuple[str, ast.cmpop,
                                                       bool]]:
    """Match ``while w < n: w *= 2`` (one doubling statement).  Returns
    (loop var, comparison op, guard-has-extra-conjuncts)."""
    test = node.test
    extra = False
    if isinstance(test, ast.BoolOp):
        comps = [t for t in test.values if isinstance(t, ast.Compare)]
        if not comps:
            return None
        test, extra = comps[0], True
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Name)
            and isinstance(test.ops[0], (ast.Lt, ast.LtE))):
        return None
    var = test.left.id
    if len(node.body) != 1:
        return None
    stmt = node.body[0]
    doubles = (isinstance(stmt, ast.AugAssign)
               and isinstance(stmt.target, ast.Name)
               and stmt.target.id == var
               and isinstance(stmt.op, ast.Mult)
               and isinstance(stmt.value, ast.Constant)
               and stmt.value.value == 2)
    if not doubles and isinstance(stmt, ast.Assign) and \
            len(stmt.targets) == 1 and \
            isinstance(stmt.targets[0], ast.Name) and \
            stmt.targets[0].id == var and \
            isinstance(stmt.value, ast.BinOp) and \
            isinstance(stmt.value.op, ast.Mult):
        l, r = stmt.value.left, stmt.value.right
        doubles = ((isinstance(l, ast.Name) and l.id == var
                    and isinstance(r, ast.Constant) and r.value == 2)
                   or (isinstance(r, ast.Name) and r.id == var
                       and isinstance(l, ast.Constant) and l.value == 2))
    if not doubles:
        return None
    return var, test.ops[0], extra


def _pad_base(fn: ast.AST, var: str, before_line: int) -> Optional[int]:
    base = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == var and \
                node.lineno < before_line and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, int):
            if base is None or node.lineno > base[0]:
                base = (node.lineno, node.value.value)
    return base[1] if base else None


def _pad_fn_names(tree: ast.Module) -> set:
    """Functions containing the doubling pad idiom — their results are
    the only legal comparands for best-fit reuse."""
    names = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.While) and _doubling_while(node):
                names.add(fn.name)
    return names


def rule_b003(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    hint = ("pad with the canonical idiom — w = <pow2>; while w < n: "
            "w *= 2 — and best-fit against the bucketed width, so "
            "every padded shape is a minimal power of two and reused "
            "blocks never sit below the live width")
    # (a) the doubling pad idiom itself
    for node in ast.walk(tree):
        if not isinstance(node, ast.While):
            continue
        match = _doubling_while(node)
        if match is None:
            continue
        var, op, extra = match
        fn = df.enclosing_function(node)
        if fn is None:
            continue
        base = _pad_base(fn, var, node.lineno)
        if base is not None and (base < 1 or base & (base - 1)):
            yield Finding(
                rel, node.lineno, "B003",
                f"pad loop starts from {base}, not a power of two — "
                "every padded width inherits the non-pow2 factor and "
                "compiled shapes fragment",
                hint, df.snippet(lines, node.lineno))
        if isinstance(op, ast.LtE):
            yield Finding(
                rel, node.lineno, "B003",
                "pad loop guard is '<=' — an exact-pow2 input doubles "
                "past the minimal power of two (2x waste)",
                hint, df.snippet(lines, node.lineno))
        if extra:
            yield Finding(
                rel, node.lineno, "B003",
                "pad loop guard has extra conjuncts — the loop can "
                "exit below the live width",
                hint, df.snippet(lines, node.lineno))
    # (b) best-fit reuse must compare against the bucketed width
    pad_fns = _pad_fn_names(tree)
    for loop in ast.walk(tree):
        if not isinstance(loop, ast.For):
            continue
        if "free" not in df.unparse(loop.iter):
            continue
        for node in ast.walk(loop):
            if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and isinstance(node.left, ast.Subscript)
                    and isinstance(node.left.value, ast.Attribute)
                    and node.left.value.attr == "sizes"):
                continue
            comp0 = node.comparators[0]
            if isinstance(comp0, ast.Subscript) and \
                    isinstance(comp0.value, ast.Attribute) and \
                    comp0.value.attr == "sizes":
                continue  # block-vs-block ordering (the tie-break)
            if not isinstance(node.ops[0], (ast.Gt, ast.GtE)):
                yield Finding(
                    rel, node.lineno, "B003",
                    "best-fit scan accepts free blocks SMALLER than "
                    "the requested width — a reused slot would sit "
                    "below the live plan",
                    hint, df.snippet(lines, node.lineno))
                continue
            comp = node.comparators[0]
            if not isinstance(comp, ast.Name):
                continue
            fn = df.enclosing_function(node)
            if fn is None:
                continue
            binds = IntervalScope(fn).bindings.get(comp.id, [])
            bucketed = any(
                isinstance(b, ast.Call)
                and (df.call_name(b.func) in pad_fns
                     or "bucket" in df.call_name(b.func)
                     or "pad" in df.call_name(b.func))
                for b in binds)
            if not bucketed:
                yield Finding(
                    rel, node.lineno, "B003",
                    f"best-fit scan compares against '{comp.id}', "
                    "which does not flow from the pow2 bucket "
                    "function — reuse can land below the padded width",
                    hint, df.snippet(lines, node.lineno))


# ---------------------------------------------------------------------
# B004: kernel loop structure vs the 32-bit word
# ---------------------------------------------------------------------

def rule_b004(tree: ast.Module, rel: str,
              lines: Sequence[str]) -> Iterable[Finding]:
    if not _is_kernel_file(rel):
        return
    hint = ("pack uint32 words with divmod(_, 32) / range(<=32) so the "
            "bit index never leaves the word")
    # loop-structured over-wide shifts (shared walker with B002)
    for f in _shift_findings(tree, rel, lines):
        if f.rule == "B004":
            yield f
    # divmod word splits wider than the word
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scope = IntervalScope(fn)
        if not scope.divmod_rem:
            continue
        shift_amount_names = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) and \
                    isinstance(node.op, (ast.LShift, ast.RShift)):
                for n in ast.walk(node.right):
                    if isinstance(n, ast.Name):
                        shift_amount_names.add(n.id)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and df.call_name(node.value.func) == "divmod"
                    and len(node.value.args) == 2
                    and isinstance(node.value.args[1], ast.Constant)):
                continue
            k = node.value.args[1].value
            if not isinstance(k, int) or k <= 32:
                continue
            rem_names = [t.id for tgt in node.targets
                         if isinstance(tgt, ast.Tuple)
                         and len(tgt.elts) == 2
                         for t in tgt.elts[1:]
                         if isinstance(t, ast.Name)]
            if any(r in shift_amount_names for r in rem_names):
                yield Finding(
                    rel, node.lineno, "B004",
                    f"divmod(_, {k}) word split feeds a shift, but "
                    "packed words are uint32 (32 bits) — bit indices "
                    f"reach {k - 1}",
                    hint, df.snippet(lines, node.lineno))


B_RULES = (rule_b001, rule_b002, rule_b003, rule_b004)
