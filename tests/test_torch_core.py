"""The parser and Glushkov cases of the JAX package's ``tests/test_core.py``
on the port's copies (``repro_torch.core.regex``, ``.glushkov``), which
``PathCorpus``'s RPQ filter rests on, with the reference as the yardstick
where it gives one: the same ASTs, the same automaton tables, the same
answers.  Exact everywhere."""
import itertools
import random
import re as pyre

import pytest

pytest.importorskip("torch")

from helpers import rand_expr_ast  # noqa: E402
from repro.core import regex as rrx  # noqa: E402
from repro.core.glushkov import Glushkov as RGlushkov  # noqa: E402
from repro_torch.core import regex as rx  # noqa: E402
from repro_torch.core.glushkov import Glushkov  # noqa: E402

EXPRS = ["a/b*/b", "(l1|l2|l5)+", "a*/b/c*", "^bus/l5*/l5", "a?",
         "eps|a/b", "a/(b|c)*/d"]


def _port(ast):
    """The port's AST of a reference AST (through its printed form)."""
    return rx.parse(str(ast))


def _to_py(n):
    if isinstance(n, rx.Eps):
        return ""
    if isinstance(n, rx.Lit):
        return n.name
    if isinstance(n, rx.Cat):
        return f"(?:{_to_py(n.left)}{_to_py(n.right)})"
    if isinstance(n, rx.Alt):
        return f"(?:{_to_py(n.left)}|{_to_py(n.right)})"
    if isinstance(n, rx.Star):
        return f"(?:{_to_py(n.child)})*"
    if isinstance(n, rx.Plus):
        return f"(?:{_to_py(n.child)})+"
    if isinstance(n, rx.Opt):
        return f"(?:{_to_py(n.child)})?"


def _tables(g):
    return (g.m, dict(g.B), g.F, g.nullable, g.initial, g.nwords)


def test_parser_roundtrip():
    for e in EXPRS:
        ast = rx.parse(e)
        assert rx.parse(str(ast)) == ast
        assert str(ast) == str(rrx.parse(e))


def test_parser_errors():
    for bad in ["(a", "a|", "*a", "a//b", "^", "a)("]:
        with pytest.raises(ValueError):
            rx.parse(bad)
        with pytest.raises(ValueError):
            rrx.parse(bad)


def test_reverse_involution():
    rnd = random.Random(5)
    for _ in range(50):
        ast = _port(rand_expr_ast(rnd, 3, 3))
        assert rx.reverse(rx.reverse(ast)) == ast
        assert str(rx.reverse(ast)) == str(rrx.reverse(rrx.parse(str(ast))))


def test_glushkov_paper_example():
    """Fig. 2: a/b*/b — 4 states, B/T tables, forward + backward."""
    g = Glushkov.from_ast(rx.parse("a/b*/b"), lambda lit: lit.name)
    assert g.m == 3
    assert g.B["a"] == 0b0010 and g.B["b"] == 0b1100
    assert g.F == 0b1000 and not g.nullable
    ref = RGlushkov.from_ast(rrx.parse("a/b*/b"), lambda lit: lit.name)
    assert _tables(g) == _tables(ref)
    for w, exp in [("ab", True), ("abb", True), ("a", False), ("abba", False),
                   ("", False), ("b", False)]:
        assert g.match(list(w)) == exp
        assert g.match_backward(list(w)) == exp


def _rename(n):
    """Predicate ids '0'/'1' -> 'a'/'b' for Python ``re``."""
    names = {"0": "a", "1": "b"}
    if isinstance(n, rx.Lit):
        return rx.Lit(names[n.name])
    if isinstance(n, (rx.Cat, rx.Alt)):
        return type(n)(_rename(n.left), _rename(n.right))
    if isinstance(n, (rx.Star, rx.Plus, rx.Opt)):
        return type(n)(_rename(n.child))
    return n


def test_glushkov_vs_python_re():
    """150 random expressions: every word up to length 4 matched as Python
    ``re`` does, forward and backward, and the automaton's tables, its
    forward steps and answers equal to the reference's."""
    rnd = random.Random(0)
    for _ in range(150):
        ast = _rename(_port(rand_expr_ast(rnd, 3, 2, allow_inverse=False)))
        g = Glushkov.from_ast(ast, lambda lit: lit.name)
        ref = RGlushkov.from_ast(rrx.parse(str(ast)), lambda lit: lit.name)
        assert _tables(g) == _tables(ref), str(ast)
        pat = pyre.compile(f"^(?:{_to_py(ast)})$")
        for L in range(0, 5):
            for w in itertools.product("ab", repeat=L):
                exp = pat.match("".join(w)) is not None
                assert g.match(list(w)) == exp == ref.match(list(w))
                assert g.match_backward(list(w)) == exp
        for D in range(1 << min(g.m + 1, 6)):
            for c in "ab":
                assert g.forward_step(D, c) == ref.forward_step(D, c)
                assert g.backward_step(D, c) == ref.backward_step(D, c)


def test_glushkov_multiword_masks():
    """m > 32 forces multi-word packed tables, equal to the reference's."""
    import numpy as np
    expr = "/".join(["a"] * 40)
    g = Glushkov.from_ast(rx.parse(expr), lambda lit: lit.name)
    assert g.m == 40 and g.nwords == 2
    assert g.match(["a"] * 40)
    assert not g.match(["a"] * 39)
    Bp, bwd, fwd, Fp, ip = g.packed_tables(1, lambda lit: 0)
    assert Bp.shape == (1, 2) and bwd.shape == (41, 2)
    ref = RGlushkov.from_ast(rrx.parse(expr), lambda lit: lit.name)
    for a, b in zip((Bp, bwd, fwd, Fp, ip),
                    ref.packed_tables(1, lambda lit: 0)):
        np.testing.assert_array_equal(a, b)
