"""RPQ regular-expression AST + parser.

Grammar (paper Sec. 3.1):

    alt     := concat ('|' concat)*
    concat  := postfix ('/' postfix)*
    postfix := atom ('*' | '+' | '?')*
    atom    := literal | '^' literal | '(' alt ')' | 'eps'
    literal := [A-Za-z0-9_:.-]+       (a predicate name)

``^p`` denotes the inverse predicate (traverse the edge backwards); the
2RPQ is evaluated over the completion G∪Ĝ (Sec. 3.1).  ``E+`` is sugar
for ``E/E*`` and ``E?`` for ``eps|E`` — we keep them as AST nodes since
Glushkov's construction handles them natively via nullability.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple, Union

EPS_TOKEN = "eps"


class Node:
    """Base class for regex AST nodes."""

    def literals(self) -> Iterator["Lit"]:
        raise NotImplementedError

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        raise NotImplementedError


@dataclass(frozen=True)
class Eps(Node):
    def literals(self):
        return iter(())

    def __str__(self):
        return EPS_TOKEN


@dataclass(frozen=True)
class Lit(Node):
    """A predicate literal; ``inverse`` marks ``^p``."""

    name: str
    inverse: bool = False

    def literals(self):
        yield self

    def __str__(self):
        return ("^" if self.inverse else "") + self.name


@dataclass(frozen=True)
class Cat(Node):
    left: Node
    right: Node

    def literals(self):
        yield from self.left.literals()
        yield from self.right.literals()

    def __str__(self):
        return f"({self.left}/{self.right})"


@dataclass(frozen=True)
class Alt(Node):
    left: Node
    right: Node

    def literals(self):
        yield from self.left.literals()
        yield from self.right.literals()

    def __str__(self):
        return f"({self.left}|{self.right})"


@dataclass(frozen=True)
class Star(Node):
    child: Node

    def literals(self):
        yield from self.child.literals()

    def __str__(self):
        return f"({self.child})*"


@dataclass(frozen=True)
class Plus(Node):
    child: Node

    def literals(self):
        yield from self.child.literals()

    def __str__(self):
        return f"({self.child})+"


@dataclass(frozen=True)
class Opt(Node):
    child: Node

    def literals(self):
        yield from self.child.literals()

    def __str__(self):
        return f"({self.child})?"


RegexNode = Union[Eps, Lit, Cat, Alt, Star, Plus, Opt]

_LITERAL_CHARS = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:.-"
)


def _tokenize(s: str) -> Iterator[Tuple[str, str]]:
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if c in "()|/*+?^":
            yield (c, c)
            i += 1
            continue
        if c in _LITERAL_CHARS:
            j = i
            while j < n and s[j] in _LITERAL_CHARS:
                j += 1
            name = s[i:j]
            yield ("eps", name) if name == EPS_TOKEN else ("lit", name)
            i = j
            continue
        raise ValueError(f"unexpected character {c!r} at position {i} in {s!r}")
    yield ("end", "")


class _Parser:
    def __init__(self, s: str):
        self.toks = list(_tokenize(s))
        self.pos = 0
        self.src = s

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.pos]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, kind: str) -> str:
        k, v = self.next()
        if k != kind:
            raise ValueError(f"expected {kind!r}, got {k!r} ({v!r}) in {self.src!r}")
        return v

    def parse(self) -> Node:
        node = self.alt()
        self.expect("end")
        return node

    def alt(self) -> Node:
        node = self.concat()
        while self.peek()[0] == "|":
            self.next()
            node = Alt(node, self.concat())
        return node

    def concat(self) -> Node:
        node = self.postfix()
        while True:
            k = self.peek()[0]
            if k == "/":
                self.next()
                node = Cat(node, self.postfix())
            elif k in ("lit", "(", "^", "eps"):
                # implicit concatenation (``ab`` never arises because
                # literals are maximal-munch, but ``a(b|c)`` does)
                node = Cat(node, self.postfix())
            else:
                return node

    def postfix(self) -> Node:
        node = self.atom()
        while True:
            k = self.peek()[0]
            if k == "*":
                self.next()
                node = Star(node)
            elif k == "+":
                self.next()
                node = Plus(node)
            elif k == "?":
                self.next()
                node = Opt(node)
            else:
                return node

    def atom(self) -> Node:
        k, v = self.next()
        if k == "lit":
            return Lit(v)
        if k == "eps":
            return Eps()
        if k == "^":
            kk, vv = self.next()
            if kk != "lit":
                raise ValueError(f"expected literal after '^' in {self.src!r}")
            return Lit(vv, inverse=True)
        if k == "(":
            node = self.alt()
            self.expect(")")
            return node
        raise ValueError(f"unexpected token {k!r} ({v!r}) in {self.src!r}")


def parse(expr: str) -> Node:
    """Parse an RPQ regular expression into an AST."""
    return _Parser(expr).parse()


def reverse(node: Node) -> Node:
    """The reversal ^E of a two-way regex: reverses every path it matches.

    rev(p) = ^p, rev(E1/E2) = rev(E2)/rev(E1); closures distribute
    (Sec. 4: query (s,E,y) is evaluated as (y, ^E, s)).
    """
    if isinstance(node, Eps):
        return node
    if isinstance(node, Lit):
        return Lit(node.name, inverse=not node.inverse)
    if isinstance(node, Cat):
        return Cat(reverse(node.right), reverse(node.left))
    if isinstance(node, Alt):
        return Alt(reverse(node.left), reverse(node.right))
    if isinstance(node, Star):
        return Star(reverse(node.child))
    if isinstance(node, Plus):
        return Plus(reverse(node.child))
    if isinstance(node, Opt):
        return Opt(reverse(node.child))
    raise TypeError(node)


def _cat_chain(node: Node) -> list:
    """Flatten a concatenation into its left-to-right factor list."""
    if isinstance(node, Cat):
        return _cat_chain(node.left) + _cat_chain(node.right)
    return [node]


def _alt_chain(node: Node) -> list:
    if isinstance(node, Alt):
        return _alt_chain(node.left) + _alt_chain(node.right)
    return [node]


def fold_cat(parts) -> Node:
    """Right-associate a non-empty factor list back into a Cat chain."""
    parts = list(parts)
    node = parts[-1]
    for p in reversed(parts[:-1]):
        node = Cat(p, node)
    return node


def canonical(node: Node) -> Node:
    """Semantics-preserving canonical form of an expression.

    Concatenation chains are re-associated to the right and alternation
    chains are flattened, deduplicated, and sorted by their canonical
    printing — so every spelling of the same associativity/operand-order
    class prints identically (``(a/b)/c`` == ``a/(b/c)``, ``a|b`` ==
    ``b|a``).  Used by the engines' cache keys; anything keyed on
    ``str(canonical(ast))`` is shared across equivalent spellings.
    """
    if isinstance(node, (Eps, Lit)):
        return node
    if isinstance(node, Cat):
        return fold_cat(canonical(p) for p in _cat_chain(node))
    if isinstance(node, Alt):
        arms = {str(a): a for a in (canonical(x) for x in _alt_chain(node))}
        keys = sorted(arms)
        out = arms[keys[-1]]
        for k in reversed(keys[:-1]):
            out = Alt(arms[k], out)
        return out
    if isinstance(node, Star):
        return Star(canonical(node.child))
    if isinstance(node, Plus):
        return Plus(canonical(node.child))
    if isinstance(node, Opt):
        return Opt(canonical(node.child))
    raise TypeError(node)


def nullable(node: Node) -> bool:
    """True iff the empty word is in L(E)."""
    if isinstance(node, Eps):
        return True
    if isinstance(node, Lit):
        return False
    if isinstance(node, Cat):
        return nullable(node.left) and nullable(node.right)
    if isinstance(node, Alt):
        return nullable(node.left) or nullable(node.right)
    if isinstance(node, (Star, Opt)):
        return True
    if isinstance(node, Plus):
        return nullable(node.child)
    raise TypeError(node)
