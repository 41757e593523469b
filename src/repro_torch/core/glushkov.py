"""Glushkov automaton construction + bit-parallel simulation tables.

Paper Sec. 3.3: for a regex with m literal occurrences, Glushkov's NFA has
exactly m+1 states (state 0 = initial, state i>0 = the i-th literal
occurrence), no epsilon-transitions, and every transition *into* state i
is labeled with the symbol of occurrence i (Fact 1).  That property lets
the whole NFA be simulated on (m+1)-bit words:

    forward:   D <- T[D] & B[c]          (Eq. 1)
    backward:  D <- T'[D & B[c]]         (Eq. 2)

where B[c] marks states whose incoming label is c, T[X] marks states
reachable in one step from X by any symbol, and T'[X] marks states that
reach X in one step.  We keep masks as Python ints (arbitrary precision,
so m is unbounded) plus bit-packed ``uint32`` planes for the kernels.
T/T' are realized as byte-split tables (the paper's vertical
d-bit split with d=8) so preprocessing is O((m/8)·256) instead of O(2^m).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np

from . import regex as rx

Label = Hashable


def _first(node: rx.Node, base: int) -> Tuple[set, int]:
    """Positions (1-based, offset by ``base``) that can start a word; also
    returns the number of literal occurrences in ``node``."""
    if isinstance(node, rx.Eps):
        return set(), 0
    if isinstance(node, rx.Lit):
        return {base + 1}, 1
    if isinstance(node, rx.Cat):
        f1, m1 = _first(node.left, base)
        f2, m2 = _first(node.right, base + m1)
        return (f1 | f2, m1 + m2) if rx.nullable(node.left) else (f1, m1 + m2)
    if isinstance(node, rx.Alt):
        f1, m1 = _first(node.left, base)
        f2, m2 = _first(node.right, base + m1)
        return f1 | f2, m1 + m2
    if isinstance(node, (rx.Star, rx.Plus, rx.Opt)):
        f, m = _first(node.child, base)
        return f, m
    raise TypeError(node)


def _last(node: rx.Node, base: int) -> Tuple[set, int]:
    if isinstance(node, rx.Eps):
        return set(), 0
    if isinstance(node, rx.Lit):
        return {base + 1}, 1
    if isinstance(node, rx.Cat):
        l1, m1 = _last(node.left, base)
        l2, m2 = _last(node.right, base + m1)
        return (l1 | l2, m1 + m2) if rx.nullable(node.right) else (l2, m1 + m2)
    if isinstance(node, rx.Alt):
        l1, m1 = _last(node.left, base)
        l2, m2 = _last(node.right, base + m1)
        return l1 | l2, m1 + m2
    if isinstance(node, (rx.Star, rx.Plus, rx.Opt)):
        l, m = _last(node.child, base)
        return l, m
    raise TypeError(node)


def _follow(node: rx.Node, base: int, follow: Dict[int, set]) -> int:
    """Fill ``follow[i]`` = positions that may follow position i.  Returns
    the number of literal occurrences in ``node``."""
    if isinstance(node, rx.Eps):
        return 0
    if isinstance(node, rx.Lit):
        follow.setdefault(base + 1, set())
        return 1
    if isinstance(node, rx.Cat):
        m1 = _follow(node.left, base, follow)
        m2 = _follow(node.right, base + m1, follow)
        l1, _ = _last(node.left, base)
        f2, _ = _first(node.right, base + m1)
        for i in l1:
            follow[i] |= f2
        return m1 + m2
    if isinstance(node, rx.Alt):
        m1 = _follow(node.left, base, follow)
        m2 = _follow(node.right, base + m1, follow)
        return m1 + m2
    if isinstance(node, (rx.Star, rx.Plus)):
        m = _follow(node.child, base, follow)
        last, _ = _last(node.child, base)
        first, _ = _first(node.child, base)
        for i in last:
            follow[i] |= first
        return m
    if isinstance(node, rx.Opt):
        return _follow(node.child, base, follow)
    raise TypeError(node)


def _pack(mask: int, nwords: int) -> np.ndarray:
    """Python-int bitmask -> uint32[nwords] (bit i of the int == bit
    (i % 32) of word (i // 32))."""
    out = np.zeros(nwords, dtype=np.uint32)
    for w in range(nwords):
        out[w] = (mask >> (32 * w)) & 0xFFFFFFFF
    return out


@dataclass
class Glushkov:
    """Glushkov NFA of a regex over labels resolved to hashable keys.

    State i corresponds to bit i (LSB-first; the paper draws the initial
    state as the *highest* bit, which is presentation only).
    """

    m: int                                  # number of literal occurrences
    labels: List[Label]                     # distinct labels, stable order
    sym_of_pos: List[Label]                 # sym_of_pos[i-1] = label of state i
    B: Dict[Label, int]                     # label -> target-state mask
    follow_mask: List[int]                  # follow_mask[i] for i in 0..m (0 = first)
    pred_mask: List[int]                    # transpose of follow_mask
    initial: int                            # == 1 (bit 0)
    F: int                                  # final-state mask
    nullable: bool
    _tbl_fwd: List[np.ndarray] = field(default_factory=list, repr=False)
    _tbl_bwd: List[np.ndarray] = field(default_factory=list, repr=False)
    _bwd_packed_cache: List[np.ndarray] = field(default_factory=list, repr=False)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_ast(
        cls,
        node: rx.Node,
        resolve: Callable[[rx.Lit], Label] = lambda lit: (lit.name, lit.inverse),
    ) -> "Glushkov":
        lits = list(node.literals())
        m = len(lits)
        sym_of_pos = [resolve(l) for l in lits]
        labels: List[Label] = []
        seen = set()
        for s in sym_of_pos:
            if s not in seen:
                seen.add(s)
                labels.append(s)

        first, _ = _first(node, 0)
        last, _ = _last(node, 0)
        follow: Dict[int, set] = {}
        _follow(node, 0, follow)

        B: Dict[Label, int] = {}
        for i, s in enumerate(sym_of_pos, start=1):
            B[s] = B.get(s, 0) | (1 << i)

        follow_mask = [0] * (m + 1)
        follow_mask[0] = sum(1 << i for i in first)
        for i in range(1, m + 1):
            follow_mask[i] = sum(1 << j for j in follow.get(i, ()))

        pred_mask = [0] * (m + 1)
        for i in range(m + 1):
            fm = follow_mask[i]
            j = 0
            while fm:
                if fm & 1:
                    pred_mask[j] |= 1 << i
                fm >>= 1
                j += 1

        is_null = rx.nullable(node)
        F = sum(1 << i for i in last) | (1 if is_null else 0)
        g = cls(
            m=m,
            labels=labels,
            sym_of_pos=sym_of_pos,
            B=B,
            follow_mask=follow_mask,
            pred_mask=pred_mask,
            initial=1,
            F=F,
            nullable=is_null,
        )
        g._build_byte_tables()
        return g

    # -- byte-split T / T' tables (paper's d-bit vertical split, d=8) -----
    def _build_byte_tables(self) -> None:
        nbytes = (self.m + 1 + 7) // 8
        for which, masks in (("fwd", self.follow_mask), ("bwd", self.pred_mask)):
            tables = []
            for k in range(nbytes):
                tbl = np.zeros(256, dtype=object)
                for byte in range(256):
                    acc = 0
                    for b in range(8):
                        if byte & (1 << b):
                            idx = 8 * k + b
                            if idx <= self.m:
                                acc |= masks[idx]
                    tbl[byte] = acc
                tables.append(tbl)
            if which == "fwd":
                self._tbl_fwd = tables
            else:
                self._tbl_bwd = tables

    # -- scalar (Python-int) simulation ------------------------------------
    def T(self, X: int) -> int:
        """States reachable in one step from set X (any symbol)."""
        acc = 0
        for k, tbl in enumerate(self._tbl_fwd):
            acc |= tbl[(X >> (8 * k)) & 0xFF]
        return acc

    def Tp(self, X: int) -> int:
        """States that reach some state of X in one step (T')."""
        acc = 0
        for k, tbl in enumerate(self._tbl_bwd):
            acc |= tbl[(X >> (8 * k)) & 0xFF]
        return acc

    def first_labels(self) -> List[Label]:
        """Labels a *forward* simulation can take on its first step
        (symbols of the first-position states) — the predicates adjacent
        to the initial state.  Planner cost input."""
        first = self.follow_mask[0]
        return [lab for lab in self.labels if self.B[lab] & first]

    def last_labels(self) -> List[Label]:
        """Labels a *backward* simulation can take on its first step
        (symbols of the final states, eps bit stripped) — the predicates
        adjacent to the final states.  Planner cost input."""
        F = self.F & ~1
        return [lab for lab in self.labels if self.B[lab] & F]

    def forward_step(self, D: int, c: Label) -> int:
        return self.T(D) & self.B.get(c, 0)

    def backward_step(self, D: int, c: Label) -> int:
        return self.Tp(D & self.B.get(c, 0))

    def match(self, word: Sequence[Label]) -> bool:
        """Forward simulation (Sec. 3.3) — used for testing."""
        D = self.initial
        if not word:
            return self.nullable
        for c in word:
            D = self.forward_step(D, c)
            if D == 0:
                return False
        return D & self.F != 0

    def match_backward(self, word: Sequence[Label]) -> bool:
        # B[c] has no bit 0 (no transitions enter state 0), so a nullable
        # F's bit 0 is stripped automatically on the first step.
        D = self.F
        if not word:
            return self.nullable
        for c in reversed(word):
            D = self.backward_step(D, c)
            if D == 0:
                return False
        return D & self.initial != 0

    # -- packed planes for the kernels --------------------------------------
    @property
    def nwords(self) -> int:
        return (self.m + 1 + 31) // 32

    def packed_bwd(self) -> np.ndarray:
        """uint32 [m+1, W] predecessor-mask matrix — the ``bwd`` operand of
        the ``nfa_step`` kernel.  Cached: the wavefront traversal
        calls this once per superstep."""
        if not self._bwd_packed_cache:
            self._bwd_packed_cache.append(
                np.stack([_pack(m, self.nwords) for m in self.pred_mask]))
        return self._bwd_packed_cache[0]

    def packed_tables(self, num_labels: int, label_id: Callable[[Label], int]):
        """Return (B_packed[num_labels, W], bwd_matrix[m+1, W],
        fwd_matrix[m+1, W], F_packed[W], init_packed[W]) as uint32.

        ``bwd_matrix[j]`` = pred_mask[j]:  T'[X] = OR_{j in X} bwd_matrix[j].
        """
        W = self.nwords
        Bp = np.zeros((num_labels, W), dtype=np.uint32)
        for lab, mask in self.B.items():
            Bp[label_id(lab)] = _pack(mask, W)
        bwd = np.stack([_pack(m, W) for m in self.pred_mask])
        fwd = np.stack([_pack(m, W) for m in self.follow_mask])
        Fp = _pack(self.F, W)
        ip = _pack(self.initial, W)
        return Bp, bwd, fwd, Fp, ip


def build(expr: str, resolve=None) -> Glushkov:
    ast = rx.parse(expr)
    if resolve is None:
        return Glushkov.from_ast(ast)
    return Glushkov.from_ast(ast, resolve)
