"""Bit-packed wavelet tree (paper Sec. 3.5) with rank superblocks.

Pointerless, levelwise layout: at level l the sequence is stably sorted by
the top-l bits of each symbol, so every wavelet-tree node occupies a
contiguous interval; child intervals are recovered with rank during the
descent — no per-node pointers are stored.  Bitvectors are packed into
``uint64`` words with a 512-bit-superblock rank directory (uint32), i.e.
6.25% space overhead, matching the paper's "plain bitvectors" setup.

Operations: ``access``, batched ``rank``, and ``range_distinct`` — the
range-distinct-symbol enumeration of Sec. 3.5 with the B[v]/D[v]
subtree-pruning hooks of Secs. 4.1–4.2 exposed as callbacks.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

_WORD = 64
_SB_WORDS = 8  # superblock = 8 words = 512 bits


class BitVector:
    """Immutable bitvector with O(1) batched rank."""

    def __init__(self, bits: np.ndarray):
        bits = np.asarray(bits, dtype=bool)
        self.n = int(bits.size)
        nwords = max(1, (self.n + _WORD - 1) // _WORD)
        # pad to a whole number of superblocks, plus one extra superblock so
        # the 8-word rank window at i == n never reads out of bounds
        nwords = ((nwords + _SB_WORDS - 1) // _SB_WORDS) * _SB_WORDS + _SB_WORDS
        padded = np.zeros(nwords * _WORD, dtype=bool)
        padded[: self.n] = bits
        # little-endian bit order within each word
        self.words = np.packbits(
            padded.reshape(nwords, _WORD), axis=1, bitorder="little"
        ).view(np.uint64).reshape(nwords)
        pc = np.bitwise_count(self.words).astype(np.uint32)
        sb = pc.reshape(-1, _SB_WORDS).sum(axis=1, dtype=np.uint64)
        self.sb_rank = np.zeros(sb.size + 1, dtype=np.uint64)
        np.cumsum(sb, out=self.sb_rank[1:])

    def rank1(self, i):
        """# of 1-bits in [0, i). ``i`` may be a scalar or an array."""
        i = np.asarray(i, dtype=np.int64)
        sb = i >> 9  # / 512
        w0 = sb * _SB_WORDS
        wq = i >> 6
        # popcount the whole 8-word superblock window with masks
        offs = np.arange(_SB_WORDS, dtype=np.int64)
        widx = w0[..., None] + offs  # (..., 8)
        words = self.words[widx]
        rel = wq[..., None] - widx  # >0: full word; ==0: partial; <0: none
        inword = np.asarray(i & 63, dtype=np.uint64)[..., None]
        partial_mask = np.where(
            inword == 0, np.uint64(0), (~np.uint64(0)) >> (np.uint64(64) - inword)
        )
        mask = np.where(rel > 0, ~np.uint64(0), np.where(rel == 0, partial_mask, np.uint64(0)))
        cnt = np.bitwise_count(words & mask).sum(axis=-1, dtype=np.int64)
        out = self.sb_rank[sb].astype(np.int64) + cnt
        return out if out.ndim else int(out)

    def rank0(self, i):
        i_arr = np.asarray(i, dtype=np.int64)
        out = i_arr - self.rank1(i_arr)
        return out if out.ndim else int(out)

    def get(self, i):
        i = np.asarray(i, dtype=np.int64)
        out = (self.words[i >> 6] >> np.asarray(i & 63, dtype=np.uint64)) & np.uint64(1)
        out = out.astype(np.int64)
        return out if out.ndim else int(out)

    def size_bytes(self) -> int:
        return self.words.nbytes + self.sb_rank.nbytes


class WaveletTree:
    """Balanced wavelet tree over ``seq`` with alphabet [0, sigma)."""

    def __init__(self, seq: np.ndarray, sigma: int):
        seq = np.asarray(seq, dtype=np.int64)
        assert sigma >= 1
        if seq.size and int(seq.max()) >= sigma:
            raise ValueError("symbol out of range")
        self.n = int(seq.size)
        self.sigma = int(sigma)
        self.levels = max(1, int(sigma - 1).bit_length())
        self.bvs: List[BitVector] = []
        cur = seq
        for l in range(self.levels):
            shift = self.levels - 1 - l
            self.bvs.append(BitVector((cur >> shift) & 1))
            if l + 1 < self.levels:
                order = np.argsort(cur >> shift, kind="stable")
                cur = cur[order]

    # -- point queries ------------------------------------------------------
    def access(self, i):
        """seq[i] for scalar or array i."""
        i = np.asarray(i, dtype=np.int64)
        node_b = np.zeros_like(i)
        node_e = np.full_like(i, self.n)
        pos = i
        sym = np.zeros_like(i)
        for l in range(self.levels):
            bv = self.bvs[l]
            bit = bv.get(pos)
            r_nb = bv.rank1(node_b)
            r_pos = bv.rank1(pos)
            r_ne = bv.rank1(node_e)
            ones_node = r_ne - r_nb
            zeros_node = (node_e - node_b) - ones_node
            in_zeros = (pos - node_b) - (r_pos - r_nb)
            in_ones = r_pos - r_nb
            go_right = bit == 1
            new_node_b = np.where(go_right, node_b + zeros_node, node_b)
            new_node_e = np.where(go_right, node_e, node_b + zeros_node)
            pos = np.where(go_right, new_node_b + in_ones, node_b + in_zeros)
            node_b, node_e = new_node_b, new_node_e
            sym = (sym << 1) | bit
        return sym if sym.ndim else int(sym)

    def rank(self, c, i):
        """# of occurrences of symbol c in seq[0:i); c, i scalars or arrays
        (broadcast together)."""
        c = np.asarray(c, dtype=np.int64)
        i = np.asarray(i, dtype=np.int64)
        c, i = np.broadcast_arrays(c, i)
        c = c.astype(np.int64)
        node_b = np.zeros(c.shape, dtype=np.int64)
        node_e = np.full(c.shape, self.n, dtype=np.int64)
        pos = i.astype(np.int64).copy()
        for l in range(self.levels):
            bv = self.bvs[l]
            shift = self.levels - 1 - l
            bit = (c >> shift) & 1
            r_nb = bv.rank1(node_b)
            r_pos = bv.rank1(pos)
            r_ne = bv.rank1(node_e)
            ones_node = r_ne - r_nb
            zeros_node = (node_e - node_b) - ones_node
            in_zeros = (pos - node_b) - (r_pos - r_nb)
            in_ones = r_pos - r_nb
            go_right = bit == 1
            new_node_b = np.where(go_right, node_b + zeros_node, node_b)
            new_node_e = np.where(go_right, node_e, node_b + zeros_node)
            pos = np.where(go_right, new_node_b + in_ones, node_b + in_zeros)
            node_b, node_e = new_node_b, new_node_e
        out = pos - node_b
        return out if out.ndim else int(out)

    # -- range distinct (Sec. 3.5 warmup + Secs. 4.1/4.2 pruning) -----------
    def range_distinct(
        self,
        b: int,
        e: int,
        prune: Optional[Callable[[int, int, bool], bool]] = None,
        probe: Optional[Callable[[], bool]] = None,
    ) -> Iterator[Optional[Tuple[int, int, int]]]:
        """Yield ``(symbol, rank_b, rank_e)`` for every distinct symbol in
        seq[b:e): rank_b/rank_e are rank_symbol(b), rank_symbol(e), i.e.
        the within-leaf interval — exactly what backward search needs.

        ``prune(level, prefix, covered) -> True`` skips a whole subtree
        (B[v]/D[v] pruning of Secs. 4.1–4.2); ``covered`` tells whether the
        query interval spans the node's whole interval (used for sound
        D[v] updates).  Cost: O(log sigma) per reported symbol
        (Theorem 4.1 charging).

        ``probe()`` is called before every stack pop: the caller's
        deadline check, which counts the pops (across calls, if it likes)
        and reads its clock every so often — this module reads none.
        When it returns True the enumeration yields ``None`` there, a
        checkpoint: the caller may stop (close the generator) or go on
        iterating, which resumes exactly where it was.  A probe may also
        raise, which ends the enumeration.  While no probe fires, the
        output is the same as without one.
        """
        if e <= b:
            return
        # stack: (level, prefix, node_b, node_e, b, e)
        stack = [(0, 0, 0, self.n, int(b), int(e))]
        while stack:
            if probe is not None and probe():
                yield None
            l, prefix, nb, ne, qb, qe = stack.pop()
            if qe <= qb:
                continue
            if prune is not None and prune(l, prefix, qb == nb and qe == ne):
                continue
            if l == self.levels:
                yield prefix, qb - nb, qe - nb
                continue
            bv = self.bvs[l]
            r_nb = int(bv.rank1(nb))
            r_ne = int(bv.rank1(ne))
            r_qb = int(bv.rank1(qb))
            r_qe = int(bv.rank1(qe))
            ones_node = r_ne - r_nb
            zeros_node = (ne - nb) - ones_node
            # left child (bit 0)
            lqb = nb + (qb - nb) - (r_qb - r_nb)
            lqe = nb + (qe - nb) - (r_qe - r_nb)
            if lqe > lqb:
                stack.append((l + 1, prefix << 1, nb, nb + zeros_node, lqb, lqe))
            # right child (bit 1)
            rb_ = nb + zeros_node + (r_qb - r_nb)
            re_ = nb + zeros_node + (r_qe - r_nb)
            if re_ > rb_:
                stack.append((l + 1, (prefix << 1) | 1, nb + zeros_node, ne, rb_, re_))

    def size_bytes(self) -> int:
        return sum(bv.size_bytes() for bv in self.bvs)
