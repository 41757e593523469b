"""Deterministic, checkpointable data pipelines: the JAX package's
``data/pipeline.py`` over the port's own ``core`` modules (numpy only, so
a batch equals the reference's token for token).

``SyntheticLM``: hash-derived token streams — step-indexed, so resuming
from a checkpoint reproduces the exact batch sequence with no stored
buffers (the pipeline state is just the step counter).

``PathCorpus``: the paper-integration pipeline — training sequences are
edge-label paths sampled from a labeled graph, optionally constrained to
match an RPQ (accepted by its Glushkov automaton), tokenized as label
ids.  Feeds ``python -m repro_torch.launch.path_lm``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..core import regex as rx
from ..core.glushkov import Glushkov
from ..core.ring import LabeledGraph


@dataclass
class SyntheticLM:
    """batch() is a pure function of (seed, step) — exact-resume for free."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # zipf-ish marginal over tokens, plus a copy structure so a model
        # can actually reduce loss (next-token repeats window tokens)
        B, T = self.global_batch, self.seq_len
        base = rng.zipf(1.3, size=(B, T)).astype(np.int64)
        toks = base % self.vocab_size
        # inject periodic copies: t depends on t-4
        toks[:, 4:] = np.where(rng.random((B, T - 4)) < 0.5,
                               toks[:, :-4], toks[:, 4:])
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def state(self, step: int) -> Dict:
        return {"seed": self.seed, "step": step}


# tokens: 0 = pad/eos, 1 = bos, labels shifted by +2
_BOS, _EOS, _OFF = 1, 0, 2


@dataclass
class PathCorpus:
    """Random-walk (optionally RPQ-filtered) path sampler over a graph."""

    graph: LabeledGraph
    seq_len: int
    global_batch: int
    expr: Optional[str] = None      # RPQ the paths must match (else free walk)
    seed: int = 0
    max_walk: int = 64

    def __post_init__(self):
        g = self.graph
        # CSR by source over the completed graph
        P = g.num_preds
        s = np.concatenate([g.s, g.o])
        p = np.concatenate([g.p, g.p + P])
        o = np.concatenate([g.o, g.s])
        order = np.argsort(s, kind="stable")
        self._s, self._p, self._o = s[order], p[order], o[order]
        self._row = np.searchsorted(self._s, np.arange(g.num_nodes + 1))
        self._glushkov = None
        if self.expr:
            ast = rx.parse(self.expr)
            self._glushkov = Glushkov.from_ast(
                ast, lambda lit: (g.pred_of(lit.name, lit.inverse)))

    @property
    def vocab_size(self) -> int:
        return 2 * self.graph.num_preds + _OFF

    def _walk(self, rng) -> list:
        v = int(rng.integers(0, self.graph.num_nodes))
        out = []
        D = self._glushkov.initial if self._glushkov else None
        for _ in range(self.max_walk):
            b, e = self._row[v], self._row[v + 1]
            if e <= b:
                break
            i = int(rng.integers(b, e))
            lab = int(self._p[i])
            if self._glushkov is not None:
                D2 = self._glushkov.forward_step(D, lab)
                if D2 == 0:
                    break
                D = D2
            out.append(lab)
            v = int(self._o[i])
            if self._glushkov is not None and (D & self._glushkov.F):
                if rng.random() < 0.3:
                    break
        if self._glushkov is not None and not (D & self._glushkov.F):
            return []  # rejected: does not match the RPQ
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        B, T = self.global_batch, self.seq_len
        toks = np.zeros((B, T), dtype=np.int32)
        for bi in range(B):
            row = []
            guard = 0
            while len(row) < T - 1 and guard < 200:
                guard += 1
                w = self._walk(rng)
                if not w:
                    continue
                row += [_BOS] + [x + _OFF for x in w]
            toks[bi, : min(T, len(row))] = row[:T]
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = _EOS
        return {"tokens": toks, "labels": labels}

    def state(self, step: int) -> Dict:
        return {"seed": self.seed, "step": step, "expr": self.expr}
