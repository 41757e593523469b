"""Live updates (add_edges / remove_edges / compact) on the port's ring
engine against the JAX package's, with the kernel path forced (see
``torch_parity``): equal answers, work counters and effective graphs at
every epoch."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fixtures as rfix  # noqa: E402
from torch_parity import (BINDINGS, check_eval,  # noqa: E402
                          check_eval_many, engines)


@pytest.mark.parametrize("seed", [0, 1])
def test_live_updates_parity(seed):
    rnd = random.Random(seed)
    g = rfix.random_graph(30, 3, 100, seed=seed + 3)
    ref, port = engines(g)
    exprs = ["0/1*", "(0|2)/1", "^1/0*"]

    def check_epoch():
        assert port.epoch == ref.epoch
        eff = ref.effective_graph()
        pe = port.effective_graph()
        for f in ("s", "p", "o"):
            np.testing.assert_array_equal(getattr(pe, f), getattr(eff, f))
        for expr in exprs:
            for s, o in BINDINGS:
                check_eval(ref, port, eff, expr, s, o)
        qs = [(e, None, rnd.randrange(30)) for e in exprs]
        check_eval_many(ref, port, eff, qs)

    check_epoch()
    for step in range(2):
        adds = [(rnd.randrange(30), rnd.randrange(3), rnd.randrange(30))
                for _ in range(4)]
        s, p, o = g.s[step], g.p[step], g.o[step]
        rems = [(int(s), int(p), int(o))]
        assert port.add_edges(adds) == ref.add_edges(adds)
        check_epoch()
        assert port.remove_edges(rems) == ref.remove_edges(rems)
        check_epoch()
    port.compact()
    ref.compact()
    assert port.compactions == ref.compactions == 1
    check_epoch()
