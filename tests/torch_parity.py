"""Shared checks for the port-vs-reference parity tests
(``tests/test_torch_*.py``): the same graph and queries through the JAX
package's ring engine and the port's, with the kernel path forced."""
from repro.core.oracle import eval_oracle
from repro.core.ring import Ring as RRing
from repro.core.rpq import QueryStats as RStats, RingRPQ as RRPQ
from repro_torch import convert
from repro_torch.core.ring import Ring as PRing
from repro_torch.core.rpq import QueryStats as PStats, RingRPQ as PRPQ

COUNTERS = ("node_state_activations", "kernel_batches", "kernel_tasks")
BINDINGS = [(None, None), (None, 0), (0, None), (0, 1)]


def engines(g, **kw):
    """(reference, port) engines over the same graph, kernel path forced."""
    ref = RRPQ(RRing(g), kernel_threshold=1, **kw)
    port = PRPQ(PRing(convert.graph_from_reference(g)), kernel_threshold=1,
                device="cpu", **kw)
    return ref, port


def check_eval(ref, port, g, expr, s, o):
    rs, ps = RStats(), PStats()
    want = ref.eval(expr, s, o, stats=rs)
    got = port.eval(expr, s, o, stats=ps)
    assert got == want == eval_oracle(g, expr, s, o), (expr, s, o)
    for f in COUNTERS:
        assert getattr(ps, f) == getattr(rs, f), (expr, s, o, f)
    assert ps.plan_mode == rs.plan_mode
    return got


def check_eval_many(ref, port, g, queries):
    rstats, pstats = [], []
    want = ref.eval_many(queries, stats_out=rstats)
    got = port.eval_many(queries, stats_out=pstats)
    assert got == want
    for q, res in zip(queries, got):
        assert res == eval_oracle(g, *q), q
    for r, p in zip(rstats, pstats):
        for f in COUNTERS:
            assert getattr(p, f) == getattr(r, f), f
    assert port.bundle_kernel_batches == ref.bundle_kernel_batches
    return got
