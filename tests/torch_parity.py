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


# -- the dense engine ------------------------------------------------------------

DENSE_FIELDS = ("results", "supersteps", "retraces", "plan_mode",
                "plan_split_pred", "plan_est_cost", "plan_est_frontier",
                "plan_actual_frontier")


def dense_engines(g, **kw):
    """(reference, port) dense engines over the same graph; the port's
    runs the kernel's plain version on the CPU."""
    from repro.core.dense import DenseRPQ as RDense
    from repro_torch.core.dense import DenseRPQ as PDense
    return RDense(g, **kw), PDense(convert.graph_from_reference(g),
                                   device="cpu", **kw)


def check_dense_eval(ref, port, g, expr, s, o, deadline_s=None):
    """Equal answers (and the oracle's on ``g``), ``QueryStats`` fields
    and engine counters; ``deadline_s`` takes the chunked path, whose
    supersteps the stats count."""
    rs, ps = RStats(), PStats()
    want = ref.eval(expr, s, o, stats=rs, deadline_s=deadline_s)
    got = port.eval(expr, s, o, stats=ps, deadline_s=deadline_s)
    assert got == want == eval_oracle(g, expr, s, o), (expr, s, o)
    for f in DENSE_FIELDS:
        assert getattr(ps, f) == getattr(rs, f), (expr, s, o, f)
    assert port.hetero_dispatches == ref.hetero_dispatches
    assert port.traces.retraces == ref.traces.retraces
    return got


def check_dense_eval_many(ref, port, g, queries, deadline_s=None):
    """``eval_many`` of both packages on the same (expr, subject, obj)
    tuples: equal answers, the oracle's, and equal dispatch counters."""
    from repro.core.engines import Query as RQuery
    from repro_torch.core.engines import Query as PQuery
    want = ref.eval_many([RQuery(*q) for q in queries], deadline_s=deadline_s)
    got = port.eval_many([PQuery(*q) for q in queries], deadline_s=deadline_s)
    assert got == want
    for q, res in zip(queries, got):
        assert res == eval_oracle(g, *q), q
    assert port.hetero_dispatches == ref.hetero_dispatches
    assert port.traces.retraces == ref.traces.retraces
    assert port._superstep_acc == ref._superstep_acc
    return got
