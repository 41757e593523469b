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


# -- one test body through either package --------------------------------------
# A ported reference test is written once as ``body(P)`` over a namespace of
# one package's entry points; the test runs it on ``REF`` and on ``PORT``
# (every port engine on ``device="cpu"``, every graph through
# ``convert.graph_from_reference``) and asserts the two observations equal.

# wall-clock fields of ``QueryStats``: the only ones two runs may differ in
TIMED_FIELDS = ("queue_wait_s", "service_s", "supersteps_s")


def stats_fields(st):
    """Every ``QueryStats`` field but the scheduler's wall-clock ones."""
    return {k: v for k, v in st.as_dict().items() if k not in TIMED_FIELDS}


def cache_counters(cache):
    """A plan or result cache's counters (a result cache's expirations
    too) and its size."""
    keys = ("hits", "misses", "evictions", "invalidations", "expirations")
    return {k: getattr(cache, k) for k in keys if hasattr(cache, k)} | {
        "len": len(cache)}


def _reference():
    from types import SimpleNamespace

    from repro.core import engines, fixtures, oracle, patterns, planner
    from repro.core import regex, stats, wavelet
    from repro.core.dense import DenseRPQ
    from repro.core.glushkov import Glushkov, build
    from repro.core.ring import LabeledGraph, Ring
    from repro.core.rpq import QueryStats, RingRPQ
    from repro.core.scheduler import SlotScheduler
    from repro.kernels.nfa_step import pack_block_diagonal
    from repro.obs import explain, metrics, trace
    return SimpleNamespace(
        name="reference", graph=lambda g: g, Ring=Ring, RingRPQ=RingRPQ,
        DenseRPQ=DenseRPQ, make_engine=engines.make_engine,
        Query=engines.Query, QueryStats=QueryStats,
        ResultCache=engines.ResultCache, PlanCache=engines.PlanCache,
        PlanBundle=engines.PlanBundle, result_key=engines.result_key,
        normalized_key=engines.normalized_key, eval_many=engines.eval_many,
        LabeledGraph=LabeledGraph, GraphStats=stats.GraphStats,
        BitVector=wavelet.BitVector, WaveletTree=wavelet.WaveletTree,
        Glushkov=Glushkov, build=build, rx=regex, qp=planner,
        fixtures=fixtures, eval_oracle=oracle.eval_oracle,
        product_subgraph_size=oracle.product_subgraph_size,
        classify=patterns.classify,
        generate_workload=patterns.generate_workload,
        pack_block_diagonal=pack_block_diagonal, SlotScheduler=SlotScheduler,
        ox=explain, om=metrics, ot=trace)


def _port():
    from functools import partial
    from types import SimpleNamespace

    from repro_torch.core import engines, fixtures, oracle, patterns
    from repro_torch.core import planner, regex, stats, wavelet
    from repro_torch.core.dense import DenseRPQ
    from repro_torch.core.glushkov import Glushkov, build
    from repro_torch.core.ring import LabeledGraph, Ring
    from repro_torch.core.rpq import QueryStats, RingRPQ
    from repro_torch.core.scheduler import SlotScheduler
    from repro_torch.kernels.nfa_step import pack_block_diagonal
    from repro_torch.obs import explain, metrics, trace
    conv = convert.graph_from_reference
    return SimpleNamespace(
        name="port", graph=conv, Ring=lambda g: Ring(conv(g)),
        RingRPQ=partial(RingRPQ, device="cpu"),
        DenseRPQ=lambda g, **kw: DenseRPQ(conv(g), device="cpu", **kw),
        make_engine=lambda g, kind="ring", **kw: engines.make_engine(
            conv(g), kind, device="cpu", **kw),
        Query=engines.Query, QueryStats=QueryStats,
        ResultCache=engines.ResultCache, PlanCache=engines.PlanCache,
        PlanBundle=engines.PlanBundle, result_key=engines.result_key,
        normalized_key=engines.normalized_key, eval_many=engines.eval_many,
        LabeledGraph=LabeledGraph, GraphStats=stats.GraphStats,
        BitVector=wavelet.BitVector, WaveletTree=wavelet.WaveletTree,
        Glushkov=Glushkov, build=build, rx=regex, qp=planner,
        fixtures=fixtures,
        eval_oracle=lambda g, *a, **kw: oracle.eval_oracle(conv(g), *a, **kw),
        product_subgraph_size=lambda g, *a, **kw:
            oracle.product_subgraph_size(conv(g), *a, **kw),
        classify=patterns.classify,
        generate_workload=patterns.generate_workload,
        pack_block_diagonal=pack_block_diagonal, SlotScheduler=SlotScheduler,
        ox=explain, om=metrics, ot=trace)


REF = _reference()
PORT = _port()


def both(body, *args, **kwargs):
    """``body(P, ...)`` on the reference and on the port: the reference
    test's own asserts run inside ``body`` on each, and the two returned
    observations must be equal.  Returns the port's."""
    want = body(REF, *args, **kwargs)
    got = body(PORT, *args, **kwargs)
    assert got == want
    return got
