"""Slot-scheduler and asyncio serving on the port's ring engine, against
the JAX package's, with the kernel path forced (see ``torch_parity``)."""
import random

import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import fixtures as rfix  # noqa: E402
from repro.core.engines import Query as RQuery  # noqa: E402
from repro.core.oracle import eval_oracle  # noqa: E402
from repro.core.scheduler import SlotScheduler as RSched  # noqa: E402
from repro_torch.core.engines import Query  # noqa: E402
from repro_torch.core.scheduler import SlotScheduler as PSched  # noqa: E402
from torch_parity import engines  # noqa: E402


def _script(rnd, V, P, n):
    """A random interleaving of submits, ticks and live updates."""
    ops = []
    exprs = ["0/1*", "(0|1)/2", "2+", "^1/0*", "0/1/2", "(0|2)*"]
    for _ in range(n):
        r = rnd.random()
        if r < 0.45:
            shape = rnd.randrange(4)
            e = rnd.choice(exprs)
            v, w = rnd.randrange(V), rnd.randrange(V)
            ops.append(("submit", (e, None, v) if shape == 0 else
                        (e, v, None) if shape == 1 else
                        (e, v, w) if shape == 2 else (e, None, None)))
        elif r < 0.6:
            ops.append(("update",
                        [(rnd.randrange(V), rnd.randrange(P), rnd.randrange(V))
                         for _ in range(2)],
                        [(rnd.randrange(V), rnd.randrange(P), rnd.randrange(V))]))
        else:
            ops.append(("step",))
    return ops


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000))
def test_scheduler_interleaving_parity(seed):
    """The same random interleaving on both packages' slot schedulers:
    every ticket's answer and epoch agree, and each answer equals the
    oracle on the effective graph at the ticket's admission epoch."""
    rnd = random.Random(seed)
    g = rfix.random_graph(14, 3, 45, seed=seed % 13, pred_zipf=False)
    ref, port = engines(g)
    rs, ps = RSched(ref, max_slots=3), PSched(port, max_slots=3)
    snapshots = {0: ref.effective_graph()}
    tickets = []
    for op in _script(rnd, g.num_nodes, g.num_preds, 24):
        if op[0] == "submit":
            tickets.append((op[1], rs.submit(RQuery(*op[1])),
                            ps.submit(Query(*op[1]))))
        elif op[0] == "update":
            ep = rs.submit_update(add=op[1], remove=op[2])
            assert ps.submit_update(add=op[1], remove=op[2]) == ep
            snapshots[ep] = ref.effective_graph()
        else:
            assert ps.step() == rs.step()
    rs.drain()
    ps.drain()
    for q, rt, pt in tickets:
        assert pt.epoch == rt.epoch
        assert pt.result() == rt.result() == eval_oracle(snapshots[pt.epoch],
                                                         *q)
        assert pt.stats.node_state_activations == \
            rt.stats.node_state_activations
    assert ps.admitted == rs.admitted and ps.completed == rs.completed
    assert port.bundle_kernel_batches == ref.bundle_kernel_batches


def test_async_server_and_flight_recorder_on_port(tmp_path):
    """The port's asyncio pump streams and settles the same answers as
    ``eval_many``; the flight recorder's dump of that run loads back
    with one valid record per request carrying its answer count."""
    import asyncio

    from repro_torch.core.scheduler import AsyncServer
    from repro_torch.obs import recorder as rec

    g = rfix.random_graph(30, 3, 100, seed=8)
    _, port = engines(g)
    queries = [Query("0/1*", obj=v) for v in range(0, 30, 4)] + \
        [Query("(0|2)+", subject=v) for v in range(1, 30, 6)]
    want = port.eval_many(queries)
    port.results.clear()

    async def serve():
        server = AsyncServer(PSched(port, max_slots=3))
        async with server:
            tickets = [await server.submit(q) for q in queries]
            streamed = []
            for t in tickets:
                streamed.append({p async for p in t})
            return [await t.result() for t in tickets], streamed, server

    got, streamed, server = asyncio.run(serve())
    assert got == want and streamed == want
    path = server.scheduler.recorder.dump(str(tmp_path / "flight.jsonl"))
    header, records = rec.load(path)
    rec.validate_header(header)
    assert len(records) == len(queries)
    by_query = {}                       # records arrive in settle order
    for r in records:
        rec.validate_record(r)
        assert r["status"] == "ok"
        by_query[(r["expr"], r["subject"], r["obj"])] = r["results"]
    assert by_query == {(q.expr, q.subject, q.obj): len(w)
                        for q, w in zip(queries, want)}
