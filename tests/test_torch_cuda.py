"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips (a CUDA kernel
has no CPU mode).  This file imports nothing of JAX, so it also runs on
a machine with a card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as tk  # noqa: E402
from repro_torch.core import fixtures  # noqa: E402
from repro_torch.core.ring import Ring  # noqa: E402
from repro_torch.core.engines import Query  # noqa: E402
from repro_torch.core.rpq import QueryStats, RingRPQ  # noqa: E402
from repro_torch.core.scheduler import SlotScheduler  # noqa: E402
from repro_torch.kernels import nfa_step as knfa, ops  # noqa: E402

SHAPES = [(1, 1), (5, 4), (700, 33), (1024, 64), (513, 32), (2048, 7),
          (1000, 700), (16384, 11), (1000, 1300), (1000, 1400), (64, 4096)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, N, S, W):
    X = rng.integers(0, 2**32, (N, W), dtype=np.uint32)   # bits >= S set too
    bwd = rng.integers(0, 2**32, (S, W), dtype=np.uint32)
    return X, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("N,S", SHAPES)
def test_nfa_step_cuda_matches_plain(cuda_device, N, S):
    W = (S + 31) // 32 + (S % 3 == 0)     # some tables narrower than words
    X, bwd = _inputs(np.random.default_rng(N + S), N, S, W)
    Xc = ops.words_to_tensor(X, cuda_device)
    bc = ops.words_to_tensor(bwd, cuda_device)
    tk.reset_launch_counts()
    got = ops.tensor_to_words(ops.nfa_step(Xc, bc))
    assert tk.launch_counts()["nfa_step"] == 1
    want = ops.tensor_to_words(ops.nfa_step(ops.words_to_tensor(X, "cpu"),
                                            ops.words_to_tensor(bwd, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_nfa_step_cuda_rejects_bad_inputs(cuda_device):
    X = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    bwd = torch.zeros((3, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        knfa.nfa_step_cuda(X[:, :1], bwd)          # not contiguous
    with pytest.raises(ValueError):
        knfa.nfa_step_cuda(X, bwd.cpu())           # two devices
    with pytest.raises(TypeError):
        knfa.nfa_step_cuda(X.float(), bwd)
    assert knfa.nfa_step_cuda(X[:0], bwd).shape == (0, 2)


@pytest.mark.cuda
def test_ring_engine_on_card_matches_host(cuda_device):
    g = fixtures.random_graph(200, 4, 900, seed=3)
    ring = Ring(g)
    card = RingRPQ(ring, device=cuda_device, kernel_threshold=1)
    host = RingRPQ(ring, device="cpu", kernel_threshold=1)
    qs = [("0/1*", None, v) for v in range(0, 200, 17)] + \
        [("(0|2)+/^1", v, None) for v in range(3, 200, 29)]
    cs, hs = [], []
    tk.reset_launch_counts()
    assert card.eval_many(qs, stats_out=cs) == host.eval_many(qs, stats_out=hs)
    assert tk.launch_counts()["nfa_step"] > 0
    for a, b in zip(cs, hs):
        assert (a.node_state_activations, a.kernel_tasks) == \
            (b.node_state_activations, b.kernel_tasks)
    st = QueryStats()
    assert card.eval("1+", 5, None, stats=st) == host.eval("1+", 5, None)


def _serving_script(V, P, seed):
    """Submits, a tick after every fourth, with a live update batch every
    ten requests: slots churn, so the dynamic bundle's padded width (the
    kernel's W) and its packed table change between supersteps."""
    rng = np.random.default_rng(seed)
    exprs = ["0/1*/2/(0|3)", "(0|2)+/^1/3*", "2+/1/0", "^1/0*/(2|3)+",
             "0/1/2/3/0", "(0|3)*/1/^2"]
    ops = []
    for i in range(40):
        v = int(rng.integers(V))
        e = exprs[i % len(exprs)]
        ops.append(("submit", (e, v, None) if i % 2 else (e, None, v)))
        if i % 4 == 3:
            ops.append(("step",))
        if i % 10 == 9:
            edges = [(int(rng.integers(V)), int(rng.integers(P)),
                      int(rng.integers(V))) for _ in range(4)]
            ops.append(("update", edges[:3], edges[3:]))
    return ops


def _serve(g, device, script):
    eng = RingRPQ(Ring(g), device=device, kernel_threshold=1)
    sched = SlotScheduler(eng, max_slots=6)
    tickets = []
    for op in script:
        if op[0] == "submit":
            tickets.append(sched.submit(Query(*op[1])))
        elif op[0] == "step":
            sched.step()
        else:
            sched.submit_update(add=op[1], remove=op[2])
    sched.drain()
    widths = {k[2] for k in eng.traces.signatures if k[0] == "nfa_step"}
    return [(t.epoch, t.result()) for t in tickets], widths


@pytest.mark.cuda
def test_slot_scheduler_with_updates_on_card_matches_host(cuda_device):
    g = fixtures.random_graph(200, 4, 900, seed=5)
    script = _serving_script(g.num_nodes, g.num_preds, seed=11)
    tk.reset_launch_counts()
    card, widths = _serve(g, cuda_device, script)
    assert tk.launch_counts()["nfa_step"] > 0
    assert len(widths) > 1                  # W changed as slots churned
    host, _ = _serve(g, "cpu", script)
    assert card == host
    assert {epoch for epoch, _ in card} == {0, 1, 2, 3, 4}
