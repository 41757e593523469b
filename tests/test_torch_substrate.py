"""The JAX package's ``tests/test_substrate.py`` tests that had no port
test of their own name, on the port: the cross-entropy against a naive
value and under a mask, the learning-rate schedule, gradient clipping,
elastic restore onto other meshes, the synthetic data's determinism and
the path corpus's RPQ filter.  Tolerances are the reference test's own,
stated at each assert."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fixtures import metro_graph as rmetro_graph  # noqa: E402
from repro.data.pipeline import PathCorpus as RPathCorpus  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import regex as rx  # noqa: E402
from repro_torch.core.fixtures import metro_graph  # noqa: E402
from repro_torch.core.glushkov import Glushkov  # noqa: E402
from repro_torch.data.pipeline import PathCorpus, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.losses import softmax_xent  # noqa: E402
from repro_torch.train import loop, optim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


# -- losses / optimizer ----------------------------------------------------------

def test_xent_matches_naive():
    """``rtol=1e-5`` against the mean of ``-log_softmax`` at the labels."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(2, 5, 11)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 11, (2, 5)).astype(np.int32))
    loss, n = softmax_xent(logits, labels)
    p = torch.log_softmax(logits.double(), dim=-1)
    exp = -torch.gather(p, -1, labels[..., None].long()).mean()
    np.testing.assert_allclose(float(loss), float(exp), rtol=1e-5)
    assert n == 10


def test_xent_mask():
    """Two of four positions counted; uniform logits give log(7),
    ``rtol=1e-5``."""
    logits = torch.zeros((1, 4, 7))
    labels = torch.zeros((1, 4), dtype=torch.int32)
    mask = torch.tensor([[0, 0, 1, 1]], dtype=torch.int32)
    loss, n = softmax_xent(logits, labels, mask)
    assert float(n) == 2.0
    np.testing.assert_allclose(float(loss), np.log(7), rtol=1e-5)


def test_lr_schedule():
    """Half way through the warmup, the end of the cosine (``abs=1e-3``)
    and the peak (``abs=0.05``), as the reference asserts."""
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)

    def lr(step):
        return float(optim.lr_schedule(cfg, torch.tensor(step,
                                                         dtype=torch.int32)))

    assert lr(5) == pytest.approx(0.5)
    assert lr(100) == pytest.approx(0.1, abs=1e-3)
    assert lr(10) == pytest.approx(1.0, abs=0.05)


def test_grad_clip():
    """The update reports the unclipped global norm, 50 for ``[30, 40]``
    (``rel=1e-5``), and clips the step to ``clip_norm``."""
    g = {"w": torch.tensor([30.0, 40.0])}  # norm 50
    p = {"w": torch.zeros(2)}
    st_ = optim.init(p)
    cfg = optim.AdamWConfig(clip_norm=1.0, lr=0.0)
    _, new_state, m = optim.update(g, st_, p, cfg)
    assert float(m["grad_norm"]) == pytest.approx(50.0, rel=1e-5)
    # the first moment holds (1 - b1) times the clipped gradient
    np.testing.assert_allclose(new_state["mu"]["w"].numpy(),
                               (1 - cfg.b1) * np.array([0.6, 0.8]),
                               rtol=1e-6)


# -- elastic restore -------------------------------------------------------------

def _tiny_cfg():
    from dataclasses import replace
    cfg = smoke_variant(get_config("smollm-135m"))
    return replace(cfg, num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
                   head_dim=16, d_ff=64, vocab_size=64)


def _saved(tmp_path, step, seed=0):
    """A one-device trainer state of the tiny config, its weights moved
    off their init, saved at ``step``; returns its flat reference-layout
    leaves."""
    cfg = _tiny_cfg()
    state = tstep.init_state(cfg, seed, "cpu")
    with torch.no_grad():
        for p in state["params"].parameters():
            p.add_(0.25)
    loop.save_train_state(str(tmp_path), step, state,
                          extra={"data": {"step": step}})
    return cfg, dict(ckpt._flatten(loop.train_state_tree(state)))


def _restored_equal(state, want):
    got = dict(ckpt._flatten(loop.train_state_tree(state)))
    assert list(got) == list(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_elastic_restore_different_topology(tmp_path):
    """Saved from a one-device layout, restored onto a (data 1, model 1)
    mesh: the logical checkpoint makes topology a restore-time choice.
    Every leaf lands on that mesh, bit for bit."""
    cfg, want = _saved(tmp_path, 1)
    mesh = make_host_mesh(model=1, shards=1, device="cpu")
    state = tstep.init_state(cfg, 5, "cpu", mesh=mesh)
    loop.restore_train_state(str(tmp_path), state)
    leaf = next(iter(state["params"].values()))
    assert leaf.mesh.shape == {"data": 1, "model": 1}
    _restored_equal(state, want)


def test_elastic_restore_multidevice_subprocess(tmp_path):
    """Saved on one device, restored (``verify=True``) onto a 2 x 4
    (data, model) mesh with the training rules' FSDP + TP layout: the
    data step comes back and the leaves span all 8 coordinates.  The
    reference needs a subprocess for its 8 forced host devices; a port
    mesh is 8 repeats of the host in this process."""
    cfg, want = _saved(tmp_path, 3)
    mesh = make_host_mesh(model=4, shards=8, device="cpu")
    state = tstep.init_state(cfg, 5, "cpu", mesh=mesh)
    extra = loop.restore_train_state(str(tmp_path), state, verify=True)
    assert extra["data"]["step"] == 3
    coords = {c for tree in (state["params"], state["opt"]["mu"],
                             state["opt"]["nu"])
              for leaf in tree.values() for c in leaf.parts}
    assert len(coords) == 8, coords
    assert any(leaf.spec != (None,) * len(leaf.shape)
               for leaf in state["params"].values())
    _restored_equal(state, want)


# -- data pipelines --------------------------------------------------------------

def test_synthetic_deterministic():
    """A batch is a pure function of (seed, step), and equals the
    reference's."""
    from repro.data.pipeline import SyntheticLM as RSyntheticLM
    d = SyntheticLM(100, 16, 4, seed=3)
    b1, b2 = d.batch(7), d.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d.batch(8)["tokens"], b1["tokens"])
    assert b1["tokens"].max() < 100
    np.testing.assert_array_equal(b1["tokens"], RSyntheticLM(
        100, 16, 4, seed=3).batch(7)["tokens"])


def _segments(row):
    """A row's paths: split on BOS = 1, pad 0 stripped, labels shifted
    back by 2."""
    segs, cur = [], []
    for t in row.tolist():
        if t == 1:
            if cur:
                segs.append(cur)
            cur = []
        elif t >= 2:
            cur.append(t - 2)
    if cur:
        segs.append(cur)
    return segs


def test_path_corpus_matches_rpq():
    """Every emitted path segment (the last of a row may be cut by the
    sequence length) is accepted by the port's Glushkov automaton of the
    corpus's expression; the batch equals the reference's."""
    g = metro_graph()
    pc = PathCorpus(g, seq_len=32, global_batch=4, expr="l5+/bus", seed=1)
    b = pc.batch(0)
    assert b["tokens"].shape == (4, 32)
    gk = Glushkov.from_ast(rx.parse("l5+/bus"),
                           lambda l: g.pred_of(l.name, l.inverse))
    for row in b["tokens"]:
        segs = _segments(row)
        assert segs, "no paths sampled"
        for seg in segs[:-1]:
            assert gk.match(seg), seg
    ref = RPathCorpus(rmetro_graph(), seq_len=32, global_batch=4,
                      expr="l5+/bus", seed=1).batch(0)
    np.testing.assert_array_equal(b["tokens"], ref["tokens"])
