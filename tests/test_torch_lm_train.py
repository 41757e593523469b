"""The port's training substrate on the CPU: data batches equal to the
JAX package's token for token, the training loop (loss decreases, resume
after a simulated failure equals the uninterrupted run), trainer
checkpoints crossing between the packages in both directions, the
checkpoint's zlib parts, and the three launchers.  Entry points without
a device raise when there is no card."""
from dataclasses import replace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as rckpt  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.train import loop as rloop  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import fixtures  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import path_lm as lpath  # noqa: E402
from repro_torch.launch import serve as lserve  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.train import loop, optim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

QUIET = dict(log_every=0, log_fn=lambda s: None)


def _tiny(cfg):
    return replace(cfg, num_layers=2, d_model=32, num_heads=2,
                   num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64)


def tiny_cfg():
    """The reference's ``_tiny_cfg`` (``tests/test_substrate.py``)."""
    return _tiny(smoke_variant(get_config("smollm-135m")))


def rtiny_cfg():
    return _tiny(rsmoke(rget_config("smollm-135m")))


def _rtarget(rcfg):
    return jax.eval_shape(lambda k: rstep.init_state(rcfg, k),
                          jax.ShapeDtypeStruct((2,), np.uint32))


# -- data ---------------------------------------------------------------------

def test_synthetic_batches_equal_reference():
    for kw in (dict(vocab_size=100, seq_len=16, global_batch=4, seed=3),
               dict(vocab_size=49152, seq_len=64, global_batch=2)):
        d, r = pipeline.SyntheticLM(**kw), rpipe.SyntheticLM(**kw)
        for step in (0, 1, 7):
            got, want = d.batch(step), r.batch(step)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        assert d.state(5) == r.state(5)


@pytest.mark.parametrize("which", ["metro", "example"])
def test_path_corpus_batches_equal_reference(which):
    """On ``metro_graph`` with ``l5+/bus``, and on the path-LM example's
    graph with its expression: every batch token for token."""
    if which == "metro":
        g, rg, kw = (fixtures.metro_graph(), rfix.metro_graph(),
                     dict(seq_len=32, global_batch=4, expr="l5+/bus", seed=1))
    else:
        g = fixtures.scale_free_graph(2000, 8, 16000, seed=11)
        rg = rfix.scale_free_graph(2000, 8, 16000, seed=11)
        kw = dict(seq_len=128, global_batch=8, expr="(0|1)/2*/(3|4)+", seed=0)
    d, r = pipeline.PathCorpus(g, **kw), rpipe.PathCorpus(rg, **kw)
    assert d.vocab_size == r.vocab_size
    for step in (0, 3):
        got, want = d.batch(step), r.batch(step)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert (got["tokens"] > 0).any()
    assert d.state(2) == r.state(2)


# -- the loop -----------------------------------------------------------------

def test_train_loss_decreases():
    """The reference's ``test_train_loss_decreases`` on the port."""
    cfg = tiny_cfg()
    data = pipeline.SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8)
    rep = loop.train(cfg, data, num_steps=30, save_every=0,
                     opt_cfg=optim.AdamWConfig(lr=3e-3, warmup_steps=5,
                                               total_steps=30),
                     device="cpu", **QUIET)
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    assert last < first - 0.2, (first, last)
    assert len(rep.step_seconds) == 30 and rep.data_seconds > 0


def test_losses_follow_reference_run():
    """Both packages' loops from the same weights and batches: the first
    losses within 1e-2 (bf16 compute; the weights drift apart after)."""
    cfg, rcfg = tiny_cfg(), rtiny_cfg()
    data = pipeline.SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=4)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    rep = rloop.train(rcfg, data, num_steps=3, opt_cfg=roptim.AdamWConfig(
        **ocfg), save_every=0, **QUIET)
    # the reference's seed-0 init, loaded into the port
    state = tstep.init_state(cfg, device="cpu")
    rparams = jax.tree.map(np.asarray, rstep.init_state(
        rcfg, jax.random.PRNGKey(0))["params"])
    state["params"].load_state_dict(convert.lm_params_from_reference(rparams))
    step = tstep.make_train_step(cfg, optim.AdamWConfig(**ocfg))
    losses = []
    for s in range(3):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, rep.losses, atol=1e-2, rtol=0)


def _final_state(cfg, path):
    state = tstep.init_state(cfg, seed=1, device="cpu")
    loop.restore_train_state(str(path), state)
    return loop.train_state_tree(state)


def test_resume_after_failure_is_exact(tmp_path):
    """The reference's ``test_resume_after_failure_is_exact`` on the port:
    a simulated preemption at step 8 and a resume from step 5 end in the
    uninterrupted run's state (``rtol=1e-5, atol=1e-6``)."""
    cfg = tiny_cfg()
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    data = pipeline.SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=4)
    d1, d2 = tmp_path / "a", tmp_path / "b"
    with pytest.raises(RuntimeError, match="simulated preemption"):
        loop.train(cfg, data, num_steps=12, opt_cfg=ocfg, ckpt_dir=str(d1),
                   save_every=5, fail_at_step=8, device="cpu", **QUIET)
    rep = loop.train(cfg, data, num_steps=12, opt_cfg=ocfg, ckpt_dir=str(d1),
                     save_every=5, device="cpu", **QUIET)
    assert rep.resumed_from == 5 and rep.steps_run == 7
    loop.train(cfg, data, num_steps=12, opt_cfg=ocfg, ckpt_dir=str(d2),
               save_every=0, device="cpu", **QUIET)
    s1, s2 = _final_state(cfg, d1), _final_state(cfg, d2)
    a, b = ckpt._flatten(s1), ckpt._flatten(s2)
    assert [k for k, _ in a] == [k for k, _ in b]
    assert int(s1["opt"]["step"]) == 12
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_reference_trainer_checkpoint_restores_and_trains_on(tmp_path):
    """A trainer checkpoint written by the JAX package's loop restores into
    the port bit for bit, and the port's loop resumes from it."""
    cfg, rcfg = tiny_cfg(), rtiny_cfg()
    data = pipeline.SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=4)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    rloop.train(rcfg, data, num_steps=4, opt_cfg=roptim.AdamWConfig(**ocfg),
                ckpt_dir=str(tmp_path), save_every=2, **QUIET)
    rstate, extra = rckpt.restore(str(tmp_path), _rtarget(rcfg))
    state = tstep.init_state(cfg, seed=1, device="cpu")
    assert loop.restore_train_state(str(tmp_path), state) == extra
    got = ckpt._flatten(loop.train_state_tree(state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    assert len(got) == len(want)
    for (k, x), (path, y) in zip(got, want):
        assert k == "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    rep = loop.train(cfg, data, num_steps=6, opt_cfg=optim.AdamWConfig(**ocfg),
                     ckpt_dir=str(tmp_path), save_every=0, device="cpu",
                     **QUIET)
    assert rep.resumed_from == 4 and rep.steps_run == 2
    assert np.isfinite(rep.losses).all()


def test_port_trainer_checkpoint_restores_into_reference(tmp_path):
    """The port's trainer checkpoint (zlib, one stream) restores through
    ``repro.checkpoint.restore`` with the reference's ``init_state``
    target, bit for bit, and the reference trains on from it."""
    cfg, rcfg = tiny_cfg(), rtiny_cfg()
    data = pipeline.SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=4)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    rep = loop.train(cfg, data, num_steps=3, opt_cfg=optim.AdamWConfig(**ocfg),
                     ckpt_dir=str(tmp_path), save_every=0, device="cpu",
                     **QUIET)
    import json
    manifest = json.loads(next(tmp_path.glob("step_*/manifest.json"))
                          .read_text())
    assert manifest["codec"] == "zlib"
    rstate, extra = rckpt.restore(str(tmp_path), _rtarget(rcfg), verify=True)
    assert extra["data"]["step"] == 3
    got = ckpt._flatten(loop.train_state_tree(rep.state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    for (k, x), (path, y) in zip(got, want):
        assert k == "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    rrep = rloop.train(rcfg, data, num_steps=5, opt_cfg=roptim.AdamWConfig(
        **ocfg), ckpt_dir=str(tmp_path), save_every=0, **QUIET)
    assert rrep.resumed_from == 3 and np.isfinite(rrep.losses).all()


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_train_state_tree_is_the_reference_layout(which):
    """``train_state_tree`` of a fresh port state has the reference
    ``init_state`` tree's keys, in its order, with its shapes and dtypes
    (the layers stacked on a leading L axis)."""
    if which == "tiny":
        cfg, rcfg = tiny_cfg(), rtiny_cfg()
    else:
        cfg = smoke_variant(get_config("smollm-135m"))
        rcfg = rsmoke(rget_config("smollm-135m"))
    got = ckpt._flatten(loop.train_state_tree(
        tstep.init_state(cfg, device="cpu")))
    want = jax.tree_util.tree_flatten_with_path(_rtarget(rcfg))[0]
    assert [k for k, _ in got] == ["/".join(str(p.key) for p in path)
                                   for path, _ in want]
    for (k, x), (_, y) in zip(got, want):
        assert tuple(x.shape) == tuple(y.shape), k
        assert str(x.dtype).split(".")[-1] == str(y.dtype), k


# -- launchers and devices ----------------------------------------------------

def test_launchers_run_on_the_cpu(tmp_path):
    cfg, rep = ltrain.run(["--arch", "smollm-135m", "--smoke", "--steps", "3",
                           "--seq", "16", "--batch", "2", "--device", "cpu",
                           "--ckpt", str(tmp_path / "t"), "--save-every",
                           "2"], log_fn=lambda s: None)
    assert rep.steps_run == 3 and np.isfinite(rep.losses).all()
    assert ckpt.all_steps(str(tmp_path / "t")) == [2, 3]
    out, model, prompts = lserve.run(["--arch", "smollm-135m", "--smoke",
                                      "--batch", "2", "--prompt-len", "8",
                                      "--gen", "3", "--device", "cpu"])
    assert out["finite"] and prompts["tokens"].shape == (2, 8)
    assert len(out["prefill_s"]) == 2 and out["decode_ms_per_token"] > 0
    report, pcfg, _ = lpath.run(["--steps", "3", "--ckpt", "", "--device",
                                 "cpu"], log_fn=lambda s: None)
    assert report["steps_run"] == 3 and report["vocab"] == pcfg.vocab_size
    assert report["corpus_s"] > 0 and report["steps_s"] > 0


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_cfg()
    data = pipeline.SyntheticLM(cfg.vocab_size, 8, 2)
    for call in (lambda: api.init_params(cfg),
                 lambda: api.init_cache(cfg, 1, 8),
                 lambda: tstep.init_state(cfg),
                 lambda: loop.train(cfg, data, 1, **QUIET),
                 lambda: ltrain.run(["--arch", "smollm-135m", "--smoke",
                                     "--steps", "1"]),
                 lambda: lserve.run(["--arch", "smollm-135m", "--smoke"]),
                 lambda: lpath.run(["--steps", "1", "--ckpt", ""],
                                   log_fn=lambda s: None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_straggler_detection(monkeypatch):
    """The reference's ``test_straggler_detection`` on the port, made to
    assert the mechanism: the loop times each step on its own clock, here
    a virtual one that each step advances by 0.1 s and the injected slow
    step (step 9, 12 steps, ``straggler_factor=2.5``) by 0.5 s more.  That
    step, and no other, is listed in ``straggler_steps``."""
    from types import SimpleNamespace
    cfg = tiny_cfg()
    data = pipeline.SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=4)
    now = [0.0]
    monkeypatch.setattr(loop, "time", SimpleNamespace(
        perf_counter=lambda: now[0]))
    make = loop.make_train_step

    def slow_make(*args, **kwargs):
        step_fn, calls = make(*args, **kwargs), [0]

        def timed(state, batch):
            out = step_fn(state, batch)
            now[0] += 0.1 + (0.5 if calls[0] == 9 else 0.0)
            calls[0] += 1
            return out
        return timed

    monkeypatch.setattr(loop, "make_train_step", slow_make)
    rep = loop.train(cfg, data, num_steps=12, save_every=0,
                     straggler_factor=2.5, device="cpu", **QUIET)
    assert rep.steps_run == 12
    assert rep.straggler_steps == [9]
    assert rep.step_seconds[9] == pytest.approx(0.6)
