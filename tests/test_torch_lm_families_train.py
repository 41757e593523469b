"""The LM substrate's moe, vlm, ssm, hybrid and encdec families through
the trainer and the launchers on the CPU: one train step against the
JAX package's from the same weights and batch, the trainer state in the
reference's stacked layout, trainer checkpoints crossing between the
packages both ways (one MoE, the hybrid and the encdec config), and
``launch.serve`` / ``launch.train`` for each family, which raise without
a card when no device is given."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as rckpt  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.launch import serve as lserve  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.train import loop, optim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from lm_parity import (FAMILIES, KEY, pair, smoke_batch, to_jax,  # noqa: E402
                       to_torch)

QUIET = dict(log_every=0, log_fn=lambda s: None)
CROSSING = ["olmoe-1b-7b", "zamba2-7b", "seamless-m4t-medium"]


def _rtarget(rcfg):
    return jax.eval_shape(lambda k: rstep.init_state(rcfg, k),
                          jax.ShapeDtypeStruct((2,), np.uint32))


# -- one train step ------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    """The reference's ``test_arch_smoke_forward_and_train`` on the port,
    against the reference's train step from the same weights and batch:
    finite loss and gradient norm, the cross-entropy near log(V), the
    second step's loss changed; both steps' losses within 1e-2 of the
    reference's, the gradient norm within 5e-2 relative."""
    cfg, rcfg, rparams, _ = pair(arch)
    ocfg = dict(total_steps=4)
    rstate = rstep.init_state(rcfg, KEY)
    rts = jax.jit(rstep.make_train_step(rcfg, roptim.AdamWConfig(**ocfg)))
    state = tstep.init_state(cfg, seed=1, device="cpu")
    state["params"].load_state_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rstate["params"])))
    ts = tstep.make_train_step(cfg, optim.AdamWConfig(**ocfg))
    nb = smoke_batch(cfg)
    rb, tb = to_jax(nb), to_torch(nb)
    rstate, rm = rts(rstate, rb)
    state, m = ts(state, tb)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    V = cfg.vocab_size
    assert 0.5 * np.log(V) < float(m["xent"]) < 3 * np.log(V)
    assert abs(float(m["loss"]) - float(rm["loss"])) < 1e-2
    assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) < 5e-2
    if cfg.family == "moe":
        assert "moe_aux" in m
    rstate, rm2 = rts(rstate, rb)
    state, m2 = ts(state, tb)
    assert float(m2["loss"]) != float(m["loss"])
    assert abs(float(m2["loss"]) - float(rm2["loss"])) < 1e-2


# -- trainer state and checkpoints --------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_state_tree_is_the_reference_layout(arch):
    """``train_state_tree`` of a fresh port state has the reference
    ``init_state`` tree's keys, in its order, with its shapes and
    dtypes."""
    cfg, rcfg = smoke_variant(get_config(arch)), rsmoke(rget_config(arch))
    got = ckpt._flatten(loop.train_state_tree(
        tstep.init_state(cfg, device="cpu")))
    want = jax.tree_util.tree_flatten_with_path(_rtarget(rcfg))[0]
    assert [k for k, _ in got] == ["/".join(str(p.key) for p in path)
                                   for path, _ in want]
    for (k, x), (_, y) in zip(got, want):
        assert tuple(x.shape) == tuple(y.shape), k
        assert str(x.dtype).split(".")[-1] == str(y.dtype), k


def _trained_port_state(cfg, steps=2):
    state = tstep.init_state(cfg, seed=2, device="cpu")
    ts = tstep.make_train_step(cfg, optim.AdamWConfig(total_steps=4))
    for s in range(steps):
        state, _ = ts(state, to_torch(smoke_batch(cfg, B=2, T=16, seed=s)))
    return state


@pytest.mark.parametrize("arch", CROSSING)
def test_port_trainer_checkpoint_restores_into_reference(arch, tmp_path):
    """A trained port state saved by ``save_train_state`` restores through
    ``repro.checkpoint.restore`` with the reference's ``init_state``
    target, bit for bit, and the reference trains on from it."""
    cfg, rcfg = smoke_variant(get_config(arch)), rsmoke(rget_config(arch))
    state = _trained_port_state(cfg)
    loop.save_train_state(str(tmp_path), 2, state, extra={"data": {"step": 2}})
    rstate, extra = rckpt.restore(str(tmp_path), _rtarget(rcfg), verify=True)
    assert extra["data"]["step"] == 2
    got = ckpt._flatten(loop.train_state_tree(state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    assert len(got) == len(want)
    for (k, x), (path, y) in zip(got, want):
        assert k == "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    rts = jax.jit(rstep.make_train_step(rcfg, roptim.AdamWConfig(
        total_steps=4)))
    _, m = rts(rstate, to_jax(smoke_batch(cfg, B=2, T=16, seed=2)))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("arch", CROSSING)
def test_reference_trainer_checkpoint_restores_into_port(arch, tmp_path):
    """A trained reference state saved by ``repro.checkpoint.save``
    restores into a port state bit for bit, and the port trains on."""
    cfg, rcfg = smoke_variant(get_config(arch)), rsmoke(rget_config(arch))
    rstate = rstep.init_state(rcfg, KEY)
    rts = jax.jit(rstep.make_train_step(rcfg, roptim.AdamWConfig(
        total_steps=4)))
    for s in range(2):
        rstate, _ = rts(rstate, to_jax(smoke_batch(cfg, B=2, T=16, seed=s)))
    rckpt.save(str(tmp_path), 2, rstate, extra={"data": {"step": 2}})
    state = tstep.init_state(cfg, seed=1, device="cpu")
    assert loop.restore_train_state(str(tmp_path), state) == {
        "data": {"step": 2}}
    got = ckpt._flatten(loop.train_state_tree(state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    for (k, x), (path, y) in zip(got, want):
        assert k == "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(state["opt"]["step"]) == 2
    ts = tstep.make_train_step(cfg, optim.AdamWConfig(total_steps=4))
    _, m = ts(state, to_torch(smoke_batch(cfg, B=2, T=16, seed=2)))
    assert np.isfinite(float(m["loss"]))


# -- launchers -----------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_launcher_runs_each_family_on_the_cpu(arch):
    """``launch.serve --smoke``: a vlm's prompt carries patch embeddings,
    an encdec's frames; prefill and greedy decode give finite logits."""
    out, model, prompt = lserve.run(["--arch", arch, "--smoke", "--batch",
                                     "2", "--prompt-len", "8", "--gen", "3",
                                     "--frames", "6", "--device", "cpu"])
    cfg = model.cfg
    assert out["finite"] and prompt["tokens"].shape == (2, 8)
    assert ("patch_embeds" in prompt) == (cfg.family == "vlm")
    if cfg.family == "encdec":
        assert prompt["frames"].shape == (2, 6, cfg.d_model)
    assert len(out["sample"]) == 3


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "zamba2-7b"])
def test_train_launcher_runs_synthetic_families_on_the_cpu(arch, tmp_path):
    """``launch.train --smoke`` on ``SyntheticLM``, with a checkpoint."""
    cfg, rep = ltrain.run(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                           "16", "--batch", "2", "--device", "cpu", "--ckpt",
                           str(tmp_path)], log_fn=lambda s: None)
    assert rep.steps_run == 2 and np.isfinite(rep.losses).all()
    assert ckpt.all_steps(str(tmp_path)) == [2]


@pytest.mark.parametrize("arch", ["paligemma-3b", "seamless-m4t-medium"])
def test_train_launcher_refuses_families_synthetic_cannot_feed(arch):
    with pytest.raises(SystemExit):
        ltrain.run(["--arch", arch, "--smoke", "--steps", "1", "--device",
                    "cpu"])


def test_family_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    moe = smoke_variant(get_config("olmoe-1b-7b"))
    encdec = smoke_variant(get_config("seamless-m4t-medium"))
    for call in (lambda: api.init_params(moe),
                 lambda: api.init_params(encdec),
                 lambda: api.init_cache(encdec, 1, 8, enc_len=4),
                 lambda: tstep.init_state(moe),
                 lambda: lserve.run(["--arch", "paligemma-3b", "--smoke"]),
                 lambda: lserve.run(["--arch", "zamba2-7b", "--smoke"]),
                 lambda: ltrain.run(["--arch", "mamba2-2.7b", "--smoke",
                                     "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
