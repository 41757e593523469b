"""The dense LM as a whole on the CPU, held to the JAX package on the same
converted parameters and numpy tokens: the parameter-layout round trip
(exact), bf16 logits, loss and every gradient leaf, decode consistency
and decode against the reference's decode.  Both packages compute in
bf16 with f32 reductions; the bounds are the reference's own decode
bound (``tests/test_models.py``) and the ones stated at each test."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import api  # noqa: E402

KEY = jax.random.PRNGKey(0)


def tiny_cfg(cfg):
    """The reference's ``_tiny_cfg`` (``tests/test_substrate.py``)."""
    return replace(cfg, num_layers=2, d_model=32, num_heads=2,
                   num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64)


CONFIGS = {
    # (port config, reference config)
    "tiny": lambda: (tiny_cfg(smoke_variant(get_config("smollm-135m"))),
                     tiny_cfg(rsmoke(rget_config("smollm-135m")))),
    "smollm-smoke": lambda: (smoke_variant(get_config("smollm-135m")),
                             rsmoke(rget_config("smollm-135m"))),
    # untied (an lm_head, a bf16 residual stream) and qk-norm
    "qwen3-smoke": lambda: (smoke_variant(get_config("qwen3-4b")),
                            rsmoke(rget_config("qwen3-4b"))),
}


def pair(name):
    """(port cfg, ref cfg, reference params, port model on the CPU with
    the same weights)."""
    cfg, rcfg = CONFIGS[name]()
    rparams = rapi.init_params(rcfg, KEY)
    tree = jax.tree.map(np.asarray, rparams)
    model = api.init_params(cfg, seed=1, device="cpu")
    model.load_state_dict(convert.lm_params_from_reference(tree))
    return cfg, rcfg, rparams, model


def _tokens(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_param_layout_round_trip_is_exact():
    """reference tree -> port state dict -> model -> reference tree, bit
    for bit, with the layers stacked on the leading axis."""
    cfg, _, rparams, model = pair("qwen3-smoke")
    tree = jax.tree.map(np.asarray, rparams)
    back = convert.lm_params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert back["layers"]["attn"]["wq"].shape[0] == cfg.num_layers
    assert "layers.1.attn.q_norm" in dict(model.named_parameters())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_loss_and_grads_match_reference(name):
    """bf16 forward and backward on the same params: logits within
    ``0.1 * max|ref| + 0.06``, loss within 1e-2, every gradient leaf's
    relative L2 error at most 5e-2 (remat on, as configured)."""
    cfg, rcfg, rparams, model = pair(name)
    assert cfg.remat
    toks, labels = _tokens(cfg, 2, 24, 3)
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}

    rlogits, _, _ = jax.jit(lambda p, t: rtf.forward(
        p, rcfg, NO_SHARD, tokens=t))(rparams, rbatch["tokens"])
    with torch.no_grad():
        logits, _, _ = model(batch["tokens"])
    assert logits.dtype == torch.bfloat16
    ref = np.asarray(rlogits, np.float32)
    err = float(np.max(np.abs(logits.float().numpy() - ref)))
    assert err < 0.1 * float(np.max(np.abs(ref))) + 0.06, err

    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rapi.loss_fn(p, b, rcfg, NO_SHARD), has_aux=True))(
        rparams, rbatch)
    loss, _ = api.loss_fn(model, batch, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(rloss)) < 1e-2
    got = convert.lm_tree({n: g.numpy() for n, g in zip(names, grads)})
    want = jax.tree.map(np.asarray, rgrads)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        assert _rel_l2(g, w) <= 5e-2, (jax.tree_util.keystr(path),
                                       _rel_l2(g, w))


def test_remat_leaves_grads_unchanged():
    """``cfg.remat`` (``torch.utils.checkpoint`` per layer) recomputes the
    same forward: equal loss and gradients with it off."""
    cfg, _, _, model = pair("smollm-smoke")
    toks, labels = _tokens(cfg, 2, 20, 4)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    outs = []
    for c in (cfg, replace(cfg, remat=False)):
        model.cfg = c
        loss, _ = api.loss_fn(model, batch, c)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        outs.append((loss, grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["tiny", "smollm-smoke", "qwen3-smoke"])
def test_decode_consistency_and_reference_decode(name):
    """prefill(T) + decode(1) equals prefill(T+1)'s last logits within the
    reference's bound (``tests/test_models.py``), and the port's prefill
    and decode logits equal the reference's on the same params within the
    same bound."""
    cfg, rcfg, rparams, model = pair(name)
    B, T = 2, 17
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    ML = T + 1 + 4

    def close(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        err = float(np.max(np.abs(a - b)))
        assert err < 0.1 * (float(np.max(np.abs(b))) + 1e-6) + 0.06, err

    full, _ = api.prefill_fn(model, {"tokens": tt}, cfg, max_len=ML)
    last, cache = api.prefill_fn(model, {"tokens": tt[:, :T]}, cfg,
                                 max_len=ML)
    assert cache["len"] == T
    dec, cache = api.decode_fn(model, cache, tt[:, T:T + 1], cfg)
    assert cache["len"] == T + 1
    close(dec.float().numpy(), full.float().numpy())

    rlast, rcache = rapi.prefill_fn(rparams, {"tokens": jnp.asarray(
        toks[:, :T])}, rcfg, NO_SHARD, max_len=ML)
    rdec, _ = rapi.decode_fn(rparams, rcache, jnp.asarray(toks[:, T:T + 1]),
                             rcfg, NO_SHARD)
    close(last.float().numpy(), rlast)
    close(dec.float().numpy(), rdec)
    # the cache holds the reference's keys and values
    np.testing.assert_allclose(
        cache["kv"]["k"][:, :, :T].float().numpy(),
        np.asarray(rcache["kv"]["k"][:, :, :T], np.float32), atol=0.05,
        rtol=0.02)
