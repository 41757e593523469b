"""The LM substrate's parts on the CPU, held to the JAX package on the same
numpy inputs: the config registry, ``rms_norm``, ``apply_rope``, the
blockwise attention forward and its custom backward, ``softmax_xent``,
``lr_schedule`` and one AdamW update.  f32 throughout; the tolerances are
stated at each comparison."""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import list_configs as rlist_configs  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import common as rcommon  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models.losses import softmax_xent as rxent  # noqa: E402
from repro.train import optim as roptim  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    SHAPES, get_config, list_configs, shape_applicable, smoke_variant)
from repro_torch.models import common, layers  # noqa: E402
from repro_torch.models.losses import softmax_xent  # noqa: E402
from repro_torch.train import optim  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_registry_equals_reference():
    """Copied configs: every arch's fields, its smoke variant, its
    parameter count and the shape table agree exactly."""
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import shape_applicable as rapplicable
    assert list_configs() == rlist_configs()
    for name in list_configs():
        cfg, ref = get_config(name), rget_config(name)
        assert asdict(cfg) == asdict(ref), name
        assert asdict(smoke_variant(cfg)) == asdict(rsmoke(ref)), name
        assert cfg.param_count() == ref.param_count(), name
        assert cfg.active_param_count() == ref.active_param_count(), name
        assert (cfg.eff_num_heads, cfg.eff_num_kv_heads, cfg.vocab_padded) \
            == (ref.eff_num_heads, ref.eff_num_kv_heads, ref.vocab_padded)
        for shape in SHAPES.values():
            assert shape_applicable(cfg, shape) == \
                rapplicable(ref, RSHAPES[shape.name])
    assert get_config("smollm-135m").eff_num_heads == 9


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    pos = np.broadcast_to(np.arange(3, 12), (2, 9)).astype(np.int32)
    want = np.asarray(rcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = common.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **F32)
    want = np.asarray(rcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e4))
    got = common.apply_rope(_t(x), _t(pos), 1e4).numpy()
    np.testing.assert_allclose(got, want, **F32)


def _qkv(seed, B=2, T=33, H=4, K=2, Dh=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, T, H, Dh), (B, T, K, Dh), (B, T, K, Dh))]


@pytest.mark.parametrize("causal,prefix_len", [(True, 0), (True, 5),
                                               (False, 0)])
def test_flash_fwd_matches_reference(causal, prefix_len):
    """T = 33 with chunk 7 (padded last chunk), H = 4 over K = 2 KV heads;
    out and lse within f32 tolerance."""
    q, k, v = _qkv(1)
    r_out, r_lse = rlayers._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, 7, 0,
                                      prefix_len, None)
    out, lse = layers._flash_fwd(_t(q), _t(k), _t(v), causal, 7, 0,
                                 prefix_len, None)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), **F32)


def test_flash_fwd_with_cache_offset_matches_reference():
    """The cached prefill path: q at an offset into longer K/V, with only
    ``kv_valid_len`` positions valid."""
    q, _, _ = _qkv(2, T=6)
    _, k, v = _qkv(3, T=20)
    args = (True, 7, 9, 0, 15)
    r_out, _ = rlayers._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), *args)
    out, _ = layers._flash_fwd(_t(q), _t(k), _t(v), *args)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **F32)


@pytest.mark.parametrize("causal,prefix_len", [(True, 0), (True, 5)])
def test_flash_backward_matches_jax_grad(causal, prefix_len):
    """The ``autograd.Function``'s dq/dk/dv against ``jax.grad`` through
    the reference's ``_flash_train`` custom VJP, under a random
    cotangent, within f32 tolerance."""
    q, k, v = _qkv(4)
    ct = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)

    def rloss(q_, k_, v_):
        out = rlayers._flash_train(q_, k_, v_, causal, 7, 0, prefix_len)
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.grad(rloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = layers.flash_attention(tq, tk, tv, causal=causal, chunk=7,
                                 prefix_len=prefix_len)
    (out * _t(ct)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_flash_backward_under_checkpoint_recomputes():
    """Under ``torch.utils.checkpoint`` the Function's forward runs again
    in the backward and its saved tensors come from that run: the grads
    equal the plain run's exactly."""
    from torch.utils.checkpoint import checkpoint
    q, k, v = _qkv(6)

    def grads(remat):
        ts = [_t(a).requires_grad_() for a in (q, k, v)]

        def f(a, b, c):
            return layers.flash_attention(a * 2, b, c, causal=True, chunk=7)

        out = checkpoint(f, *ts, use_reentrant=False) if remat else f(*ts)
        out.square().sum().backward()
        return [t.grad for t in ts]

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = rng.integers(0, 2, (2, 5)).astype(np.int32)
    for m in (None, mask):
        r_loss, r_n = rxent(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m))
        loss, n = softmax_xent(_t(logits), _t(labels),
                               None if m is None else _t(m))
        np.testing.assert_allclose(float(loss), float(r_loss), **F32)
        assert float(n) == float(r_n)
    # the gradient: softmax minus the one-hot label, over every position
    tl = _t(logits).requires_grad_()
    softmax_xent(tl, _t(labels))[0].backward()
    want = jax.grad(lambda x: rxent(x, jnp.asarray(labels))[0])(
        jnp.asarray(logits))
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(want), **F32)


def test_lr_schedule_equals_reference():
    """Warmup and the clipped tail exact (f32); the cosine phase within
    ``lr * eps(f32)``: XLA's f32 ``cos`` on the CPU is its own polynomial,
    not correctly rounded (it differs from the float64 cosine rounded to
    f32 on about 1.3% of inputs), and torch's differs from it by one ulp
    on a few of these steps, which ``lr * 0.45 * (1 + cos)`` carries as an
    absolute error of at most ``lr * 0.45`` ulps of 1.0; every other op of
    the schedule is the same."""
    for cfg_kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1),
                   dict(lr=1e-3, warmup_steps=20, total_steps=300),
                   dict(lr=3e-4, warmup_steps=0, total_steps=7)):
        rcfg, cfg = roptim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
        steps = np.arange(0, cfg.total_steps + 5, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: roptim.lr_schedule(rcfg, s))(
            jnp.asarray(steps)))
        got = optim.lr_schedule(cfg, _t(steps)).numpy()
        flat = (steps < cfg.warmup_steps) | (steps >= cfg.total_steps)
        np.testing.assert_array_equal(got[flat], want[flat])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=cfg.lr * np.finfo(np.float32).eps)


def _tree(rng, shapes, scale=1.0):
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """One update from the same params, grads and (non-zero) moments at
    step 6, clipping (clip 1.0, grad norm about 5) and not: params, moments
    and the grad norm within ``rtol=1e-6``."""
    rng = np.random.default_rng(8)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    p, g = _tree(rng, shapes), _tree(rng, shapes)
    mu = _tree(rng, shapes, 0.1)
    nu = {n: np.abs(a) for n, a in _tree(rng, shapes, 0.01).items()}
    rcfg = roptim.AdamWConfig(lr=1e-2, clip_norm=clip, warmup_steps=3,
                              total_steps=20)
    cfg = optim.AdamWConfig(**rcfg._asdict())
    jt = lambda t: {n: jnp.asarray(a) for n, a in t.items()}  # noqa: E731
    tt = lambda t: {n: _t(a) for n, a in t.items()}  # noqa: E731
    rp, rs, rm = roptim.update(jt(g), {"mu": jt(mu), "nu": jt(nu),
                                       "step": jnp.int32(5)}, jt(p), rcfg)
    step = torch.tensor(5, dtype=torch.int32)
    tp, ts, tm = optim.update(tt(g), {"mu": tt(mu), "nu": tt(nu),
                                      "step": step}, tt(p), cfg)
    tight = dict(rtol=1e-6, atol=0)
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(rp[n]), **tight)
        for k in ("mu", "nu"):
            np.testing.assert_allclose(ts[k][n].numpy(),
                                       np.asarray(rs[k][n]), **tight)
    assert int(ts["step"]) == int(rs["step"]) == 6
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               **tight)
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), **tight)


def test_adamw_converges_quadratic():
    """The reference's ``test_adamw_converges_quadratic`` on the port."""
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.init(params)
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, min_lr_ratio=1.0)
    for _ in range(200):
        params, state, _ = optim.update({"w": 2 * params["w"]}, state, params,
                                        cfg)
    assert float(params["w"].abs().max()) < 1e-2
