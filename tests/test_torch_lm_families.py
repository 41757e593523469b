"""The LM substrate's moe, vlm, ssm, hybrid and encdec families on the CPU,
held to the JAX package at ``smoke_variant`` sizes on the same converted
parameters and numpy-seeded batches: the parameter-layout round trip
(exact), bf16 logits, loss and every gradient leaf (remat on), decode
consistency and decode against the reference's decode, one train step;
the MoE routing given equal router logits, its aux loss and its padded
experts; the chunked SSD scan against the naive recurrence and the
reference's.  Bounds as ``tests/test_torch_lm_model.py``: logits within
``0.1 * max|ref| + 0.06``, loss within 1e-2, gradients within 5e-2
relative L2."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import encdec as red  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from lm_parity import (FAMILIES, KEY, pair, smoke_batch, to_jax,  # noqa: E402
                       to_torch)

BF16_ULP = 2.0 ** -7          # relative spacing of bf16 values


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def close(a, b):
    """The decode bound of ``tests/test_models.py``."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    err = float(np.max(np.abs(a - b)))
    assert err < 0.1 * (float(np.max(np.abs(b))) + 1e-6) + 0.06, err


# -- every config builds -------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_builds_in_the_port(arch):
    """``api.init_params`` builds each LM config at smoke size, with the
    reference's parameter tree (keys and shapes)."""
    cfg, rcfg = smoke_variant(get_config(arch)), rsmoke(rget_config(arch))
    model = api.init_params(cfg, device="cpu")
    got = convert.lm_params_to_reference(model)
    want = jax.eval_shape(lambda k: rapi.init_params(rcfg, k), KEY)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


# -- parameters ----------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_param_layout_round_trip_is_exact(arch):
    """reference tree -> port state dict -> model -> reference tree, bit
    for bit: the layers stacked on the leading axis of their group
    (``layers``, ``enc_layers``, ``dec_layers``), ``shared_attn``
    nested."""
    cfg, _, rparams, model = pair(arch)
    tree = jax.tree.map(np.asarray, rparams)
    back = convert.lm_params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    again = convert.lm_params_to_reference(
        convert.lm_params_from_reference(tree))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    names = dict(model.named_parameters())
    expect = {"moe": "layers.1.moe.router", "vlm": "layers.1.mlp.wg",
              "ssm": "layers.1.mamba.A_log", "hybrid": "shared_attn.attn.wq",
              "encdec": "dec_layers.1.cross.wk"}[cfg.family]
    assert expect in names


# -- logits, loss, gradients ---------------------------------------------------

def _forward_logits(model, cfg, b):
    with torch.no_grad():
        if cfg.family == "encdec":
            enc = ed.encode(model, b["frames"], cfg)
            return ed.decode(model, b["tokens"], enc, cfg)[0]
        return model(b["tokens"], prefix_embeds=b.get("patch_embeds"))[0]


def _ref_logits(rparams, rcfg, b):
    if rcfg.family == "encdec":
        def f(p, b):
            enc = red.encode(p, b["frames"], rcfg, NO_SHARD)
            return red.decode(p, b["tokens"], enc, rcfg, NO_SHARD)[0]
    else:
        def f(p, b):
            return rtf.forward(p, rcfg, NO_SHARD, tokens=b["tokens"],
                               prefix_embeds=b.get("patch_embeds"))[0]
    return np.asarray(jax.jit(f)(rparams, b), np.float32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_logits_loss_and_grads_match_reference(arch):
    """bf16 forward and backward on the same params and batch: logits
    within ``0.1 * max|ref| + 0.06``, loss within 1e-2 (and a moe's aux
    loss within 1e-3), every gradient leaf's relative L2 error at most
    5e-2, remat on as configured."""
    cfg, rcfg, rparams, model = pair(arch)
    assert cfg.remat
    nb = smoke_batch(cfg, seed=3)
    rb, tb = to_jax(nb), to_torch(nb)

    logits = _forward_logits(model, cfg, tb)
    assert logits.dtype == torch.bfloat16
    close(logits.float().numpy(), _ref_logits(rparams, rcfg, rb))

    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rapi.loss_fn(p, b, rcfg, NO_SHARD), has_aux=True))(
        rparams, rb)
    loss, met = api.loss_fn(model, tb, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(rloss)) < 1e-2
    assert abs(float(met["xent"]) - float(rmet["xent"])) < 1e-2
    if cfg.family == "moe":
        assert abs(float(met["moe_aux"]) - float(rmet["moe_aux"])) < 1e-3
    got = convert.lm_tree({n: g.numpy() for n, g in zip(names, grads)})
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        assert _rel_l2(g, w) <= 5e-2, (jax.tree_util.keystr(path),
                                       _rel_l2(g, w))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_remat_leaves_grads_unchanged(arch):
    """``torch.utils.checkpoint`` per layer recomputes the same forward:
    equal loss and gradients with ``remat`` off."""
    cfg, _, _, model = pair(arch)
    tb = to_torch(smoke_batch(cfg, seed=4))
    outs = []
    for c in (cfg, replace(cfg, remat=False)):
        loss, _ = api.loss_fn(model, tb, c)
        outs.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


# -- decode --------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_consistency_and_reference_decode(arch):
    """The reference's ``test_arch_decode_consistency`` on the port:
    prefill(T) + decode(1) equals prefill(T+1)'s last logits; and the
    port's prefill and decode logits equal the reference's on the same
    params, within the same bound."""
    cfg, rcfg, rparams, model = pair(arch)
    B, T = 2, 17
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    extra, Np = {}, 0
    if cfg.family == "vlm":
        Np = cfg.num_prefix_embeds
        extra["patch_embeds"] = rng.normal(size=(B, Np, cfg.d_model)).astype(
            np.float32)
    elif cfg.family == "encdec":
        extra["frames"] = rng.normal(size=(B, 8, cfg.d_model)).astype(
            np.float32)
    ML = T + 1 + Np + 4
    full_b = to_torch({**extra, "tokens": toks})
    head_b = to_torch({**extra, "tokens": toks[:, :T]})
    nxt = torch.from_numpy(toks[:, T:T + 1]).long()

    full, _ = api.prefill_fn(model, full_b, cfg, max_len=ML)
    last, cache = api.prefill_fn(model, head_b, cfg, max_len=ML)
    assert cache["len"] == T + Np
    dec, cache = api.decode_fn(model, cache, nxt, cfg)
    assert cache["len"] == T + Np + 1
    close(dec.float().numpy(), full.float().numpy())

    rlast, rcache = rapi.prefill_fn(
        rparams, to_jax({**extra, "tokens": toks[:, :T]}), rcfg, NO_SHARD,
        max_len=ML)
    rdec, _ = rapi.decode_fn(rparams, rcache, jnp.asarray(toks[:, T:T + 1]),
                             rcfg, NO_SHARD)
    close(last.float().numpy(), rlast)
    close(dec.float().numpy(), rdec)


def test_hybrid_cache_has_one_kv_slot_a_group():
    """zamba2's 81 layers: 13 groups of 6 and 3 tail layers; the shared
    block's KV cache one slot a group, the SSM state one a layer."""
    cfg = get_config("zamba2-7b")
    assert cfg.num_layers // cfg.attn_period == 13
    small = replace(smoke_variant(cfg), num_layers=7, attn_period=3)
    cache = api.init_cache(small, 2, 16, device="cpu")
    assert cache["kv"]["k"].shape[0] == 2
    assert cache["ssm"]["ssm"].shape[0] == 7
    assert cache["ssm"]["ssm"].dtype == torch.float32


# -- MoE -----------------------------------------------------------------------

def _moe_cfgs():
    """(port, reference) configs: qwen2-moe's smoke variant (shared
    experts), and olmoe's widths of routing: 64 experts top-8 at smoke
    width, with 60 of 64 real (the padding of qwen2-moe's 60)."""
    q, rq = smoke_variant(get_config("qwen2-moe-a2.7b")), rsmoke(
        rget_config("qwen2-moe-a2.7b"))
    kw = dict(num_experts=60, top_k=8, tp_divisor=16)
    o, ro = (replace(smoke_variant(get_config("olmoe-1b-7b")), **kw),
             replace(rsmoke(rget_config("olmoe-1b-7b")), **kw))
    assert o.eff_num_experts == 64
    return [(q, rq), (o, ro)]


def test_moe_padded_experts_never_routed():
    """The reference's ``test_moe_padded_experts_never_routed``."""
    rcfg = replace(rsmoke(rget_config("qwen2-moe-a2.7b")), num_experts=3,
                   top_k=2, tp_divisor=4)
    cfg = replace(smoke_variant(get_config("qwen2-moe-a2.7b")), num_experts=3,
                  top_k=2, tp_divisor=4)
    assert cfg.eff_num_experts == 4
    p = rlayers.init_moe(KEY, rcfg)
    x = np.random.default_rng(0).normal(size=(64, cfg.d_model)).astype(
        np.float32)
    _, _, top_e = layers.moe_router(
        {"router": torch.from_numpy(np.array(p["router"])).bfloat16()},
        torch.from_numpy(x), cfg)
    assert int(top_e.max()) < 3
    _, _, rtop_e = rlayers._moe_router(p, jnp.asarray(x), rcfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(rtop_e))


@pytest.mark.parametrize("which", [0, 1])
def test_moe_router_product_within_one_bf16_ulp(which):
    """The router logits of the same bf16 input and weights: the port's
    within one bf16 ulp of the reference's (compiled: XLA keeps the dot's
    f32 result, as the port's f32 product of the bf16 values does)."""
    cfg, rcfg = _moe_cfgs()[which]
    p = rlayers.init_moe(KEY, rcfg)
    x = np.random.default_rng(1).normal(size=(96, cfg.d_model)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda x, w: jnp.einsum(
        "gd,de->ge", x, w.astype(jnp.bfloat16)).astype(jnp.float32))(
        xb, p["router"]))
    got = torch.matmul(torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
                       .float(), torch.from_numpy(np.array(
                           p["router"])).bfloat16().float()).numpy()
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-30)


def _ref_queue_positions(top_e, E, C):
    """The reference's queue positions (``models/layers.py`` 361-364)."""
    g, k = top_e.shape
    onehot = jax.nn.one_hot(top_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot.reshape(g * k, E), axis=0).reshape(g, k, E) - 1
    pos = (pos * onehot).sum(-1)
    return np.asarray(pos), np.asarray(pos < C)


@pytest.mark.parametrize("which", [0, 1])
def test_moe_routing_given_equal_logits(which):
    """From identical f32 logits fed to both (one-hot inputs pick router
    rows, so both products are exact): ``top_e``, the queue positions and
    the kept mask equal exactly, ties (zero rows, the padding of a group,
    and duplicated logits) going to the lower expert; ``top_p`` within 4
    f32 ulps (XLA's and torch's f32 ``exp`` differ in the last bit), and
    exactly equal from identical probabilities."""
    cfg, rcfg = _moe_cfgs()[which]
    E, k, d = cfg.eff_num_experts, cfg.top_k, cfg.d_model
    rng = np.random.default_rng(2)
    router = np.asarray(jnp.asarray(rng.normal(size=(d, E)), jnp.bfloat16),
                        np.float32)
    router[5, 1] = router[5, 2] = router[5, 3] = router[5].max()  # ties
    xg = np.zeros((d + 16, d), np.float32)          # 16 zero rows at the end
    xg[np.arange(d), np.arange(d)] = 1.0
    C = layers.capacity(cfg, xg.shape[0])
    rprobs, rtop_p, rtop_e = jax.jit(lambda p, x: rlayers._moe_router(
        p, x, rcfg))({"router": jnp.asarray(router)}, jnp.asarray(xg))
    probs, top_p, top_e = layers.moe_router(
        {"router": torch.from_numpy(router).bfloat16()}, torch.from_numpy(xg),
        cfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(rtop_e))
    assert (top_e[-16:] == torch.arange(k)).all()        # uniform: lowest k
    if E > cfg.num_experts:
        assert int(top_e.max()) < cfg.num_experts
    np.testing.assert_allclose(top_p.numpy(), np.asarray(rtop_p), rtol=4 *
                               np.finfo(np.float32).eps, atol=0)
    pos, within = layers.queue_positions(top_e, E, C)
    rpos, rwithin = _ref_queue_positions(rtop_e, E, C)
    np.testing.assert_array_equal(pos.numpy(), rpos)
    np.testing.assert_array_equal(within.numpy(), rwithin)
    # the same probabilities into both top-k and renormalisations
    tp, te = layers.top_k(torch.from_numpy(np.array(rprobs)), k)
    tp = tp / torch.clamp(tp.sum(-1, keepdim=True), min=1e-9)
    np.testing.assert_array_equal(te.numpy(), np.asarray(rtop_e))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rtop_p))


def test_moe_queue_drops_past_capacity():
    """Every (token, slot) past the C-th of its expert is dropped, in
    (token, slot) order."""
    top_e = torch.tensor([[0, 1], [0, 2], [0, 1], [1, 0]])
    pos, within = layers.queue_positions(top_e, 3, 2)
    assert pos.tolist() == [[0, 0], [1, 0], [2, 1], [2, 3]]
    assert within.tolist() == [[True, True], [True, True], [False, True],
                               [False, False]]


@pytest.mark.parametrize("which", [0, 1])
def test_moe_block_and_aux_match_reference(which):
    """``moe_block`` with groups of 16 (three groups, the last padded,
    some tokens dropped) and ``moe_block_dropless`` on the same bf16
    weights and input: outputs within the decode bound, the aux loss
    within 1e-5 relative."""
    cfg, rcfg = _moe_cfgs()[which]
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                     rlayers.init_moe(KEY, rcfg))
    tp = convert.lm_params_from_reference(jax.tree.map(np.asarray, p))
    tp = {k: v.bfloat16() for k, v in tp.items()}
    tree = convert.lm_tree(tp)
    x = np.random.default_rng(3).normal(size=(2, 21, cfg.d_model)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
    ry, raux = jax.jit(lambda p, x: rlayers.moe_block(
        p, x, rcfg, NO_SHARD, group_size=16))(p, xb)
    y, aux = layers.moe_block(tree, xt, cfg, group_size=16)
    _, _, te = layers.moe_router(tree, _groups(xt, 16), cfg)
    assert not layers.queue_positions(te, cfg.eff_num_experts,
                                      layers.capacity(cfg, 16))[1].all()
    close(y.float().numpy(), ry)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    ry, _ = jax.jit(lambda p, x: rlayers.moe_block_dropless(
        p, x, rcfg, NO_SHARD))(p, xb)
    y, aux = layers.moe_block_dropless(tree, xt, cfg)
    close(y.float().numpy(), ry)
    assert aux == 0.0


def _groups(x, g):
    """x [B, T, d] as groups of ``g`` tokens, zero-padded."""
    B, T, d = x.shape
    n = -(-(B * T) // g) * g
    return torch.nn.functional.pad(x.reshape(B * T, d),
                                   (0, 0, 0, n - B * T)).reshape(-1, g, d)


# -- SSM -----------------------------------------------------------------------

def test_ssd_matches_naive_recurrence():
    """The reference's ``test_ssd_matches_naive_recurrence`` on the port's
    ``_ssd_chunked`` (rtol and atol 2e-3), and the port against the
    reference's ``_ssd_chunked`` in f32 within 1e-5."""
    rng = np.random.default_rng(0)
    B, T, H, P, N = 2, 37, 3, 4, 5
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, T, H))).astype(np.float32) * 0.5
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    y, S = ssm._ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                            chunk=8)
    h = np.zeros((B, H, N, P))
    ys = np.zeros((B, T, H, P))
    for t in range(T):
        a = np.exp(dt[:, t, :] * A[None, :])
        h = h * a[:, :, None, None] + np.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], x[:, t])
        ys[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], h)
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(S.numpy(), h, rtol=2e-3, atol=2e-3)
    ry, rS = rssm._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                               chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(rS), rtol=1e-5,
                               atol=1e-5)


def test_ssd_gradients_are_finite_and_match_reference():
    """The exponent is masked before ``exp``: no NaN gradient from the
    dead triangle, and the gradients equal the reference's in f32."""
    rng = np.random.default_rng(1)
    B, T, H, P, N = 1, 24, 2, 4, 3
    args = [rng.normal(size=(B, T, H, P)), np.abs(rng.normal(size=(
        B, T, H))) * 2.0, -np.abs(rng.normal(size=(H,))) * 4.0,
        rng.normal(size=(B, T, N)), rng.normal(size=(B, T, N))]
    args = [a.astype(np.float32) for a in args]
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    y, S = ssm._ssd_chunked(*ta, chunk=8)
    grads = torch.autograd.grad((y.sum() + S.sum()), ta)
    rgrads = jax.grad(lambda *a: sum(
        t.sum() for t in rssm._ssd_chunked(*a, chunk=8)),
        argnums=tuple(range(5)))(*map(jnp.asarray, args))
    for g, r in zip(grads, rgrads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_causal_conv_decode_state_matches_training():
    """The rolling-buffer conv fed one token at a time equals the padded
    conv over the whole sequence, bit for bit (bf16)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 9, 6)).astype(np.float32)) \
        .bfloat16()
    w = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)) \
        .bfloat16()
    full, _ = ssm._causal_conv(x, w)
    state = torch.zeros((2, 3, 6), dtype=torch.bfloat16)
    steps = []
    for t in range(9):
        y, state = ssm._causal_conv(x[:, t:t + 1], w, state)
        steps.append(y)
    assert torch.equal(torch.cat(steps, 1), full)
    rfull, _ = rssm._causal_conv(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(w.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(full.float().numpy(),
                                  np.asarray(rfull, np.float32))
