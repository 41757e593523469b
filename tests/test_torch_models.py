"""The JAX package's ``tests/test_models.py`` on the port, each test under
its own name: every architecture's smoke variant trains two steps and
decodes consistently on the CPU, the TP-adaptation arithmetic and the
shape-applicability table equal the reference's, and the blockwise
attention equals a naive numpy attention.  Tolerances are the reference
test's own, stated at each assert."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as rconfigs  # noqa: E402
import repro_torch.configs as pconfigs  # noqa: E402
from lm_parity import smoke_batch, to_torch  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, SHAPES, get_config,  # noqa: E402
                                 shape_applicable, smoke_variant)
from repro_torch.models import api  # noqa: E402
from repro_torch.models.layers import flash_attention  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


def test_config_lists_equal_reference():
    assert ALL_ARCHS == rconfigs.ALL_ARCHS
    assert list(SHAPES) == list(rconfigs.SHAPES)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_smoke_forward_and_train(arch):
    """Two train steps of the smoke variant on the reference's smoke
    batch: finite loss and gradient norm, an initial cross-entropy
    between 0.5 and 3 times log(V), and a second loss that differs."""
    cfg = smoke_variant(get_config(arch))
    state = tstep.init_state(cfg, 0, "cpu")
    batch = to_torch(smoke_batch(cfg))
    ts = tstep.make_train_step(cfg, optim.AdamWConfig(total_steps=4))
    state, m = ts(state, batch)
    assert np.isfinite(float(m["loss"])), arch
    assert np.isfinite(float(m["grad_norm"])), arch
    # loss near log(V) at init: logits are sane, not exploded
    assert 0.5 * np.log(cfg.vocab_size) < float(m["xent"]) < \
        3 * np.log(cfg.vocab_size)
    # the second step changes the loss (the optimizer updates)
    state, m2 = ts(state, batch)
    assert float(m2["loss"]) != float(m["loss"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_decode_consistency(arch):
    """prefill(T) + decode(1) equals prefill(T + 1)'s last logits within
    the reference's bound, ``0.1 * max|ref| + 0.06``."""
    cfg = smoke_variant(get_config(arch))
    model = api.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    B, T = 2, 17
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T + 1)))
    extra, Np = {}, 0
    if cfg.family == "vlm":
        Np = cfg.num_prefix_embeds
        extra["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(B, Np, cfg.d_model))).to(torch.bfloat16)
    elif cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(
            rng.normal(size=(B, 8, cfg.d_model))).to(torch.bfloat16)
    ML = T + 1 + Np + 4
    ref, _ = api.prefill_fn(model, {**extra, "tokens": toks}, cfg,
                            max_len=ML)
    _, cache = api.prefill_fn(model, {**extra, "tokens": toks[:, :T]}, cfg,
                              max_len=ML)
    dec, _ = api.decode_fn(model, cache, toks[:, T:T + 1], cfg)
    err = float((dec.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max()) + 1e-6
    assert err < 0.1 * scale + 0.06, (arch, err, scale)


def _effective_dims(C):
    """The reference test's asserts on one package's configs; returns
    the numbers they read."""
    yi = C.get_config("yi-34b")
    assert yi.eff_num_kv_heads == 16 and yi.eff_num_heads == 64
    q3 = C.get_config("qwen3-4b")
    assert q3.eff_num_kv_heads == 16 and q3.eff_num_heads == 32
    moe = C.get_config("qwen2-moe-a2.7b")
    assert moe.eff_num_experts == 64
    sm = C.get_config("seamless-m4t-medium")
    assert sm.vocab_padded % 16 == 0 and sm.vocab_padded >= sm.vocab_size
    smol = C.get_config("smollm-135m")
    assert smol.eff_num_heads == 9  # unsharded attention: no padding
    return {a: (C.get_config(a).eff_num_heads, C.get_config(a).eff_num_kv_heads,
                C.get_config(a).eff_num_experts, C.get_config(a).vocab_padded)
            for a in C.ALL_ARCHS}


def test_effective_dims():
    """TP-adaptation arithmetic: the reference's asserts on both
    packages, and every arch's effective dims equal (exact)."""
    assert _effective_dims(pconfigs) == _effective_dims(rconfigs)


def test_flash_attention_matches_naive():
    """The blockwise attention at ``chunk=7`` (33 positions: a partial
    last chunk), causal, GQA with 4 query heads on 2 KV heads, against a
    naive numpy attention, ``rtol=atol=2e-3`` (the reference's)."""
    rng = np.random.default_rng(0)
    B, T, H, K, Dh = 2, 33, 4, 2, 8
    q = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, K, Dh)).astype(np.float32)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, chunk=7).numpy()
    G = H // K
    kk = np.repeat(k, G, axis=2)
    vv = np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(Dh)
    mask = np.tril(np.ones((T, T), dtype=bool))
    s = np.where(mask[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    exp = np.einsum("bhqk,bkhd->bqhd", p, vv)
    np.testing.assert_allclose(out, exp, rtol=2e-3, atol=2e-3)
    # GQA grouping: head h reads KV head h // G, so the two groups differ
    assert not np.allclose(exp[:, :, 0], exp[:, :, -1])


def _skipped(C):
    return [(a, s.name) for a in C.ALL_ARCHS for s in C.SHAPES.values()
            if not C.shape_applicable(C.get_config(a), s)[0]]


def test_shape_applicability_table():
    """Exactly the 8 full-attention ``long_500k`` cells are skipped, the
    SSM and hybrid run it, and the table (with each reason) equals the
    reference's."""
    skipped = _skipped(pconfigs)
    assert len(skipped) == 8  # exactly the 8 full-attention long_500k cells
    assert all(s == "long_500k" for _, s in skipped)
    assert ("mamba2-2.7b", "long_500k") not in skipped
    assert ("zamba2-7b", "long_500k") not in skipped
    assert skipped == _skipped(rconfigs)
    assert [shape_applicable(get_config(a), s) for a in ALL_ARCHS
            for s in SHAPES.values()] == [
        rconfigs.shape_applicable(rconfigs.get_config(a), s)
        for a in rconfigs.ALL_ARCHS for s in rconfigs.SHAPES.values()]
