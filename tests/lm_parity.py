"""Shared by the LM family parity tests: the six non-dense family
configs, a port model loaded with the reference's seed-0 parameters, and
the reference's smoke batches as numpy, cast for either package."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as rget_config
from repro.configs import smoke_variant as rsmoke
from repro.models import api as rapi
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import api

KEY = jax.random.PRNGKey(0)
FAMILIES = ["qwen2-moe-a2.7b", "olmoe-1b-7b", "paligemma-3b", "mamba2-2.7b",
            "zamba2-7b", "seamless-m4t-medium"]


def pair(arch):
    """(port cfg, ref cfg, reference params, port model on the CPU with
    the same weights)."""
    cfg, rcfg = smoke_variant(get_config(arch)), rsmoke(rget_config(arch))
    rparams = rapi.init_params(rcfg, KEY)
    model = api.init_params(cfg, seed=1, device="cpu")
    model.load_state_dict(convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams)))
    return cfg, rcfg, rparams, model


def smoke_batch(cfg, B=2, T=32, seed=0):
    """The reference's ``_smoke_batch`` (``tests/test_models.py``) as
    numpy: float arrays f32 (each side casts them to bf16)."""
    rng = np.random.default_rng(seed)

    def ints(*shape):
        return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)

    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(B, T, cfg.d_model)).astype(
            np.float32), "tokens": ints(B, T), "labels": ints(B, T)}
    if cfg.family == "vlm":
        Np = cfg.num_prefix_embeds
        return {"patch_embeds": rng.normal(size=(B, Np, cfg.d_model)).astype(
            np.float32), "tokens": ints(B, T - Np), "labels": ints(B, T),
            "mask": np.concatenate([np.zeros((B, Np)), np.ones(
                (B, T - Np))], 1).astype(np.int32)}
    return {"tokens": ints(B, T), "labels": ints(B, T)}


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                           else jnp.int32) for k, v in batch.items()}


def to_torch(batch):
    return {k: (torch.from_numpy(v).to(torch.bfloat16)
                if v.dtype == np.float32 else torch.from_numpy(v).long())
            for k, v in batch.items()}
