"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].  81 mamba layers; the single shared
attention+MLP block is applied after every 6th layer (13 applications,
weights shared — the zamba trick).  Runs long_500k.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_period=6,
))
