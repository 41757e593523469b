"""mamba2-2.7b — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].  Runs long_500k (O(1) decode state).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
))
