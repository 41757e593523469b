"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    num_shared_experts=0,
    top_k=8,
    expert_d_ff=1024,
    qk_norm=True,
))
