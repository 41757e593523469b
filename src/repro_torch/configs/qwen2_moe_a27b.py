"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  60 experts on a 16-way EP axis rely on
GSPMD padding (to 64) — the slack is visible in the roofline ratio.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,           # kept for bookkeeping; experts use expert_d_ff
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    expert_d_ff=1408,
))
