"""smollm-135m — small llama-arch [hf:HuggingFaceTB/SmolLM-135M; hf].

9 heads / 3 KV heads don't divide a 16-way model axis: attention stays
replicated (shard_attn_heads=False) and TP applies to FFN (1536/16) and
vocab, with sequence-parallel activations (DESIGN.md §6).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    shard_attn_heads=False,
))
