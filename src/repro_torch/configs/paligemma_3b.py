"""paligemma-3b — SigLIP + gemma backbone [arXiv:2407.07726; hf].

The SigLIP frontend is a STUB: input_specs provide precomputed patch
embeddings [B, 256, d] (prefix-LM bidirectional prefix).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    tie_embeddings=True,
    num_prefix_embeds=256,
    prefix_lm=True,
))
