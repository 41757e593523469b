"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596; hf].

Speech frontend is a STUB (precomputed frame embeddings).  12 encoder +
12 decoder layers; vocab 256206 is not 16-divisible — GSPMD pads.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,          # decoder layers
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
))
