"""Qwen2-1.5B [arXiv:2407.10671; hf] — GQA kv=2, QKV bias, tied embeds."""
from .base import ModelConfig

config = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, act="swiglu", norm="rmsnorm", qkv_bias=True,
    tie_embeddings=True, pos="rope", rope_theta=1e6,
    head_pad_quantum=16,     # 12 Q heads → 16 for the 16-way model axis
)
