"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — ViT stub + mistral-nemo
backbone; `input_specs` feeds precomputed patch embeddings."""
from .base import ModelConfig

config = ModelConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, act="swiglu", norm="rmsnorm",
    pos="rope", rope_theta=1e6, n_patches=256,
)
