"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + ONE shared attention
block applied every 6th position (weight-tied): 13×(5 mamba + shared) + 3."""
from .base import ModelConfig

config = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, act="swiglu", norm="rmsnorm", pos="rope",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_period=5,
)
