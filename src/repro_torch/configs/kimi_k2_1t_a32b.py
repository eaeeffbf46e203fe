"""Kimi-K2 1T-A32B [arXiv:2501.kimi2; paper-table] — 384 experts top-8,
1 shared expert, first layer dense."""
from .base import ModelConfig

config = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112, act="swiglu", norm="rmsnorm", pos="rope",
    n_experts=384, top_k=8, n_shared_experts=1, first_dense=1,
)
