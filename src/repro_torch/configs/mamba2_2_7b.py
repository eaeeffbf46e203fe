"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD."""
from .base import ModelConfig

config = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, act="swiglu", norm="rmsnorm", pos="rope",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
