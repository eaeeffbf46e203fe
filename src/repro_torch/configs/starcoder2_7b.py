"""StarCoder2-7B [arXiv:2402.19173; hf] — GQA, RoPE, gelu MLP + biases."""
from .base import ModelConfig

config = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, head_dim=128, act="gelu", norm="layernorm",
    qkv_bias=True, mlp_bias=True, pos="rope", rope_theta=1e5,
    head_pad_quantum=16,     # 36 Q heads → 48 for the 16-way model axis
)
