"""StableLM-2-12B [hf:stabilityai; family of stablelm-2] — GQA kv=8."""
from .base import ModelConfig

config = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, act="swiglu", norm="layernorm", pos="rope",
)
