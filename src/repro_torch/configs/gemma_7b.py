"""Gemma-7B [arXiv:2403.08295; hf] — GeGLU, head_dim=256, tied embeds."""
from .base import ModelConfig

config = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, d_ff=24576,
    vocab=256000, head_dim=256, act="geglu", norm="rmsnorm",
    tie_embeddings=True, embed_scale=True, pos="rope",
)
