"""Whisper-medium [arXiv:2212.04356] — enc-dec; conv frontend is a STUB
(input_specs provides 1500 precomputed frame embeddings)."""
from .base import ModelConfig

config = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, act="gelu", norm="layernorm", pos="learned",
    tie_embeddings=True, n_frames=1500, max_target_positions=448,
)
