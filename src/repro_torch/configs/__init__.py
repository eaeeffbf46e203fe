"""Architecture registry: ``get_config(arch_id)`` + reduced smoke variants.

The port's own copy of `repro.configs` (dataclasses only): the same ten
published configurations and the same ``reduced`` CPU variants."""
from __future__ import annotations

import dataclasses
import importlib

from .base import (ModelConfig, SHAPES, ShapeCell, cell_applicable,
                   shape_cell)

ARCHS = {
    "starcoder2-7b": "starcoder2_7b",
    "stablelm-12b": "stablelm_12b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma-7b": "gemma_7b",
    "pixtral-12b": "pixtral_12b",
    "whisper-medium": "whisper_medium",
    "zamba2-7b": "zamba2_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-2.7b": "mamba2_2_7b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.config


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family CPU smoke config: small widths, few layers/experts."""
    kw = dict(
        n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)
                       if cfg.n_kv_heads < cfg.n_heads else 4),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512, head_dim=16, compute_dtype="float32",
        param_dtype="float32", attn_chunk=0, loss_chunk=8,
        head_pad_quantum=1,
    )
    if cfg.is_moe:
        kw.update(n_experts=8, top_k=2,
                  first_dense=min(cfg.first_dense, 1),
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=4)
    if cfg.family == "hybrid":
        kw.update(n_layers=7, attn_period=2)     # 2 periods of (2+1) + 1
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_layers=2, n_frames=16,
                  max_target_positions=64)
    if cfg.n_patches:
        kw.update(n_patches=4)
    return dataclasses.replace(cfg, **kw)
