"""Model/architecture configuration schema + shape cells.

One ``ModelConfig`` per assigned architecture lives in
``repro_torch/configs/<id>.py`` with the exact published
hyper-parameters; ``reduced()`` derives the CPU smoke-test variant of
the same family.  The port's own copy of `repro.configs.base`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    act: str = "swiglu"                     # swiglu | geglu | gelu
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    qkv_bias: bool = False
    mlp_bias: bool = False
    pos: str = "rope"                       # rope | learned
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False               # ×√d_model on embeddings (gemma)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    first_dense: int = 0                    # leading dense layers (kimi: 1)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attention block every `attn_period` layers
    attn_period: int = 0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500
    # VLM stub
    n_patches: int = 0
    # TP layout: pad Q heads so (kv·rep_pad) divides the model axis; the
    # padded heads are masked dead (zero output+grad) — layout only.
    # Opt-in per production config (starcoder2 36H→48, qwen2 12H→16);
    # default 1 keeps hand-built test/research configs exact.
    head_pad_quantum: int = 1
    # numerics / structure
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024     # KV-chunked attention block (memory ceiling)
    loss_chunk: int = 512      # vocab-CE computed over seq chunks
    max_target_positions: int = 448   # encdec decoder learned-pos table

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        """Q heads padded per KV group so the 4D (B,S,H,hd) head axis
        shards over the model mesh axis (quantum 16): starcoder2 36→48,
        qwen2 12→16; divisible archs unchanged.  Padded head slots are
        masked to zero output/gradient in attention.py — the architecture
        stays config-exact, only the TP layout changes (§Perf iter 1)."""
        q = self.head_pad_quantum
        if q <= 1 or self.n_heads % q == 0 or self.n_heads == 0:
            return self.n_heads
        kv = max(self.n_kv_heads, 1)
        rep = self.n_heads // kv
        while (kv * rep) % q:
            rep += 1
        return kv * rep

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128 so the vocab axis shards
        over the `model` mesh axis (16) and stays MXU-lane aligned.
        mamba2 50280→50304, whisper 51865→51968; others already aligned.
        Padded logit columns are masked to -inf in `logits_fn`."""
        return -(-self.vocab // 128) * 128

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_cell(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip reason."""
    if cell.name == "long_500k" and not cfg.supports_long_context:
        if cfg.family == "encdec":
            return ("encoder-decoder with 30s/448-token design; 524k decode "
                    "outside positional design (DESIGN.md §Arch-applicability)")
        return ("pure full-attention arch: O(S²) attention at 524k skipped "
                "per shape definition (DESIGN.md §Arch-applicability)")
    return None
