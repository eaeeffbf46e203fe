"""Analytic per-step FLOPs / HBM-traffic model — counterpart of
`repro.launch.flops_model`: the same formulas on the port's configs,
so the port gives the reference's numbers.

The reference uses it because XLA's ``cost_analysis()`` counts a scanned
layer body once.  The port counts what a step runs with
``torch.utils.flop_counter.FlopCounterMode`` and holds that count
against `step_flops` (0.85–1.15, the reference's bar): on the CPU for a
reduced Qwen2 step, on the card for Qwen2-1.5B's full-width step.

Formulas are exact for the implemented layers (same products, no causal
discount because the implementation computes full scores).
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig, ShapeCell


def _attn_layer_fwd(cfg, t: int, s_kv: int) -> float:
    # padded heads are computed by the HLO (then masked), so count them
    d, h, kv, hd = cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads, cfg.hd
    proj = 2 * t * d * (h * hd) * 2 + 2 * t * d * (kv * hd) * 2
    core = 2 * t * s_kv * (h * hd) * 2          # qk^T and p·v
    return proj + core


def _mlp_fwd(cfg, t: int) -> float:
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2 * t * cfg.d_model * cfg.d_ff * mats


def _moe_fwd(cfg, t: int) -> float:
    router = 2 * t * cfg.d_model * cfg.n_experts
    slots = t * cfg.top_k * cfg.capacity_factor
    expert = 2 * slots * cfg.d_model * cfg.d_ff * 3
    shared = 0.0
    if cfg.n_shared_experts:
        shared = 2 * t * cfg.d_model * (cfg.d_ff * cfg.n_shared_experts) * 3
    return router + expert + shared


def _mamba_fwd(cfg, t: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = di // cfg.ssm_head_dim
    g, n, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    l = cfg.ssm_chunk
    proj = 2 * t * d * (2 * di + 2 * g * n + h)
    conv = 2 * t * (di + 2 * g * n) * cfg.ssm_conv
    ssd = (2 * t * l * h * n          # intra-chunk scores
           + 2 * t * l * h * p        # intra-chunk output
           + 2 * t * h * n * p * 2)   # chunk states + off-diag output
    out = 2 * t * di * d
    return proj + conv + ssd + out


def _layer_fwd(cfg, kind: str, t: int, s_kv: int) -> float:
    if kind == "mamba":
        return _mamba_fwd(cfg, t)
    f = _attn_layer_fwd(cfg, t, s_kv)
    f += _moe_fwd(cfg, t) if kind == "moe" else _mlp_fwd(cfg, t)
    return f


def _layer_counts(cfg) -> Dict[str, int]:
    if cfg.family == "hybrid":
        period = cfg.attn_period
        n_p = cfg.n_layers // (period + 1)
        tail = cfg.n_layers - n_p * (period + 1)
        return {"mamba": n_p * period + tail, "dense": n_p}
    if cfg.family == "ssm":
        return {"mamba": cfg.n_layers}
    if cfg.is_moe:
        return {"dense": cfg.first_dense,
                "moe": cfg.n_layers - cfg.first_dense}
    return {"dense": cfg.n_layers}


def step_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Total (global) FLOPs of the lowered step program."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        return _encdec_flops(cfg, cell)
    if cell.kind == "train":
        # fwd + bwd(2×) + full remat(+1×) when enabled
        t, s_kv, mult = b * s, s, 4.0 if cfg.remat else 3.0
    elif cell.kind == "prefill":
        t, s_kv, mult = b * s, s, 1.0
    else:  # decode: 1 token against a seq_len cache
        t, s_kv, mult = b, s, 1.0

    total = 0.0
    for kind, n in _layer_counts(cfg).items():
        if n:
            total += n * _layer_fwd(cfg, kind, t, s_kv) * mult

    # logits: train = every position (fwd+bwd = 3×, not rematted);
    # prefill/decode = one position per sequence.
    t_logits = t if cell.kind == "train" else b
    logit_mult = 3.0 if cell.kind == "train" else 1.0
    total += 2 * t_logits * cfg.d_model * cfg.vocab * logit_mult
    return total


def _encdec_flops(cfg, cell) -> float:
    b, s = cell.global_batch, cell.seq_len
    t_enc = b * cfg.n_frames
    enc = cfg.n_enc_layers * (_attn_layer_fwd(cfg, t_enc, cfg.n_frames)
                              + _mlp_fwd(cfg, t_enc))
    if cell.kind == "train":
        t_dec, mult = b * s, 4.0 if cfg.remat else 3.0
        self_kv, cross_t = s, t_enc
    elif cell.kind == "prefill":
        t_dec, mult = b * s, 1.0
        self_kv, cross_t = s, t_enc
    else:
        t_dec, mult = b, 1.0
        self_kv, cross_t = s, 0    # cross K/V cached at prefill
        enc = 0.0                  # encoder not re-run per decode step
    d, h, hd, kv = cfg.d_model, cfg.n_heads_padded, cfg.hd, cfg.n_kv_heads
    self_attn = _attn_layer_fwd(cfg, t_dec, self_kv)
    cross_proj = 2 * t_dec * d * (h * hd) * 2 \
        + (2 * cross_t * d * (kv * hd) * 2 if cross_t else 0)
    cross_core = 2 * t_dec * cfg.n_frames * (h * hd) * 2
    dec = cfg.n_layers * (self_attn + cross_proj + cross_core
                          + _mlp_fwd(cfg, t_dec))
    t_logits = t_dec if cell.kind == "train" else b
    logit_mult = 3.0 if cell.kind == "train" else 1.0
    logits = 2 * t_logits * d * cfg.vocab * logit_mult
    return (enc + dec) * mult + logits


# ------------------------------------------------------------- bytes -----

def param_bytes(cfg) -> float:
    from ..models.params import n_params
    from .specs import model_decl
    return n_params(model_decl(cfg)) * 2.0          # bf16


def step_hbm_bytes(cfg: ModelConfig, cell: ShapeCell,
                   optimizer: str = "adamw") -> float:
    """Global HBM traffic per step (documented approximation):

    train  : params 3 reads (fwd/bwd/remat) ×2B + grads 8B r/w +
             optimizer state r/w (adamw 16B, adafactor ≈1B) + param write
             2B + layer-boundary activations (write + read) + KV-free.
    prefill: params 1 read + activations write + cache write.
    decode : params 1 read + full KV/SSM cache read + 1-token write.
    """
    b, s = cell.global_batch, cell.seq_len
    pbytes = param_bytes(cfg)
    n = pbytes / 2.0
    d = cfg.d_model
    act_unit = 2.0  # bf16

    if cell.kind == "train":
        opt = 24.0 if optimizer == "adamw" else 1.0
        pt = pbytes * 3 + n * (8 + opt + 2)
        acts = cfg.n_layers * (b * s * d) * act_unit * 2 * 2
        # ×2 (write fwd + read bwd), ×2 intra-layer recompute traffic
        return pt + acts
    if cell.kind == "prefill":
        acts = cfg.n_layers * (b * s * d) * act_unit * 2
        cache = _cache_bytes(cfg, b, s)
        return pbytes + acts + cache
    # decode
    cache = _cache_bytes(cfg, b, s)
    return pbytes + cache + b * d * cfg.n_layers * act_unit * 4


def _cache_bytes(cfg, b: int, s: int) -> float:
    if cfg.family == "ssm":
        di = cfg.ssm_expand * cfg.d_model
        h = di // cfg.ssm_head_dim
        return cfg.n_layers * b * (h * cfg.ssm_state * cfg.ssm_head_dim
                                   * 4 + (di + 2 * cfg.ssm_groups
                                          * cfg.ssm_state) * 3 * 2)
    kv_bytes_per_layer = b * s * cfg.n_kv_heads * cfg.hd * 2 * 2
    if cfg.family == "hybrid":
        period = cfg.attn_period
        n_attn = cfg.n_layers // (period + 1)
        di = cfg.ssm_expand * cfg.d_model
        h = di // cfg.ssm_head_dim
        ssm = (cfg.n_layers - n_attn) * b * h * cfg.ssm_state \
            * cfg.ssm_head_dim * 4
        return n_attn * kv_bytes_per_layer + ssm
    if cfg.family == "encdec":
        cross = cfg.n_layers * b * cfg.n_frames * cfg.n_kv_heads \
            * cfg.hd * 2 * 2
        return cfg.n_layers * kv_bytes_per_layer + cross
    return cfg.n_layers * kv_bytes_per_layer
