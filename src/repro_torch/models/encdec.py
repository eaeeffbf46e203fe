"""Encoder–decoder parameters (whisper-medium family) — counterpart of
`repro.models.encdec`'s declaration (`decl`).  The encoder, the decoder
with cross-attention and their caches are ROADMAP Queue 1 item 3b."""
from __future__ import annotations

from .attention import attention_decl
from .layers import embed_decl, mlp_decl, norm_decl
from .params import PDecl, stack_layers


def _enc_block_decl(cfg):
    return {"ln1": norm_decl(cfg), "attn": attention_decl(cfg),
            "ln2": norm_decl(cfg), "mlp": mlp_decl(cfg)}


def _dec_block_decl(cfg):
    return {"ln1": norm_decl(cfg), "self_attn": attention_decl(cfg),
            "ln2": norm_decl(cfg), "cross_attn": attention_decl(cfg),
            "ln3": norm_decl(cfg), "mlp": mlp_decl(cfg)}


def decl(cfg):
    return {
        "embed": embed_decl(cfg),
        "dec_pos": {"table": PDecl((cfg.max_target_positions, cfg.d_model),
                                   (None, "embed"), "embed",
                                   scale=cfg.d_model ** -0.5)},
        "enc_pos": {"table": PDecl((cfg.n_frames, cfg.d_model),
                                   (None, "embed"), "embed",
                                   scale=cfg.d_model ** -0.5)},
        "enc_blocks": stack_layers(lambda: _enc_block_decl(cfg),
                                   cfg.n_enc_layers),
        "dec_blocks": stack_layers(lambda: _dec_block_decl(cfg),
                                   cfg.n_layers),
        "enc_norm": norm_decl(cfg),
        "final_norm": norm_decl(cfg),
    }
