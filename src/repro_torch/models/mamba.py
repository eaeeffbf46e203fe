"""Mamba2 (SSD) parameters — counterpart of `repro.models.mamba`'s
declaration (`mamba_dims`, `mamba_decl`).  The block, its chunked scan
and its cache are ROADMAP Queue 1 item 3b."""
from __future__ import annotations

from .params import PDecl


def mamba_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    nheads = di // cfg.ssm_head_dim
    return di, nheads, cfg.ssm_groups, cfg.ssm_state


def mamba_decl(cfg):
    d = cfg.d_model
    di, h, g, n = mamba_dims(cfg)
    conv_ch = di + 2 * g * n
    return {
        "wz": PDecl((d, di), ("embed", "mlp")),
        "wx": PDecl((d, di), ("embed", "mlp")),
        "wB": PDecl((d, g * n), ("embed", None)),
        "wC": PDecl((d, g * n), ("embed", None)),
        "wdt": PDecl((d, h), ("embed", "heads")),
        "conv_w": PDecl((cfg.ssm_conv, conv_ch), ("conv", "mlp")),
        "conv_b": PDecl((conv_ch,), ("mlp",), "zeros"),
        "A_log": PDecl((h,), ("heads",), "zeros"),
        "D_skip": PDecl((h,), ("heads",), "ones"),
        "dt_bias": PDecl((h,), ("heads",), "zeros"),
        "norm_scale": PDecl((di,), ("mlp",), "ones"),
        "w_out": PDecl((di, d), ("mlp", "embed")),
    }
