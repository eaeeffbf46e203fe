"""Mixture-of-Experts parameters — counterpart of `repro.models.moe`'s
declaration (`moe_decl`).  The MoE layer itself (dispatch, expert FFNs)
is ROADMAP Queue 1 item 3b; `repro_torch.integration.fcm_router_init`
already seeds the ``w_router`` this declares."""
from __future__ import annotations

from .params import PDecl


def moe_decl(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    decl = {
        "w_router": PDecl((d, e), ("embed", None)),
        "w_in": PDecl((e, d, 2 * f),
                      ("experts", "expert_embed", "expert_mlp")),
        "w_out": PDecl((e, f, d),
                       ("experts", "expert_mlp", "expert_embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        decl["w_shared_in"] = PDecl((d, 2 * fs), ("embed", "mlp"))
        decl["w_shared_out"] = PDecl((fs, d), ("mlp", "embed"))
    return decl
