"""FCM-initialized MoE routers — counterpart of
`repro.integration.router_init`.

The router weight `w_router` (D, E) is a linear map whose argmax decides
expert assignment.  Random init routes tokens incoherently; BigFCM gives
E centroids of the token-embedding distribution in O(one pass) over the
corpus, and setting column e of the router to centroid_e (unit-normalized,
scaled) makes `logits[t, e] = <x_t, v_e>` — cosine-style affinity to
cluster e.  Tokens in the same embedding cluster then co-route from step
0: the paper's "good initial centers ⇒ fast convergence" claim
transplanted to router training.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..core.bigfcm import BigFCMConfig, BigFCMResult, bigfcm_fit
from ..device import as_real, resolve_device
from ..mesh import rank_device
from ..sharding.rules import data_axes


def _fit(x, fcm_cfg, mesh, sample_idx, seed_idx, device) -> BigFCMResult:
    """`bigfcm_fit` of ``x`` as f32, on ``device`` or over ``mesh`` (whose
    ranks' devices it runs on)."""
    dev = rank_device(mesh) if mesh is not None else resolve_device(device)
    return bigfcm_fit(as_real(x, dev), fcm_cfg, mesh=mesh,
                      data_axes=data_axes(mesh), sample_idx=sample_idx,
                      seed_idx=seed_idx, device=dev)


def fcm_router_init(
    params,
    cfg,
    token_embeddings,
    *,
    mesh=None,
    fcm_cfg: Optional[BigFCMConfig] = None,
    scale: float = 1.0,
    sample_idx=None,
    seed_idx=None,
    device: Union[str, torch.device] = "cuda",
):
    """Seed every MoE router from BigFCM centroids → (params, result).

    ``params``: the reference's form, a nested dict/list tree whose dicts
    may hold a ``"w_router"`` tensor ((D, E) or stacked (L, D, E)) — a
    new tree is returned, each router replaced by the centroid columns in
    its own dtype, shape and device — or an `nn.Module`, whose
    parameters named ``…w_router`` are set in place.

    token_embeddings: (N, D) sample of embedding vectors (e.g. the embed
    table itself, or hidden states from a short probe run), as f32.
    ``sample_idx`` / ``seed_idx`` inject the fit's draws (`bigfcm_fit`).
    """
    fcm_cfg = fcm_cfg or BigFCMConfig(
        n_clusters=cfg.n_experts, m=2.0, combiner_eps=1e-6,
        reducer_eps=1e-8, max_iter=200)
    if fcm_cfg.n_clusters != cfg.n_experts:
        raise ValueError(f"fcm_router_init: {fcm_cfg.n_clusters} clusters "
                         f"for {cfg.n_experts} experts")
    res = _fit(token_embeddings, fcm_cfg, mesh, sample_idx, seed_idx,
               device)
    # (E, D) centroids, unit-normalized → router columns
    v = res.centers
    v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-8)
    w = scale * v.T  # (D, E)

    def routed(old):
        return w.to(old.device, old.dtype).expand(old.shape).contiguous()

    if isinstance(params, nn.Module):
        with torch.no_grad():
            for name, p in params.named_parameters():
                if name.endswith("w_router"):
                    p.copy_(routed(p))
        return params, res

    def walk(tree):
        if isinstance(tree, dict):
            tree = {k: walk(t) for k, t in tree.items()}
            if "w_router" in tree:
                tree["w_router"] = routed(tree["w_router"])
            return tree
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(t) for t in tree)
        return tree

    return walk(params), res
