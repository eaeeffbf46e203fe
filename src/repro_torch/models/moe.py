"""Mixture-of-Experts layer on one device — counterpart of
`repro.models.moe` (`moe_decl`, `_expert_ffn`, `_moe_local` at one rank,
`moe`'s no-mesh branch with shared experts, `router_load`).

Dispatch is sort-based with a capacity bound, as the reference's:
gathers and scatters, not one-hot products.  The (token, expert) pairs
are sorted stably by expert, a pair's rank inside its expert decides
whether it is dropped at ``cap = max(8, int(T·k·cf) // E)``, and the
kept tokens run through the experts as one batched product over an
(E, rows, D) buffer.  Where the reference's ``mode="drop"`` /
``mode="fill"`` scatter and gather go out of range, the port writes and
reads one trash row past the buffer.  Three places keep the reference's
choices and roundings where torch would not by itself:

* top-k (`top_k`) keeps the lower expert on ties, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` promises no order);
* the softmax (`softmax`) is ``jax.nn.softmax``'s formula op by op, its
  sum in f32, in the logits' dtype (f32 in `moe`, the compute dtype in
  `router_load`);
* the combine adds each token's k weighted expert outputs one at a time
  in ascending expert order, rounding after each add: the order of the
  reference's scatter-add over the sorted pairs (``index_add_`` on the
  card adds with atomics in no fixed order).

The buffer holds as many rows an expert as the fullest expert fills (at
most ``cap``): the rows past them are zeros that no pair reads, so the
result is the reference's; finding that count costs one host sync,
taken only where ``cap`` exceeds its floor of 8 (prefill, not decode).
Expert parallelism over a mesh (`_moe_a2a`, the ``tp`` / ``fsdp``
branches) comes with the sharded LM, ROADMAP Queue 1 item 3d.

BigFCM tie-in: `repro_torch.integration.fcm_router_init` seeds
``w_router`` with FCM centroids of token embeddings.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .layers import silu
from .params import ParamTree, PDecl

CAP_FLOOR = 8       # the reference's minimum capacity an expert
# Hidden activations of one group of experts, in elements (1 GB in f32):
# at cf = E/k in f32 an expert's rows can reach every token.
FFN_GROUP_ELEMS = 1 << 28


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


def softmax(x):
    """``jax.nn.softmax`` over the last axis in x's dtype: exp(x − max)
    over its sum, the sum taken in f32 and rounded to x's dtype (jnp's
    reductions upcast bf16)."""
    # the shift carries no gradient (jax.nn.softmax's custom JVP)
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.float().sum(-1, keepdim=True).to(e.dtype)


def top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first, ties to the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, w_router, xt):
    """Router of tokens xt (T, D) → (gate (T, k) f32 renormalized over
    the top k, expert ids (T, k) int64)."""
    logits = xt @ w_router.to(xt.dtype)
    gate, eidx = top_k(softmax(logits.float()), cfg.top_k)
    return gate / gate.sum(-1, keepdim=True), eidx


def capacity(cfg, t: int) -> int:
    """Tokens an expert takes at most, for t tokens."""
    return max(CAP_FLOOR, int(t * cfg.top_k * cfg.capacity_factor)
               // cfg.n_experts)


class Dispatch(NamedTuple):
    """The sorted pairs: ``order`` (T·k,) sorts the flat (token, k)
    pairs stably by expert; ``sorted_e`` their experts, ``pos`` each
    one's rank inside its expert, ``valid`` = pos < cap; ``counts`` (E,)
    pairs routed to each expert, dropped ones included."""
    order: torch.Tensor
    sorted_e: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    counts: torch.Tensor
    cap: int


def _counts(ids, n: int):
    """(n,) occurrences of each id — ``torch.bincount`` without its host
    sync on the card (it reads the largest id to size its output)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def dispatch(cfg, eidx) -> Dispatch:
    t, k = eidx.shape
    e = cfg.n_experts
    cap = capacity(cfg, t)
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=eidx.device) - starts[sorted_e]
    return Dispatch(order, sorted_e, pos, pos < cap, counts, cap)


def _expert_ffn(w_in, w_out, x, out=None):
    """x: (E, rows, D) → (E, rows, D); SwiGLU experts, run in groups of
    experts whose (G, rows, 2F) hidden activations stay within
    FFN_GROUP_ELEMS elements (each expert's products are the same
    whatever the grouping).  Serving passes ``out`` and the groups'
    products are written into it; without it (training: autograd takes
    no ``out=``) they are new tensors, concatenated."""
    e, rows, _ = x.shape
    group = max(1, FFN_GROUP_ELEMS // max(1, rows * w_in.shape[-1]))
    parts = []
    for i in range(0, e, group):
        h = torch.bmm(x[i:i + group], w_in[i:i + group].to(x.dtype))
        u, g = torch.chunk(h, 2, dim=-1)
        w = w_out[i:i + group].to(x.dtype)
        if out is None:
            parts.append(torch.bmm(u * silu(g), w))
        else:
            torch.bmm(u * silu(g), w, out=out[i:i + group])
    return torch.cat(parts) if out is None else out


def _moe_local(x, w_router, w_in, w_out, *, cfg):
    """The reference's per-rank body at one rank: x (B, S, D) → (B, S, D)."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    gate, eidx = route(cfg, w_router, xt)
    dp = dispatch(cfg, eidx)
    # rows an expert in the buffer: the fullest expert's (≤ cap)
    rows = dp.cap
    if dp.cap > CAP_FLOOR:
        rows = min(dp.cap, int(dp.counts.max()))
    slot = torch.where(dp.valid, dp.sorted_e * rows + dp.pos, e * rows)
    tok = dp.order // k                              # token of each pair
    buf = torch.zeros((e * rows + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xt[tok]                              # row e·rows: trash
    if torch.is_grad_enabled():
        # new tensors for autograd; the trash row stays out of the
        # graph (its gradient is zero), and y's is the dropped pairs' 0
        y = torch.cat([_expert_ffn(w_in, w_out, buf[:-1].view(e, rows, d))
                       .reshape(e * rows, d), buf.new_zeros((1, d))])
    else:
        y = torch.zeros_like(buf)       # its last row: the dropped pairs' 0
        _expert_ffn(w_in, w_out, buf[:-1].view(e, rows, d),
                    out=y[:-1].view(e, rows, d))
    del buf
    w = torch.where(dp.valid, gate.reshape(-1)[dp.order], 0.0).to(x.dtype)
    contrib = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    contrib[dp.order] = y[slot] * w[:, None]         # back to (token, k)
    contrib = contrib.reshape(t, k, d)
    # each token's k outputs in ascending expert order (the scatter's)
    rank = torch.argsort(eidx, dim=-1)
    contrib = torch.gather(contrib, 1, rank[..., None].expand(t, k, d))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.reshape(b, s, d)


def moe(cfg, p, x):
    """MoE FFN on one device: routed experts plus the shared ones."""
    y = _moe_local(x, p["w_router"], p["w_in"], p["w_out"], cfg=cfg)
    if cfg.n_shared_experts:
        h = x @ p["w_shared_in"].to(x.dtype)
        u, g = torch.chunk(h, 2, dim=-1)
        y = y + (u * silu(g)) @ p["w_shared_out"].to(x.dtype)
    return y


def router_load(cfg, p, x):
    """Expert load histogram (E,) of x (B, S, D): the top-k of a softmax
    taken in the logits' own dtype, as the reference's."""
    logits = x @ p["w_router"].to(x.dtype)
    _, eidx = top_k(softmax(logits), cfg.top_k)
    return _counts(eidx.reshape(-1), cfg.n_experts)


def dropped_pairs(cfg, p, x) -> int:
    """(token, expert) pairs of x (B, S, D) past their expert's capacity:
    the pairs `moe` drops."""
    _, eidx = route(cfg, p["w_router"], x.reshape(-1, x.shape[-1]))
    return int((~dispatch(cfg, eidx).valid).sum())


class MoE(ParamTree):
    """The MoE layer's parameters (`moe_decl`) over `moe`."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__(moe_decl(cfg), dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x):
        return moe(self.cfg, self, x)
