"""Shared building blocks: norms, activations, RoPE, MLP, embeddings —
counterpart of `repro.models.layers`.

Plain functions of a parameter mapping ``p`` (a dict or a `ParamTree`),
each with its declaration, and small modules over them.  Under a mesh of
more than one rank (`sharding.spmd`) ``p`` holds this rank's blocks: the
MLP gathers their storage dims and runs column-parallel into row-parallel
where its hidden dim is split over "model" (a gated ``w_in``'s block is
its paired [u_r | g_r]); the embedding is vocab-parallel
(`vocab_embed`).  `sharding.constrain` checks the layouts where the
reference constrains them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import mesh as M
from ..sharding import spmd
from ..sharding.rules import constrain
from .params import ParamTree, PDecl


# ------------------------------------------------------------- norms -----

def rmsnorm_decl(d: int):
    return {"scale": PDecl((d,), (None,), "ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_decl(d: int):
    return {"scale": PDecl((d,), (None,), "ones"),
            "bias": PDecl((d,), (None,), "zeros")}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)  # population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


def norm_decl(cfg, d: Optional[int] = None):
    d = d or cfg.d_model
    return layernorm_decl(d) if cfg.norm == "layernorm" else rmsnorm_decl(d)


def norm(cfg, p, x):
    return layernorm(p, x) if cfg.norm == "layernorm" else rmsnorm(p, x)


# ------------------------------------------------------------- RoPE ------

def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs               # (.., S, hd/2)
    if angles.dim() == 2:                                       # (S, hd/2)
        angles = angles[None]
    angles = angles[:, :, None, :]                              # (B, S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- MLP -------

def mlp_decl(cfg):
    d, f = cfg.d_model, cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    decl = {
        "w_in": PDecl((d, (2 if gated else 1) * f), ("embed", "mlp"),
                      gated=gated),
        "w_out": PDecl((f, d), ("mlp", "embed")),
    }
    if cfg.mlp_bias:
        decl["b_in"] = PDecl(((2 if gated else 1) * f,), ("mlp",), "zeros",
                             gated=gated)
        decl["b_out"] = PDecl((d,), (None,), "zeros")
    return decl


def rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, on the host.  The reference's Python
    constants are weakly typed: they take the array's dtype before an
    operation.  A product of two bf16 values is exact in f32, so
    ``x * rounded(v, x.dtype)`` rounds once, as the reference does."""
    return float(torch.tensor(v, dtype=dtype))


# The activations follow `jax.nn`'s formulas op by op in the input's
# dtype, each op rounded to it, its constants rounded first; in bf16 a
# fused F.silu / F.gelu rounds once and parts from the reference by an
# ulp.

def silu(x):
    """``x · sigmoid(x)`` (`jax.nn.silu`), the sigmoid as XLA lowers its
    logistic: ``1 / (1 + exp(−x))``."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x):
    """The tanh approximation, ``gelu(x, approximate=True)``: the
    function of ``F.gelu(x, approximate="tanh")`` in `jax.nn.gelu`'s
    operations."""
    c = rounded(math.sqrt(2 / math.pi), x.dtype)
    inner = c * (x + rounded(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp(cfg, p, x):
    mesh = spmd.active_mesh()
    decl = mlp_decl(cfg) if mesh is not None else None
    tp = spmd.model_split(decl["w_in"], 1, mesh) if mesh is not None \
        else False
    if tp:                                  # column-parallel input
        x = M.enter_replicated(x, mesh, "model")
    h = x @ spmd.param(p, "w_in", decl, mesh).to(x.dtype)
    if "b_in" in p:
        h = h + p["b_in"].to(x.dtype)
    if cfg.act in ("swiglu", "geglu"):
        u, g = torch.chunk(h, 2, dim=-1)        # w_in's output is [u | g]
        h = u * (silu(g) if cfg.act == "swiglu" else gelu_tanh(g))
    else:
        h = gelu_tanh(h)
    if mesh is not None:
        h = constrain(h, "batch", "seq", "act_mlp", shape=(
            spmd.global_batch(h.shape[0], mesh), spmd.global_seq(h.shape[1]),
            cfg.d_ff))
    y = h @ spmd.param(p, "w_out", decl, mesh).to(x.dtype)
    if tp:                                  # row-parallel output
        y = M.reduce_replicated(y, mesh, "model")
    if "b_out" in p:
        y = y + p["b_out"].to(x.dtype)
    return y


# --------------------------------------------------------- embeddings ----

def embed_decl(cfg):
    return {"table": PDecl((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                           "embed", scale=cfg.d_model ** -0.5)}


def embed(p, tokens, dtype):
    return p["table"].to(dtype)[tokens]


def vocab_embed(cfg, table, tokens, dtype, mesh):
    """The lookup under a mesh: ``table`` is this rank's block of the
    (V, D) table with D gathered (`spmd.param`).  Split over "model"
    (vocab-parallel), each rank fills the rows of the tokens it owns into
    zeros and the ranks' parts are summed (`mesh.reduce_replicated`: x
    plus zeros is x exactly); whole, a plain lookup."""
    if not spmd.model_split(embed_decl(cfg)["table"], 0, mesh):
        return table.to(dtype)[tokens]
    n = table.shape[0]
    local = tokens - spmd.model_rank(mesh)[0] * n
    mine = (local >= 0) & (local < n)
    rows = table.to(dtype)[torch.where(mine, local, 0)]
    x = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return M.reduce_replicated(x, mesh, "model")


def unembed(p, x):
    """x (B,S,D) → logits (B,S,V) against the (tied or separate) table."""
    return x @ p["table"].to(x.dtype).T


# ------------------------------------------------------------ modules ----

class Norm(ParamTree):
    """The config's norm (`norm_decl`) over a width ``d``."""

    def __init__(self, cfg, d: Optional[int] = None, *, dtype, device):
        super().__init__(norm_decl(cfg, d), dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x):
        return norm(self.cfg, self, x)


class MLP(ParamTree):
    """The feed-forward block (`mlp_decl`)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__(mlp_decl(cfg), dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x):
        return mlp(self.cfg, self, x)


class Embed(ParamTree):
    """The token table (`embed_decl`); ``forward`` looks tokens up."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__(embed_decl(cfg), dtype=dtype, device=device)

    def forward(self, tokens, dtype):
        return embed(self, tokens, dtype)
