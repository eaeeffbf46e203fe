"""Mamba2 (SSD — state-space duality) block, chunked matmul formulation —
counterpart of `repro.models.mamba`.

The chunked algorithm turns the linear recurrence into batched products:
an intra-chunk quadratic term (attention-like, over chunk length L only)
plus an inter-chunk state recurrence over S/L carries of (H, N, P)
states.  The SSD runs in f32 inside a bf16 model, as the reference's.
``ssd_chunked`` takes whole chunks only: past one chunk, S must be a
multiple of L (the reference asserts the same).  Its (B, S/L, H, L, L)
f32 decay and score tensors are the layer's largest; they are freed when
the layer returns.

Under a mesh of more than one rank (`sharding.spmd`) the mixer is
tensor-parallel where "model" splits its inner channels and
heads (`_mamba_spmd`): column-parallel from x to the SSD, row-parallel
out of ``w_out``.  Three parts do not follow the dense pattern.  The
conv's channels are the concatenation [xi | B | C], so a rank's block of
``conv_w`` / ``conv_b`` is a contiguous range of it, not its xi block
plus B and C: the rank gathers the whole (small) conv over "model" and
takes its xi channels' and the B/C channels' taps, the cotangent
reduce-scattered back.  B and C come from ``wB`` / ``wC``, whole on
every "model" rank, but each rank's heads use them: the weights enter
replicated (`mesh.enter_replicated`), their cotangents summed over
"model" once.  The gated RMSNorm spans all inner channels: its sum of
squares is added over "model" in f32, forward and backward.

Serving under a mesh: a rank's caches are rank-local blocks — the conv
state of its rows holds the channels it convolves, [xi_r | B | C], and
the SSM state its heads.  The reference places the conv state's
channels [xi | B | C] over "model" as one contiguous range
(`launch.specs.cache_pspecs`), which is not a rank's channels; the
port's block is larger by the B and C channels every rank keeps, and a
decode step moves nothing for the conv.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import mesh as M
from ..sharding import spmd
from ..sharding.rules import constrain
from .layers import Norm, rmsnorm, silu
from .params import ParamTree, PDecl


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


class MambaCache(NamedTuple):
    """conv (B, conv_width − 1, conv_channels) in the model's dtype and
    ssm (B, H, N, P) f32, or both stacked over a stage's layers."""
    conv: torch.Tensor
    ssm: torch.Tensor


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16,
                     device=None, mesh=None) -> MambaCache:
    """Zero caches of ``batch`` rows; with ``mesh`` (more than one rank)
    this rank's blocks (`local_dims`)."""
    di, h, g, n = mamba_dims(cfg)
    if mesh is not None:
        di, h = local_dims(cfg, mesh)
    conv_ch = di + 2 * g * n
    return MambaCache(
        torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                    device=device),
        torch.zeros((batch, h, n, cfg.ssm_head_dim), dtype=torch.float32,
                    device=device))


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(e^−|x|)
    (no linear cut-off, unlike ``F.softplus``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(x):
    """x: (..., L) → (..., L, L); out[i,j] = Σ_{j<k≤i} x_k, -inf above diag."""
    l = x.shape[-1]
    c = torch.cumsum(x, -1)
    ss = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, -torch.inf)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int,
                init_state=None):
    """SSD over a full sequence.

    x: (B,S,H,P) pre-discretization inputs; dt: (B,S,H) post-softplus;
    b_mat, c_mat: (B,S,H,N) (groups already repeated to heads).
    Returns (y (B,S,H,P) f32, final_state (B,H,N,P) f32).
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    l = min(chunk, s)
    nc = s // l
    if s % l:
        raise ValueError(f"ssd_chunked: {s} positions are not whole "
                         f"chunks of {l}")

    a = -torch.exp(a_log.float()) * dt                   # (B,S,H) dA
    xd = x.float() * dt[..., None]                       # X = x·dt

    def blk(t, shape):
        return t.reshape((bsz, nc, l) + shape)
    a_b = blk(a, (h,))
    x_b = blk(xd, (h, p))
    bb = blk(b_mat.float(), (h, n))
    cb = blk(c_mat.float(), (h, n))

    a_cum = torch.cumsum(a_b, dim=2)                     # (B,C,L,H)
    lmat = torch.exp(_segsum(a_b.permute(0, 1, 3, 2)))   # (B,C,H,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", cb, bb) * lmat
    del lmat
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, x_b)
    del scores

    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B,C,L,H)
    states = torch.einsum("bclhn,bclh,bclhp->bchnp", bb, decay_states, x_b)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])          # (B,C,H)

    carry = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    inits = []
    for c in range(nc):                                  # the state scan
        inits.append(carry)
        carry = chunk_decay[:, c, :, None, None] * carry + states[:, c]
    inits = torch.stack(inits, 1)                        # (B,C,H,N,P)

    y_off = torch.einsum("bclhn,bchnp->bclhp", cb, inits) \
        * torch.exp(a_cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y, carry


def ssd_decode_step(state, x, dt, a_log, b_mat, c_mat, d_skip):
    """One-token SSD update.  x: (B,H,P); b/c: (B,H,N); state: (B,H,N,P)."""
    a = -torch.exp(a_log.float()) * dt                   # (B,H)
    xd = x.float() * dt[..., None]
    new = torch.exp(a)[:, :, None, None] * state + \
        torch.einsum("bhn,bhp->bhnp", b_mat.float(), xd)
    y = torch.einsum("bhn,bhnp->bhp", c_mat.float(), new)
    y = y + d_skip.float()[None, :, None] * x.float()
    return y, new


def _conv_causal(p, xbc, conv_state=None):
    """Depthwise causal conv, width cfg.ssm_conv.  xbc: (B,S,CH).  The
    taps are summed from the first, in xbc's dtype (the reference's
    Python ``sum``)."""
    w = p["conv_w"].to(xbc.dtype)                        # (W, CH)
    width, s = w.shape[0], xbc.shape[1]
    if conv_state is not None:
        ctx = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        ctx = torch.nn.functional.pad(xbc, (0, 0, width - 1, 0))
    out = ctx[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + ctx[:, i:i + s] * w[i]
    out = out + p["conv_b"].to(xbc.dtype)
    new_state = ctx[:, -(width - 1):] if width > 1 else None
    return silu(out), new_state


def mamba_block(cfg, p, x, *, cache: Optional[MambaCache] = None):
    """Full Mamba2 mixer.  x: (B,S,D) → (y, new_cache)."""
    mesh = spmd.active_mesh()
    if mesh is not None:
        return _mamba_spmd(cfg, p, x, mesh, cache)
    bsz, s, d = x.shape
    di, h, g, n = mamba_dims(cfg)
    rep = h // g
    dt_raw = x @ p["wdt"].to(x.dtype)
    z = x @ p["wz"].to(x.dtype)
    xi = x @ p["wx"].to(x.dtype)
    bproj = x @ p["wB"].to(x.dtype)
    cproj = x @ p["wC"].to(x.dtype)

    xbc = torch.cat([xi, bproj, cproj], dim=-1)
    conv_in = cache.conv if cache is not None else None
    xbc, new_conv = _conv_causal(p, xbc, conv_in)
    xi, bproj, cproj = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    xh = xi.reshape(bsz, s, h, cfg.ssm_head_dim)
    bm = torch.repeat_interleave(bproj.reshape(bsz, s, g, n), rep, dim=2)
    cm = torch.repeat_interleave(cproj.reshape(bsz, s, g, n), rep, dim=2)

    if cache is not None and s == 1:
        y, new_ssm = ssd_decode_step(
            cache.ssm, xh[:, 0], dt[:, 0], p["A_log"], bm[:, 0], cm[:, 0],
            p["D_skip"])
        y = y[:, None]
    else:
        init = cache.ssm if cache is not None else None
        y, new_ssm = ssd_chunked(xh, dt, p["A_log"], bm, cm, p["D_skip"],
                                 chunk=cfg.ssm_chunk, init_state=init)

    y = y.reshape(bsz, s, di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rmsnorm({"scale": p["norm_scale"]}, y * silu(z))
    out = y @ p["w_out"].to(x.dtype)
    new_cache = (MambaCache(new_conv, new_ssm)
                 if cache is not None else None)
    return out, new_cache


# (leaf, dim) of the mixer's inner channels and heads: split over
# "model" together or not at all
_TP_DIMS = (("wz", 1), ("wx", 1), ("wdt", 1), ("conv_w", 1), ("conv_b", 0),
            ("A_log", 0), ("D_skip", 0), ("dt_bias", 0), ("norm_scale", 0),
            ("w_out", 0))


def _tp(cfg, mesh) -> bool:
    """Whether the mixer's inner channels and heads split over "model"
    (all of them together, or none)."""
    decl = mamba_decl(cfg)
    split = {spmd.model_split(decl[k], dim, mesh) for k, dim in _TP_DIMS}
    if len(split) != 1:
        di, h, g, n = mamba_dims(cfg)
        raise NotImplementedError(
            f"{cfg.name}: {di} inner channels, {h} SSD heads and "
            f"{di + 2 * g * n} conv channels do not all split over "
            f"{M.axis_sizes(mesh)}'s 'model' axis")
    return split.pop()


def local_dims(cfg, mesh):
    """(inner channels, SSD heads) of this rank's block of the mixer."""
    di, h, _, _ = mamba_dims(cfg)
    nm = spmd.model_rank(mesh)[1] if _tp(cfg, mesh) else 1
    return di // nm, h // nm


def _mamba_spmd(cfg, p, x, mesh, cache: Optional[MambaCache] = None,
                eps: float = 1e-6):
    """The mixer on this rank's blocks (see the module's docstring): x
    (B_loc, S, D) replicated over "model" → (y (B_loc, S, D), the new
    cache or None); ``cache`` this rank's block (`init_mamba_cache` with
    ``mesh``: its rows, its [xi_r | B | C] conv channels and its
    heads)."""
    decl = mamba_decl(cfg)
    bsz, s, _ = x.shape
    di, h, g, n = mamba_dims(cfg)
    tp = _tp(cfg, mesh)
    m, nm = spmd.model_rank(mesh) if tp else (0, 1)
    dl, hl = di // nm, h // nm
    gb = spmd.global_batch(bsz, mesh)

    def w(name):
        return spmd.param(p, name, decl, mesh).to(x.dtype)
    wb, wc = w("wB"), w("wC")
    if tp:                              # column-parallel input
        x = M.enter_replicated(x, mesh, "model")
        wb = M.enter_replicated(wb, mesh, "model")
        wc = M.enter_replicated(wc, mesh, "model")
    dt_raw = x @ w("wdt")
    z = x @ w("wz")
    xi = x @ w("wx")
    xbc = torch.cat([xi, x @ wb, x @ wc], dim=-1)   # [xi_r | B | C]
    conv = {"conv_w": p["conv_w"], "conv_b": p["conv_b"]}
    if tp:                              # the taps of this rank's channels
        taps = torch.cat([torch.arange(m * dl, (m + 1) * dl),
                          torch.arange(di, di + 2 * g * n)]).to(x.device)
        conv = {"conv_w": M.gather_param(conv["conv_w"], 1, mesh,
                                         ("model",))[:, taps],
                "conv_b": M.gather_param(conv["conv_b"], 0, mesh,
                                         ("model",))[taps]}
    xbc, new_conv = _conv_causal(conv, xbc,
                                 None if cache is None else cache.conv)
    xi, bproj, cproj = torch.split(xbc, [dl, g * n, g * n], dim=-1)

    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    xh = constrain(xi.reshape(bsz, s, hl, cfg.ssm_head_dim), "batch",
                   "seq", "act_heads", None,
                   shape=(gb, s, h, cfg.ssm_head_dim))
    group = (m * hl + torch.arange(hl, device=x.device)) // (h // g)
    bm = bproj.reshape(bsz, s, g, n)[:, :, group]
    cm = cproj.reshape(bsz, s, g, n)[:, :, group]
    if cache is not None and s == 1:
        y, new_ssm = ssd_decode_step(cache.ssm, xh[:, 0], dt[:, 0],
                                     p["A_log"], bm[:, 0], cm[:, 0],
                                     p["D_skip"])
        y = y[:, None]
    else:
        y, new_ssm = ssd_chunked(
            xh, dt, p["A_log"], bm, cm, p["D_skip"], chunk=cfg.ssm_chunk,
            init_state=None if cache is None else cache.ssm)
    new_cache = None if cache is None else MambaCache(new_conv, new_ssm)
    y = y.reshape(bsz, s, dl).to(x.dtype)
    if not tp:
        y = rmsnorm({"scale": p["norm_scale"]}, y * silu(z), eps)
        return y @ w("w_out"), new_cache
    # the gated RMSNorm over all di channels: the sum of squares added
    # over "model" (its cotangent too: each rank's part feeds its own)
    gy = (y * silu(z)).float()
    sq = M.enter_replicated(M.reduce_replicated(
        torch.sum(gy * gy, dim=-1, keepdim=True), mesh, "model"),
        mesh, "model")
    y = (gy * torch.rsqrt(sq / di + eps)
         * p["norm_scale"].float()).to(x.dtype)
    # row-parallel output
    return M.reduce_replicated(y @ w("w_out"), mesh, "model"), new_cache


class Mamba(ParamTree):
    """The mixer's parameters (`mamba_decl`) over `mamba_block`."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__(mamba_decl(cfg), dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x, cache: Optional[MambaCache] = None):
        return mamba_block(self.cfg, self, x, cache=cache)


class MambaBlock(torch.nn.Module):
    """Pre-norm Mamba2 block (``{"ln1", "mamba"}``): x + mixer(norm(x))."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg, dtype=dtype, device=device)
        self.mamba = Mamba(cfg, dtype=dtype, device=device)

    def forward(self, x, cache: Optional[MambaCache] = None):
        m, new_cache = self.mamba(self.ln1(x), cache)
        x = x + m
        mesh = spmd.active_mesh()
        if mesh is not None:
            x = constrain(x, "batch", "seq", "act_embed", shape=(
                spmd.global_batch(x.shape[0], mesh), x.shape[1],
                x.shape[2]))
        return x, new_cache
