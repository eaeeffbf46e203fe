"""GQA attention with RoPE, KV-chunked softmax and cached decode —
counterpart of `repro.models.attention`: self-attention, and the
encoder–decoder's cross-attention (``kv_input=``, `attention_with_kv`).

Q heads may be padded per KV group (``cfg.n_heads_padded``): the padded
slots are masked dead (`head_mask`), so the architecture stays
config-exact.  Products stay plain ``torch`` matmuls, as the reference's
are plain XLA; ``F.scaled_dot_product_attention`` would round
differently from the reference's own softmax, so it is not used.
Under a mesh of more than one rank (`sharding.spmd`) the layer is
tensor-parallel where its Q heads split over "model": Q/K/V column-parallel over "heads" / "kv_heads", ``wo``
row-parallel, the padded-head mask cut to the rank's heads
(`_attention_spmd`) — causal or bidirectional self-attention, and
cross-attention, whose K/V are projected from the encoder states
entered replicated (their cotangent summed over "model", and over the
decoder layers that read them).  Where the KV heads do not split over
"model" (`_kv_logical` replicates K and V), K and V are computed whole
on every rank — ``wk`` / ``wv`` gathered over "model" where their
columns are split mid-head, their cotangents reduce-scattered — and
each rank takes the KV head of each of its Q heads.

Under the sequence split (`sharding.rules.get_seq`: "fsdp", where the rows
leave "model"), x is this rank's block of positions: Q stays local, K
and V are projected on the block, take RoPE at its global positions and
are gathered over "model" around `_sdpa` (`mesh.gather_seq`, whose
backward reduce-scatters their cotangents), the causal mask and the
KV-chunked softmax see Q from the block's offset on, and the output
stays local.

Serving under a mesh: a rank's KV cache block holds its rows and its
KV heads (`local_kv_heads`) — where K and V are computed whole, all of
them, where the reference splits the head dim over "model"
(`cache_logical`): a rank-local layout, so that a decode step reads its
cache and moves nothing but the row-parallel sum.  The new token's K/V
go into the block at the cache's length, and the rank attends over its
heads; a prefill under the sequence split writes the gathered K/V, every
position, into each rank's block.  Cross-attention's cached K/V are
blocks alike (`cross_kv`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import mesh as M
from ..mesh import axis_sizes
from ..sharding import spmd
from ..sharding.rules import constrain, get_mesh, get_seq
from .layers import apply_rope, rounded
from .params import ParamTree, PDecl

NEG_INF = -1e30


def attention_decl(cfg, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads, cfg.hd
    decl = {
        "wq": PDecl((d, h * hd), ("embed", "heads")),
        "wk": PDecl((d, kv * hd), ("embed", "kv_heads")),
        "wv": PDecl((d, kv * hd), ("embed", "kv_heads")),
        "wo": PDecl((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        decl.update({
            "bq": PDecl((h * hd,), ("heads",), "zeros"),
            "bk": PDecl((kv * hd,), ("kv_heads",), "zeros"),
            "bv": PDecl((kv * hd,), ("kv_heads",), "zeros"),
        })
    return decl


def head_mask(cfg, dtype, device=None) -> Optional[torch.Tensor]:
    """(H_pad,) 1/0 mask killing padded Q-head slots (slot r within each
    KV group is real iff r < rep).  None when no padding."""
    hp, h, kv = cfg.n_heads_padded, cfg.n_heads, cfg.n_kv_heads
    if hp == h:
        return None
    rep, rep_pad = h // kv, hp // kv
    m = (torch.arange(hp, device=device) % rep_pad) < rep
    return m.to(dtype)


def _kv_logical(cfg) -> Optional[str]:
    """Shard 4D K/V on kv_heads only when it divides the model axis;
    otherwise replicate them explicitly (the cheap, predictable layout)."""
    mesh = get_mesh()
    ms = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    return "kv_heads" if cfg.n_kv_heads % max(ms, 1) == 0 else None


def cache_logical(cfg, mesh_model: int):
    """Logical axes for the KV cache given the model-axis size."""
    if cfg.n_kv_heads % max(mesh_model, 1) == 0:
        return ("batch", "seq", "kv_heads", None)
    return ("batch", "seq", None, "kv_heads")  # shard head_dim instead


class KVCache(NamedTuple):
    """Past keys and values: k, v (B, S_max, KV, hd), or (L, B, S_max,
    KV, hd) stacked over a stage's layers; ``length`` the filled
    positions (a host int: positions never need a sync)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    kv, hd = cfg.n_kv_heads, cfg.hd
    return KVCache(torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                               device=device),
                   torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                               device=device), 0)


def _project(cfg, p, x):
    h, kv, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    b, s = x.shape[:2]
    return q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd), \
        v.reshape(b, s, kv, hd)


class _BmmF32(torch.autograd.Function):
    """bf16 ``a @ b`` (batched) returned in f32 on the card, with a
    backward (torch gives ``bmm``'s ``out_dtype`` form none): each
    operand's gradient is the product of the f32 cotangent rounded to the
    operands' dtype with the other operand, accumulated in f32 and
    returned in that dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        gb = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with an f32 result — the reference's einsums
    with ``preferred_element_type=float32``.  f32 inputs: a plain
    product.  bf16 inputs on the card: one bf16 tensor-core product that
    accumulates and returns f32 (``out_dtype``), never a bf16 result
    rounded a second time.  bf16 on the CPU, which has no such kernel:
    the f32 product of the operands upcast, the same products (bf16 →
    f32 is exact, as is a product of two bf16 values in f32).  All three
    are differentiable (the card's through `_BmmF32`)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _sdpa(q, k, v, *, causal: bool, q_offset: int, scale: float,
          chunk: int = 0):
    """softmax(q·kᵀ)·v with GQA head repetition.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  ``q_offset`` is the absolute
    position of q[0] (for causal masking against a longer KV).
    When ``chunk`` > 0, Sk > chunk and chunk divides Sk, iterate KV
    blocks with an online softmax (flash-style) so peak memory is
    O(Sq·chunk), not O(Sq·Sk).  Scores and P·V accumulate in f32
    (`_bmm_f32`); the inputs keep their dtype, with the reference's
    casts: the scale and q·scale rounded to q's dtype, P to V's.
    Returns f32.
    """
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    dev = q.device
    # the scale takes q's dtype first (bf16 0.353515625 for hd = 8)
    qf = (q * rounded(scale, q.dtype)).reshape(b, sq, kv, rep, hd)
    # (b·kv, rep·sq, hd): query rows grouped by KV head
    qg = qf.permute(0, 2, 3, 1, 4).reshape(b * kv, rep * sq, hd)
    qpos = q_offset + torch.arange(sq, device=dev)

    def block(ks, vs, k0):
        n = ks.shape[1]
        kt = ks.permute(0, 2, 3, 1).reshape(b * kv, hd, n)
        s = _bmm_f32(qg, kt).reshape(b, kv, rep, sq, n)
        if causal:
            kpos = k0 + torch.arange(n, device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask, s, NEG_INF)
        return s, vs.permute(0, 2, 1, 3).reshape(b * kv, n, hd)

    def pv(p_, vg):
        n = p_.shape[-1]
        return _bmm_f32(p_.to(vg.dtype).reshape(b * kv, rep * sq, n),
                        vg).reshape(b, kv, rep, sq, hd)

    if chunk and sk > chunk and sk % chunk == 0:
        m = torch.full((b, kv, rep, sq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, rep, sq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, rep, sq, hd), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, sk, chunk):
            s, vg = block(k[:, k0:k0 + chunk], v[:, k0:k0 + chunk], k0)
            m_new = torch.maximum(m, s.amax(-1))
            p_ = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(-1)
            acc = acc * corr[..., None] + pv(p_, vg)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
    else:
        s, vg = block(k, v, 0)
        out = pv(torch.softmax(s, dim=-1), vg)

    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def _query(cfg, p, x):
    """Q alone (B, S, H_pad, hd): cross-attention's projection."""
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    return q.reshape(b, s, cfg.n_heads_padded, cfg.hd)


def _output(cfg, p, out, x):
    """Dead heads masked, heads merged in x's dtype, then ``wo``."""
    b, s = x.shape[:2]
    hm = head_mask(cfg, out.dtype, out.device)
    if hm is not None:
        out = out * hm[None, None, :, None]
    out = out.reshape(b, s, cfg.n_heads_padded * cfg.hd).to(x.dtype)
    return out @ p["wo"].to(x.dtype)


def attention_with_kv(cfg, p, x, k, v):
    """Cross-attention against precomputed K/V (B, S_enc, KV, hd): the
    encoder–decoder's cached decode.  Under a mesh of more than one rank,
    x is this rank's rows and k / v its block of them (`cross_kv`)."""
    mesh = spmd.active_mesh()
    if mesh is not None:
        return _attention_spmd(cfg, p, x, None, mesh, causal=False,
                               kv=(k, v))[0]
    out = _sdpa(_query(cfg, p, x), k.to(x.dtype), v.to(x.dtype),
                causal=False, q_offset=0, scale=cfg.hd ** -0.5,
                chunk=cfg.attn_chunk)
    return _output(cfg, p, out, x)


def attention(cfg, p, x, *, causal=True, positions=None,
              cache: Optional[KVCache] = None, kv_input=None):
    """Full attention layer.  Returns (y, new_cache).

    * training/prefill: ``cache is None`` → self-attention over x.
    * decode (or cached prefill): ``cache`` holds past KV; x is the new
      (B, s, D) slice.  Its K/V are written into the cache's tensors in
      place (the reference's functional update with its buffers
      donated), and the new cache shares them.  Attention then runs
      over all ``S_max`` slots, as the reference's does: the causal mask
      kills the zeros past the filled length.
    * cross-attention: ``kv_input`` (B, S_enc, D) supplies the encoder
      sequence: K/V projected from it (no bias), no RoPE, no mask.
    """
    b, s, _ = x.shape
    scale = cfg.hd ** -0.5
    mesh = spmd.active_mesh()
    if mesh is not None:
        return _attention_spmd(cfg, p, x, positions, mesh, causal=causal,
                               kv_input=kv_input, cache=cache)
    if kv_input is None:
        q, k, v = _project(cfg, p, x)
    else:
        q = _query(cfg, p, x)
        se = kv_input.shape[1]
        k = (kv_input @ p["wk"].to(x.dtype)).reshape(b, se, cfg.n_kv_heads,
                                                     cfg.hd)
        v = (kv_input @ p["wv"].to(x.dtype)).reshape(b, se, cfg.n_kv_heads,
                                                     cfg.hd)

    if cfg.pos == "rope" and kv_input is None:
        if positions is None:
            base = cache.length if cache is not None else 0
            positions = (base + torch.arange(s, device=x.device)).expand(b, s)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        new_cache = _write(cache, k, v)
        out = _sdpa(q, cache.k, cache.v, causal=True, q_offset=cache.length,
                    scale=scale, chunk=cfg.attn_chunk)
    else:
        out = _sdpa(q, k, v, causal=causal and kv_input is None, q_offset=0,
                    scale=scale, chunk=cfg.attn_chunk)
    return _output(cfg, p, out, x), new_cache


def _write(cache: KVCache, k, v) -> KVCache:
    """k, v (B, s, KV, hd) written into the cache's tensors at its
    length, in place → the cache s positions longer."""
    ln, s = cache.length, k.shape[1]
    if ln + s > cache.k.shape[1]:
        raise ValueError(f"KV cache of {cache.k.shape[1]} positions "
                         f"cannot take {s} more after {ln}")
    cache.k[:, ln:ln + s] = k.to(cache.k.dtype)
    cache.v[:, ln:ln + s] = v.to(cache.v.dtype)
    return KVCache(cache.k, cache.v, ln + s)


class _Layout(NamedTuple):
    """How the attention layer splits over a mesh: ``tp`` whether its Q
    heads split over "model" (this rank ``m`` of ``n``), ``k_split``
    whether ``wk`` / ``wv``'s columns do, ``whole_kv`` whether K and V
    are computed whole on every rank (`_kv_logical` replicates them)."""
    tp: bool
    m: int
    n: int
    k_split: bool
    whole_kv: bool


def _layout(cfg, mesh) -> _Layout:
    decl = attention_decl(cfg)
    tp = spmd.model_split(decl["wq"], 1, mesh)
    m, n = spmd.model_rank(mesh) if tp else (0, 1)
    k_split = spmd.model_split(decl["wk"], 1, mesh)
    if k_split and not tp:
        raise NotImplementedError(
            f"{cfg.name}: K/V columns split over 'model' while the "
            f"{cfg.n_heads_padded} Q heads do not: pad the heads to the "
            "model axis")
    return _Layout(tp, m, n, k_split, tp and cfg.n_kv_heads % n != 0)


def local_kv_heads(cfg, mesh) -> int:
    """The KV heads a rank's cache block holds under ``mesh``: its block
    of them where the Q heads split over "model" and the KV heads divide
    it, else all of them (K and V are computed whole on every rank)."""
    if mesh is None:
        return cfg.n_kv_heads
    lay = _layout(cfg, mesh)
    return cfg.n_kv_heads // lay.n if lay.tp and not lay.whole_kv \
        else cfg.n_kv_heads


def _kv_proj(cfg, p, src, mesh, lay: _Layout, bias: bool):
    """K and V (B_loc, S, KV_loc, hd) of ``src`` on this rank's blocks:
    its KV heads, or all of them where ``lay.whole_kv`` (``wk`` / ``wv``
    gathered over "model" where their columns split mid-head, their
    cotangents reduce-scattered; else entered replicated)."""
    decl = attention_decl(cfg)
    out = []
    for w, bname in (("wk", "bk"), ("wv", "bv")):
        wt = spmd.param(p, w, decl, mesh)
        bt = p[bname] if cfg.qkv_bias and bias else None
        if lay.whole_kv:
            if lay.k_split:             # columns split mid-head: gather
                wt = M.gather_param(wt, 1, mesh, ("model",))
                bt = None if bt is None else M.gather_param(
                    bt, 0, mesh, ("model",))
            else:                       # whole, each rank's use a part
                wt = M.enter_replicated(wt, mesh, "model")
                bt = None if bt is None else M.enter_replicated(
                    bt, mesh, "model")
        y = src @ wt.to(src.dtype)
        if bt is not None:
            y = y + bt.to(src.dtype)
        out.append(y.reshape(src.shape[0], src.shape[1], -1, cfg.hd))
    return out


def cross_kv(cfg, p, enc):
    """Cross-attention's K and V (B, S_enc, KV, hd) projected from the
    encoder states ``enc`` (no bias, in its dtype): under a mesh of more
    than one rank this rank's block of them (`local_kv_heads`), from its
    rows of ``enc``."""
    mesh = spmd.active_mesh()
    b, se, _ = enc.shape
    if mesh is None:
        return [(enc @ p[w].to(enc.dtype)).reshape(b, se, cfg.n_kv_heads,
                                                   cfg.hd)
                for w in ("wk", "wv")]
    return _kv_proj(cfg, p, enc, mesh, _layout(cfg, mesh), bias=False)


def _group_kv(k, v, m: int, h: int, hp: int, kv: int):
    """Each of this rank's ``h`` Q heads (from head ``m·h``) given its KV
    head, out of the ``kv`` whole: a view of the heads' range where they
    cover it evenly (the GQA repetition then pairs them), else their
    gathered copies."""
    group = [(m * h + i) // (hp // kv) for i in range(h)]
    lo, hi = group[0], group[-1] + 1
    per = h // (hi - lo)
    if h % (hi - lo) == 0 and group == [lo + i // per for i in range(h)]:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor(group, device=k.device)
    return k[:, :, idx], v[:, :, idx]


def _attention_spmd(cfg, p, x, positions, mesh, *, causal=True,
                    kv_input=None, cache: Optional[KVCache] = None,
                    kv=None):
    """Attention on this rank's blocks (see the module's docstring): x
    (B_loc, S, D) replicated over "model" → (y (B_loc, S, D), the new
    cache or None).  Self-attention, its K/V written into this rank's
    cache block when ``cache`` is given (`init_cache` of its
    `local_kv_heads`); cross-attention against ``kv_input`` (B_loc,
    S_enc, D), likewise replicated (its K/V without bias, no RoPE, no
    mask), or against this rank's block ``kv`` = (k, v) of them
    (`cross_kv`: the cached decode).  Under the sequence split x is this
    rank's block of positions, K and V gathered over its axes."""
    decl = attention_decl(cfg)
    b, s, _ = x.shape
    gb = spmd.global_batch(b, mesh)
    seq = get_seq()
    offset = 0 if seq is None else seq.offset
    gs = spmd.global_seq(s)
    hd, hp, nkv = cfg.hd, cfg.n_heads_padded, cfg.n_kv_heads
    lay = _layout(cfg, mesh)
    cross = kv_input is not None or kv is not None
    if lay.tp:                          # column-parallel input
        x = M.enter_replicated(x, mesh, "model")
        if kv_input is not None:
            kv_input = M.enter_replicated(kv_input, mesh, "model")
    q = x @ spmd.param(p, "wq", decl, mesh).to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, s, -1, hd)
    if kv is None:
        k, v = _kv_proj(cfg, p, x if kv_input is None else kv_input, mesh,
                        lay, bias=kv_input is None)
    else:
        k, v = (t.to(x.dtype) for t in kv)
    kvlog = _kv_logical(cfg)
    se = k.shape[1] if cross else gs    # K/V's global positions
    q = constrain(q, "batch", "seq", "heads", None, shape=(gb, gs, hp, hd))
    k = constrain(k, "batch", "seq", kvlog, None, shape=(gb, se, nkv, hd))
    v = constrain(v, "batch", "seq", kvlog, None, shape=(gb, se, nkv, hd))
    base = cache.length if cache is not None else 0
    if cfg.pos == "rope" and not cross:
        if positions is None:
            positions = (base + offset + torch.arange(
                s, device=x.device)).expand(b, s)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if seq is not None and not cross:   # K/V of every position
        k = M.gather_seq(k, 1, mesh, seq.axes)
        v = M.gather_seq(v, 1, mesh, seq.axes)
    new_cache = None
    if cache is not None:
        new_cache = _write(cache, k, v)
        k, v = cache.k, cache.v
    h = q.shape[2]
    if lay.whole_kv:                    # each Q head's KV head
        k, v = _group_kv(k, v, lay.m, h, hp, nkv)
    out = _sdpa(q, k, v, causal=causal and not cross,
                q_offset=base + offset, scale=cfg.hd ** -0.5,
                chunk=cfg.attn_chunk)
    hm = head_mask(cfg, out.dtype, out.device)
    if hm is not None:
        out = out * hm[lay.m * h:(lay.m + 1) * h][None, None, :, None]
    out = out.reshape(b, s, h * hd).to(x.dtype)
    out = constrain(out, "batch", "seq", "heads", shape=(gb, gs, hp * hd))
    y = out @ spmd.param(p, "wo", decl, mesh).to(x.dtype)
    if lay.tp:                          # row-parallel output
        y = M.reduce_replicated(y, mesh, "model")
    return y, new_cache


class Attention(ParamTree):
    """The attention layer's parameters (`attention_decl`) over
    `attention`."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__(attention_decl(cfg), dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x, *, causal=True, positions=None, cache=None,
                kv_input=None):
        return attention(self.cfg, self, x, causal=causal,
                         positions=positions, cache=cache,
                         kv_input=kv_input)
