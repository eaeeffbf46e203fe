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

Expert parallelism over the mesh's "model" axis (n ranks, each holding
E/n experts: its block of ``w_in`` / ``w_out`` under ``P("model", None,
None)``, ``w_router`` whole), chosen as the reference chooses
(`ep_branch`): a mesh set with `sharding.mesh_context` whose "model"
axis is > 1 and divides E.  The port is SPMD, so every rank passes its
own block of x, and `moe` is told the global batch (``global_batch=``),
which decides the branch:

* ``tp`` — x split over the data axes (those whose product divides
  the global batch; replicated over the others: a decode batch of 1 is
  whole on every rank), replicated over "model": each rank routes every
  token of its block, runs its experts
  (`_moe_local` at n ranks, cap from the block's tokens) and the
  partial outputs are summed over "model" (`mesh.reduce_replicated`,
  adds in rank order where XLA's all-reduce has none: held to a
  tolerance, not bit for bit);
* ``a2a`` (the "fsdp" profile, where the global batch divides n·∏ data
  axes) — x split over the data axes and "model": each rank routes its
  own tokens into an (E, cap, D) send buffer, cap = max(4, T_loc·k·cf
  // E) per (expert, source rank), and two `mesh.all_to_all` exchanges
  carry them to the experts' ranks and back (`_moe_a2a`).  Every rank
  sends all ``cap`` rows of every expert: the single-rank trim above
  would give the ranks different shapes.

Both are differentiable.  x's gradient is its block's whole gradient
(under ``tp`` the ranks' parts are summed over "model",
`mesh.enter_replicated`); a weight's gradient is this rank's part, the
sum over the ranks holding the same block — the data axes for an
expert slice, every rank for ``w_router`` — being the global one (the
data-parallel reduction a trainer makes).

In a sharded model (`MoE` under a mesh of more than one rank,
`sharding.spmd`) the layer's parameters are the rank's blocks under
`tree_pspecs`: `moe_spmd` gathers their "embed" / "expert_embed" dims
(reduce-scattered in the backward), hands the expert branch the block
of x it takes, sums the router's gradient parts over "model" under
``tp`` (each rank routes for its own experts), and runs the shared
experts tensor-parallel.  Without an expert-parallel branch (one
"model" rank, or experts that do not split over it) the ranks' rows are
gathered and the single-rank layer runs on the global batch, as the
reference's capacity is the global batch's; each rank keeps its rows.
Under the sequence split (`sharding.rules.get_seq`: "fsdp", rows that leave
"model", so the branch is ``tp`` or none) x is a block of positions: the
layer gathers its rows' whole sequence over "model" first, as the
reference's ``shard_map`` in_spec ``P(data axes, None, None)`` does, so
that capacity counts the same tokens, and each rank keeps its block
after — under ``tp`` the experts' partial outputs reduce-scattered over
"model" (`mesh.scatter_seq`), the router's gradient parts summed with
the other leaves' over "model" (no rank replicates another's tokens).
Where such rows stay copied over "model" instead (a length "model" does
not divide), each copy weighed 1/"model" in the backward, the partial
outputs sum both ways (`mesh.sum_replicas`): each rank's experts take
the whole output's cotangent.

BigFCM tie-in: `repro_torch.integration.fcm_router_init` seeds
``w_router`` with FCM centroids of token embeddings.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import mesh as M
from ..device import is_fake
from ..sharding import spmd
from ..sharding.rules import data_axes, get_mesh, get_profile, get_seq
from .layers import silu
from .params import ParamTree, PDecl

CAP_FLOOR = 8       # the reference's minimum capacity an expert
A2A_CAP_FLOOR = 4   # _moe_a2a's, per (expert, source rank)
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
        decl["w_shared_in"] = PDecl((d, 2 * fs), ("embed", "mlp"),
                                    gated=True)
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


def a2a_capacity(cfg, t: int) -> int:
    """Tokens an expert takes at most from each source rank under
    all-to-all dispatch, for the rank's t tokens."""
    return max(A2A_CAP_FLOOR, int(t * cfg.top_k * cfg.capacity_factor)
               // cfg.n_experts)


class Dispatch(NamedTuple):
    """The sorted pairs: ``order`` (T·k,) sorts the flat (token, k)
    pairs stably by expert; ``sorted_e`` their experts, ``pos`` each
    one's rank inside its expert, ``valid`` = pos < cap; ``counts`` (E,)
    pairs routed to each expert, dropped ones included.  On one rank of
    n (``tp``) the experts are the rank's E/n, numbered from 0, and the
    other ranks' pairs sort last under id E/n, never valid (``counts``
    has E/n + 1 entries)."""
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


def dispatch(cfg, eidx, *, cap: Optional[int] = None, n_ranks: int = 1,
             rank: int = 0) -> Dispatch:
    """The pairs of expert ids ``eidx`` (T, k) sorted for the experts of
    ``rank`` of ``n_ranks`` (all of them at one rank), ``cap`` (default
    `capacity`) an expert."""
    t, k = eidx.shape
    e_loc = cfg.n_experts // n_ranks
    cap = capacity(cfg, t) if cap is None else cap
    flat_e = eidx.reshape(-1)
    n_ids = e_loc
    if n_ranks > 1:
        lo = rank * e_loc
        mine = (flat_e >= lo) & (flat_e < lo + e_loc)
        flat_e = torch.where(mine, flat_e - lo, e_loc)     # e_loc: trash
        n_ids += 1
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _counts(flat_e, n_ids)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=eidx.device) - starts[sorted_e]
    valid = (pos < cap) & (sorted_e < e_loc)
    return Dispatch(order, sorted_e, pos, valid, counts, cap)


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


def _combine(y, slot, dp: Dispatch, gate, eidx, dtype):
    """Each token's k weighted expert outputs ``y[slot]`` (a zero row for
    a dropped pair) added one at a time in ascending expert order,
    rounding after each add: the reference's scatter-add over the sorted
    pairs.  → (T, D)."""
    t, k = eidx.shape
    d = y.shape[-1]
    w = torch.where(dp.valid, gate.reshape(-1)[dp.order], 0.0).to(dtype)
    contrib = torch.empty((t * k, d), dtype=dtype, device=y.device)
    contrib[dp.order] = y[slot] * w[:, None]         # back to (token, k)
    contrib = contrib.reshape(t, k, d)
    rank = torch.argsort(eidx, dim=-1)
    contrib = torch.gather(contrib, 1, rank[..., None].expand(t, k, d))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def _moe_local(x, w_router, w_in, w_out, *, cfg, n_ranks: int = 1,
               rank: int = 0, mesh=None):
    """The reference's per-rank body: x (B, S, D) → (B, S, D).  At n
    ranks (``tp``), x is replicated over the mesh's "model" axis, w_in /
    w_out are this rank's E/n experts (its coordinate ``rank`` on the
    axis), and the partial outputs are summed over "model"."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    e_loc = cfg.n_experts // n_ranks
    if mesh is not None:
        x = M.enter_replicated(x, mesh, "model")
    xt = x.reshape(t, d)
    gate, eidx = route(cfg, w_router, xt)
    dp = dispatch(cfg, eidx, n_ranks=n_ranks, rank=rank)
    # rows an expert in the buffer: the fullest expert's (≤ cap); a
    # traced tensor (the dry run's) has no count to read: cap rows
    rows = dp.cap
    if dp.cap > CAP_FLOOR and not is_fake(x):
        rows = min(dp.cap, int(dp.counts[:e_loc].max()))
    slot = torch.where(dp.valid, dp.sorted_e * rows + dp.pos, e_loc * rows)
    tok = dp.order // k                              # token of each pair
    buf = torch.zeros((e_loc * rows + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xt[tok]                              # last row: trash
    if torch.is_grad_enabled():
        # new tensors for autograd; the trash row stays out of the
        # graph (its gradient is zero), and y's is the dropped pairs' 0
        y = torch.cat([_expert_ffn(w_in, w_out, buf[:-1].view(e_loc, rows, d))
                       .reshape(e_loc * rows, d), buf.new_zeros((1, d))])
    else:
        y = torch.zeros_like(buf)       # its last row: the dropped pairs' 0
        _expert_ffn(w_in, w_out, buf[:-1].view(e_loc, rows, d),
                    out=y[:-1].view(e_loc, rows, d))
    del buf
    out = _combine(y, slot, dp, gate, eidx, x.dtype)
    if mesh is not None:
        out = M.reduce_replicated(out, mesh, "model")
    return out.reshape(b, s, d)


def _moe_a2a(x, w_router, w_in, w_out, *, cfg, n_ranks: int, mesh,
             axis: str = "model"):
    """GShard-style expert parallelism with all-to-all dispatch: x
    (B_loc, S, D) this rank's tokens (split over the data axes and
    ``axis``), w_in / w_out this rank's E/n experts.  Each rank packs its
    routed tokens into an (E, cap, D) buffer ordered by destination
    expert, one all-to-all takes block j to rank j, the experts run over
    (E/n, n·cap, D) rows grouped by local expert, and a second all-to-all
    brings the outputs home."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    e_loc = e // n_ranks
    xt = x.reshape(t, d)
    gate, eidx = route(cfg, w_router, xt)
    cap = a2a_capacity(cfg, t)
    dp = dispatch(cfg, eidx, cap=cap)
    slot = torch.where(dp.valid, dp.sorted_e * cap + dp.pos, e * cap)
    tok = dp.order // k
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xt[tok]                              # last row: trash
    # (n, e_loc·cap, D) → a2a → rows from every source rank, source-major
    recv = M.all_to_all(buf[:-1].view(n_ranks, e_loc * cap, d), mesh, axis)
    del buf
    recv = recv.view(n_ranks, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, n_ranks * cap, d)
    y = _expert_ffn(w_in, w_out, recv)
    del recv
    # inverse permutation back to (n, e_loc·cap, D) and a2a home
    y = y.view(e_loc, n_ranks, cap, d).transpose(0, 1) \
        .reshape(n_ranks, e_loc * cap, d)
    back = M.all_to_all(y, mesh, axis).reshape(e * cap, d)
    del y
    back = torch.cat([back, back.new_zeros((1, d))])
    return _combine(back, slot, dp, gate, eidx, x.dtype).reshape(b, s, d)


def ep_branch(cfg, mesh, global_batch: int) -> Optional[str]:
    """The reference's choice of expert-parallel branch: None without a
    mesh whose "model" axis is > 1 and divides n_experts; "a2a" under the
    "fsdp" profile where ``global_batch`` divides n_ranks · ∏ data axes;
    else "tp"."""
    if mesh is None:
        return None
    sizes = M.axis_sizes(mesh)
    n = sizes.get("model", 1)
    if n <= 1 or cfg.n_experts % n:
        return None
    split = n * math.prod(sizes[a] for a in data_axes(mesh))
    if get_profile() == "fsdp" and global_batch % split == 0:
        return "a2a"
    return "tp"


def ep_batch_axes(branch: Optional[str], mesh,
                  global_batch: Optional[int] = None) -> tuple:
    """The mesh axes x's batch dim is split over under ``branch`` (the
    reference's x_spec): the data axes, and "model" under "a2a"; none on
    one rank.  With ``global_batch``, under "tp", those of the data axes
    whose product divides it (`launch.specs.batch_axes_for`'s rule): the
    rows are replicated over the others (a batch of 1 on every rank)."""
    if branch is None:
        return ()
    if branch == "a2a":
        return data_axes(mesh) + ("model",)
    if global_batch is None:
        return data_axes(mesh)
    return spmd.dividing_axes(data_axes(mesh), global_batch, mesh)


def moe(cfg, p, x, *, global_batch: Optional[int] = None):
    """MoE FFN: routed experts plus the shared ones.

    Without a mesh (`sharding.mesh_context`) on one device.  Under a
    mesh, x is this rank's block of the global (``global_batch``, S, D)
    batch, split over `ep_batch_axes` of the branch `ep_branch` picks
    (see the module's docstring); p's ``w_in`` / ``w_out`` are the rank's
    experts under an expert-parallel branch.  A mesh without one runs
    the single-rank layer on the whole batch.  A block of the wrong size
    raises."""
    mesh = get_mesh()
    branch = None
    if mesh is not None:
        if global_batch is None:
            raise ValueError("moe under a mesh needs global_batch=: the "
                             "a2a-or-tp choice reads the global batch")
        branch = ep_branch(cfg, mesh, global_batch)
        axes = ep_batch_axes(branch, mesh, global_batch)
        blocks = math.prod(M.axis_sizes(mesh)[a] for a in axes)
        if x.shape[0] * blocks != global_batch:
            raise ValueError(
                f"moe ({branch or 'one rank'}): a block of {x.shape[0]} "
                f"rows over {axes} is not the global batch "
                f"{global_batch}")
    y = _routed(cfg, p, x, mesh, branch)
    if cfg.n_shared_experts:
        h = x @ p["w_shared_in"].to(x.dtype)
        u, g = torch.chunk(h, 2, dim=-1)
        y = y + (u * silu(g)) @ p["w_shared_out"].to(x.dtype)
    return y


def _routed(cfg, p, x, mesh, branch):
    """The routed experts of `moe` under ``branch``."""
    if branch is None:
        return _moe_local(x, p["w_router"], p["w_in"], p["w_out"], cfg=cfg)
    n = M.axis_sizes(mesh)["model"]
    if p["w_in"].shape[0] != cfg.n_experts // n:
        raise ValueError(f"moe ({branch}): w_in holds "
                         f"{p['w_in'].shape[0]} experts, not this "
                         f"rank's {cfg.n_experts // n}")
    if branch == "a2a":
        return _moe_a2a(x, p["w_router"], p["w_in"], p["w_out"], cfg=cfg,
                        n_ranks=n, mesh=mesh)
    return _moe_local(x, p["w_router"], p["w_in"], p["w_out"], cfg=cfg,
                      n_ranks=n, rank=M.block_index(mesh, ("model",))[0],
                      mesh=mesh)


def moe_spmd(cfg, p, x, mesh):
    """The layer in a sharded model (see the module's docstring): p this
    rank's blocks under `tree_pspecs`, x (B_loc, S, D) its rows of the
    global batch, replicated over "model" under "tp" → (B_loc, S, D)."""
    decl = moe_decl(cfg)
    gb = spmd.global_batch(x.shape[0], mesh)
    branch = ep_branch(cfg, mesh, gb)
    w = {k: spmd.param(p, k, decl, mesh)
         for k in ("w_router", "w_in", "w_out")}
    seq = get_seq()
    if branch is None:
        # the reference's capacity is the global batch's: gather the
        # rows (and their sequence), run one rank's layer on them, keep
        # this rank's block
        axes = spmd.batch_axes(mesh)
        b, _ = M.block_index(mesh, axes)
        x_all = M.gather_param(x, 0, mesh, axes)
        lo, hi = 0, x.shape[1]
        if seq is not None:
            x_all = M.gather_seq(x_all, 1, mesh, seq.axes)
            lo, hi = seq.offset, seq.offset + seq.size
        y = _moe_local(x_all, w["w_router"], w["w_in"], w["w_out"],
                       cfg=cfg)
        y = y[b * x.shape[0]:(b + 1) * x.shape[0], lo:hi]
    else:
        if ep_batch_axes(branch, mesh, gb) != spmd.batch_axes(mesh):
            raise NotImplementedError(
                f"moe ({branch}): the branch splits the batch over "
                f"{ep_batch_axes(branch, mesh, gb)}, the step over "
                f"{spmd.batch_axes(mesh)}")
        if branch == "tp":
            y = _moe_tp(cfg, w, x, mesh, seq)
        else:
            y = _routed(cfg, w, x, mesh, branch)
    if cfg.n_shared_experts:
        tp = spmd.model_split(decl["w_shared_in"], 1, mesh)
        xs = M.enter_replicated(x, mesh, "model") if tp else x
        h = xs @ spmd.param(p, "w_shared_in", decl, mesh).to(x.dtype)
        u, g = torch.chunk(h, 2, dim=-1)     # this rank's [u_r | g_r]
        ys = (u * silu(g)) @ spmd.param(p, "w_shared_out", decl,
                                        mesh).to(x.dtype)
        y = y + (M.reduce_replicated(ys, mesh, "model") if tp else ys)
    return y


def _moe_tp(cfg, w, x, mesh, seq):
    """The routed experts of `moe_spmd` under ``tp``: every rank of
    "model" routes the same tokens (under the sequence split ``seq``,
    its rows' whole sequence, gathered over "model") and runs its E/n
    experts on them.  The collective that closes the layer follows how
    the rows lie over "model": a block of positions takes its block of
    the partial outputs' sum (`mesh.scatter_seq`); rows copied over
    "model" under "fsdp" (a length it does not divide), each copy weighed
    1/n in the backward, sum both ways (`mesh.sum_replicas`), their
    router's gradient parts adding over "model" with the other leaves';
    rows replicated over "model" ("tp") sum (`mesh.reduce_replicated`),
    x's and the router's gradient parts summed over "model" here."""
    r, n = spmd.model_rank(mesh)
    copied = "model" in spmd.profile_batch_axes(mesh)
    router = w["w_router"]
    if seq is not None:
        x = M.gather_seq(x, 1, mesh, seq.axes)
    elif not copied:
        x = M.enter_replicated(x, mesh, "model")
        router = M.enter_replicated(router, mesh, "model")
    y = _moe_local(x, router, w["w_in"], w["w_out"], cfg=cfg, n_ranks=n,
                   rank=r)
    if seq is not None:
        return M.scatter_seq(y, 1, mesh, seq.axes)
    if copied:
        return M.sum_replicas(y, mesh, "model")
    return M.reduce_replicated(y, mesh, "model")


def router_load(cfg, p, x):
    """Expert load histogram (E,) of x (B, S, D): the top-k of a softmax
    taken in the logits' own dtype, as the reference's."""
    logits = x @ p["w_router"].to(x.dtype)
    _, eidx = top_k(softmax(logits), cfg.top_k)
    return _counts(eidx.reshape(-1), cfg.n_experts)


def dropped_pairs(cfg, p, x, *, branch: Optional[str] = None,
                  n_ranks: int = 1, rank: int = 0) -> int:
    """(token, expert) pairs of x (B, S, D) past their expert's capacity:
    the pairs `moe` drops — on one rank, or under ``branch`` the pairs
    this rank (coordinate ``rank`` of ``n_ranks`` on "model") drops from
    its block x: under "tp" those of its own experts, under "a2a" those
    of its own tokens (cap per source rank)."""
    _, eidx = route(cfg, p["w_router"], x.reshape(-1, x.shape[-1]))
    if branch == "a2a":
        dp = dispatch(cfg, eidx, cap=a2a_capacity(cfg, eidx.shape[0]))
        n_ranks = 1
    else:
        dp = dispatch(cfg, eidx, n_ranks=n_ranks, rank=rank)
    mine = dp.sorted_e < cfg.n_experts // n_ranks
    return int((mine & ~dp.valid).sum())


class MoE(ParamTree):
    """The MoE layer's parameters (`moe_decl`) over `moe`."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__(moe_decl(cfg), dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x):
        mesh = spmd.active_mesh()
        if mesh is not None:
            return moe_spmd(self.cfg, self, x, mesh)
        # no mesh, or one of one rank: x is the whole batch
        return moe(self.cfg, self, x, global_batch=x.shape[0])
