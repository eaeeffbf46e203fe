"""Meta-tensor stand-ins and placements for every (arch × shape) cell —
counterpart of `repro.launch.specs`.

Nothing here allocates: the abstract trees are ``meta`` tensors in the
reference's layout (its leaves, its nesting: ``stages`` a list, a
`KVCache`'s ``length`` a stacked int32 leaf), so the 1T kimi-k2 cell
builds on any host.  Placements are plain tuples (`sharding.rules`),
one tree per abstract tree, under the active profile.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..mesh import axis_sizes
from ..models.attention import KVCache, cache_logical, init_cache
from ..models.encdec import DecCache
from ..models.mamba import MambaCache, init_mamba_cache
from ..models.params import PDecl, nest, tree_abstract, tree_paths, \
    tree_pspecs
from ..models.transformer import stage_plan, torch_dtype
from ..optim import Optimizer
from ..sharding import spmd
from ..sharding.rules import Paired, logical_to_spec, map_leaves, pspec
from ..train.step import TrainState, model_decl

__all__ = ["batch_axes_for", "model_decl", "abstract_params",
           "param_pspecs", "opt_pspecs", "train_state_pspecs",
           "abstract_train_state", "batch_inputs", "batch_pspecs",
           "abstract_caches", "cache_pspecs", "decode_inputs",
           "optimizer_name", "rank_blocks", "block_bytes", "step_arguments"]

META = torch.device("meta")


def batch_axes_for(b: int, mesh) -> Tuple[str, ...]:
    """Largest prefix of the active profile's batch axes whose product
    divides the batch (tp: (pod,data); fsdp: (pod,data,model)):
    `sharding.spmd.rows_axes`, the axes the sharded LM splits its rows
    over."""
    return spmd.rows_axes(b, mesh)


def _bspec(b: int, mesh, *trailing) -> tuple:
    axes = batch_axes_for(b, mesh)
    return pspec(axes if axes else None, *trailing)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def optimizer_name(cfg: ModelConfig) -> str:
    """The dry run's optimizer: Adafactor for the 1T config (factored
    states), AdamW for the rest."""
    return "adafactor" if cfg.name.startswith("kimi") else "adamw"


def abstract_params(cfg: ModelConfig):
    return tree_abstract(model_decl(cfg), torch_dtype(cfg.param_dtype))


def param_pspecs(cfg: ModelConfig, mesh):
    return tree_pspecs(model_decl(cfg), mesh)


def _zip_map(fn, decl, specs):
    if isinstance(decl, PDecl):
        return fn(decl, specs)
    if isinstance(decl, dict):
        return {k: _zip_map(fn, decl[k], specs[k]) for k in sorted(decl)}
    return [_zip_map(fn, d, s) for d, s in zip(decl, specs)]


def opt_pspecs(cfg: ModelConfig, optimizer_name: str, mesh):
    pspecs = param_pspecs(cfg, mesh)
    if optimizer_name == "adamw":
        return {"mu": pspecs, "nu": pspecs, "count": ()}
    if optimizer_name == "adafactor":
        def one(d, spec):
            parts = list(spec) + [None] * (len(d.shape) - len(spec))
            if len(d.shape) >= 2:
                vc = pspec(*(parts[:-2] + parts[-1:]))
                # a gated leaf's column statistics pair as its columns
                return {"vr": pspec(*parts[:-1]),
                        "vc": Paired(vc) if isinstance(spec, Paired)
                        else vc}
            v = pspec(*parts)
            return {"v": Paired(v) if isinstance(spec, Paired) else v}
        return {"m": _zip_map(one, model_decl(cfg), pspecs), "count": ()}
    raise ValueError(optimizer_name)


def train_state_pspecs(cfg: ModelConfig, optimizer_name: str, mesh):
    return TrainState(param_pspecs(cfg, mesh),
                      opt_pspecs(cfg, optimizer_name, mesh), ())


def abstract_train_state(cfg: ModelConfig, optimizer: Optimizer
                         ) -> TrainState:
    """The train state's ``meta`` tensors in the reference's layout:
    (params, opt_state, step), ``optimizer.init`` run on the abstract
    leaves (the port's optimizers hold a list of parts a leaf; here each
    leaf is its one part)."""
    params = abstract_params(cfg)
    state = optimizer.init(tree_paths(params))
    opt: Dict[str, Any] = {}
    for key, val in state.items():
        if key == "count":
            opt[key] = _meta(val.shape, val.dtype)
        elif key == "m":
            opt[key] = nest(val)
        else:
            opt[key] = nest({p: parts[0] for p, parts in val.items()})
    return TrainState(params, opt, _meta((), torch.int32))


# ----------------------------------------------------------- batches -----

def batch_inputs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Abstract model inputs for a train/prefill cell."""
    b, s = cell.global_batch, cell.seq_len
    dt = torch_dtype(cfg.compute_dtype)

    def tok(n):
        return _meta((b, n), torch.int32)
    if cfg.family == "encdec":
        return {"frames": _meta((b, cfg.n_frames, cfg.d_model), dt),
                "tokens": tok(s), "labels": tok(s)}
    if cfg.n_patches:
        return {"patch_embeds": _meta((b, cfg.n_patches, cfg.d_model), dt),
                "tokens": tok(s - cfg.n_patches),
                "labels": tok(s - cfg.n_patches)}
    return {"tokens": tok(s), "labels": tok(s)}


def batch_pspecs(cfg: ModelConfig, cell: ShapeCell, mesh):
    b = cell.global_batch
    out = {"tokens": _bspec(b, mesh, None), "labels": _bspec(b, mesh, None)}
    if cfg.family == "encdec":
        out["frames"] = _bspec(b, mesh, None, None)
    if cfg.n_patches:
        out["patch_embeds"] = _bspec(b, mesh, None, None)
    return out


# ------------------------------------------------------------ caches -----

def abstract_caches(cfg: ModelConfig, batch: int, max_len: int):
    """The caches' ``meta`` tensors: `transformer.init_caches`' stacked
    per-stage caches (`encdec.init_dec_caches`' `DecCache` for the
    encoder–decoder), each `KVCache` ``length`` an int32 leaf of its
    stack's layers, as the reference's."""
    dt = torch_dtype(cfg.compute_dtype)

    def stacked(a, n):
        return _meta(n + tuple(a.shape), a.dtype)

    def kv(*n):
        one = init_cache(cfg, batch, max_len, dt, device=META)
        return KVCache(stacked(one.k, n), stacked(one.v, n),
                       _meta(n, torch.int32))

    def mb(*n):
        return MambaCache(*(stacked(a, n) for a in
                            init_mamba_cache(cfg, batch, dt, device=META)))

    if cfg.family == "encdec":
        cross = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
        return DecCache(kv(cfg.n_layers), _meta(cross, dt), _meta(cross, dt))
    caches = []
    for kind, n in stage_plan(cfg):
        if kind in ("dense", "moe"):
            caches.append(kv(n))
        elif kind == "mamba":
            caches.append(mb(n))
        else:  # period
            caches.append({"mambas": mb(n, cfg.attn_period), "attn": kv(n)})
    return caches


def cache_pspecs(cfg: ModelConfig, caches_abstract, batch: int, mesh):
    """Placement tree matching the cache tree: KV (B,S,KV,hd) per
    cache_logical; SSM conv (B,W,CH) / state (B,H,N,P); leading stacked
    layer axes replicated; lengths replicated.  Leaves are recognised
    by their shape, as the reference's."""
    model_size = axis_sizes(mesh).get("model", 1)
    kv_logical = cache_logical(cfg, model_size)
    baxes = batch_axes_for(batch, mesh)
    bspec = pspec(baxes)[0] if baxes else None

    def spec_for(leaf: torch.Tensor):
        shp = tuple(leaf.shape)
        nd = len(shp)
        if nd == 0 or shp[-1] == 0:
            return ()
        kv, hd = cfg.n_kv_heads, cfg.hd
        di = cfg.ssm_expand * cfg.d_model
        h_ssm = di // cfg.ssm_head_dim if cfg.ssm_head_dim else 0
        # KV cache leaf: (..., B, S, KV, hd)
        if nd >= 4 and shp[-2:] == (kv, hd) and shp[-4] == batch:
            lead = [None] * (nd - 4)
            kvspec = logical_to_spec(kv_logical, mesh)
            return pspec(*(lead + [bspec] + list(kvspec[1:])))
        # SSM state leaf: (..., B, H, N, Pdim)
        if nd >= 4 and h_ssm and shp[-3:] == (h_ssm, cfg.ssm_state,
                                              cfg.ssm_head_dim) \
                and shp[-4] == batch:
            lead = [None] * (nd - 4)
            return pspec(*(lead + [bspec, "model" if h_ssm % model_size == 0
                                   else None, None, None]))
        # conv state leaf: (..., B, W-1, CH)
        if nd >= 3 and shp[-2] == cfg.ssm_conv - 1 and shp[-3] == batch:
            lead = [None] * (nd - 3)
            ch = shp[-1]
            return pspec(*(lead + [bspec, None,
                                   "model" if ch % model_size == 0
                                   else None]))
        # lengths stacked (L,) etc.
        return pspec(*([None] * nd))

    return map_leaves(spec_for, caches_abstract)


def decode_inputs(cfg: ModelConfig, cell: ShapeCell):
    """(caches_abstract, tokens_abstract) for a decode cell — cache is
    prefilled to seq_len, serve_step adds 1 token."""
    b = cell.global_batch
    return (abstract_caches(cfg, b, cell.seq_len),
            _meta((b, 1), torch.int32))


# ------------------------------------------------------ a rank's blocks --

def _zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and its placement tree
    (a NamedTuple's fields, dicts by key, lists in order)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_specs(fn, t, s)
                            for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_specs(fn, t, s) for t, s in zip(tree, specs))
    return tree


def rank_blocks(tree, specs, mesh, rank: int = 0):
    """Each ``meta`` leaf of ``tree`` cut to the block ``rank`` holds
    under its placement in ``specs`` (`sharding.local_block`; a `Paired`
    leaf's block is as large): the rank's arguments, as ``meta``
    tensors."""
    from ..sharding.rules import local_block
    return _zip_specs(lambda t, sp: local_block(t, sp, mesh, rank),
                      tree, specs)


def block_bytes(tree) -> int:
    """Bytes of the tensors of a tree (each leaf's own size)."""
    total = []
    map_leaves(lambda t: total.append(t.numel() * t.element_size()), tree)
    return int(sum(total))


def step_arguments(cfg: ModelConfig, cell: ShapeCell, mesh,
                   rank: int = 0) -> Dict[str, Any]:
    """The blocks ``rank`` holds of the arguments of the cell's step, as
    ``meta`` tensors under the reference's placements in the active
    profile: {"state" (train: params, optimizer state, step) or
    "params", "batch" (train, prefill: without labels), "caches" and
    "tokens" (decode)} — what the reference's ``memory_analysis``
    counts as a device's arguments.  The encoder–decoder's decode step
    reads no encoder parameter, nor the cross-attention's ``wk`` / ``wv``
    (its K/V are cached): they are left out, as the reference's
    ``jax.jit`` prunes arguments its program does not use."""
    opt_name = optimizer_name(cfg)
    out: Dict[str, Any] = {}
    if cell.kind == "train":
        from ..optim.optimizers import make as make_opt
        state = abstract_train_state(cfg, make_opt(opt_name))
        out["state"] = rank_blocks(
            state, train_state_pspecs(cfg, opt_name, mesh), mesh, rank)
    else:
        params = rank_blocks(abstract_params(cfg), param_pspecs(cfg, mesh),
                             mesh, rank)
        if cfg.family == "encdec" and cell.kind == "decode":
            params = {k: v for k, v in params.items()
                      if not k.startswith("enc_")}
            cross = dict(params["dec_blocks"]["cross_attn"])
            del cross["wk"], cross["wv"]
            params["dec_blocks"] = {**params["dec_blocks"],
                                    "cross_attn": cross}
        out["params"] = params
    if cell.kind in ("train", "prefill"):
        batch = batch_inputs(cfg, cell)
        specs = batch_pspecs(cfg, cell, mesh)
        if cell.kind == "prefill":
            batch.pop("labels")
            specs.pop("labels")
        out["batch"] = rank_blocks(batch, specs, mesh, rank)
    else:
        caches, tokens = decode_inputs(cfg, cell)
        out["caches"] = rank_blocks(
            caches, cache_pspecs(cfg, caches, cell.global_batch, mesh),
            mesh, rank)
        out["tokens"] = rank_blocks(
            tokens, _bspec(cell.global_batch, mesh, None), mesh, rank)
    return out
