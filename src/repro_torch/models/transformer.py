"""Decoder-LM assembly: dense / MoE / SSM / hybrid families —
counterpart of `repro.models.transformer`.

Layers are grouped into *stages* (`stage_plan`); the model, `DecoderLM`,
holds one module per stage with one block per layer, where the reference
scans stacked parameters.  Stage layout per family:

  dense : [(block, L)]
  moe   : [(dense_block, first_dense)?, (moe_block, L - first_dense)]
  ssm   : [(mamba, L)]
  hybrid: [(period = ssm_per_period×mamba + 1 shared-attn, n_periods),
           (mamba, tail)]          # zamba2: 13×(5+1) + 3 = 81

The hybrid's shared attention block is one parameter set (the model's
``shared_attn``) applied at every period, the paper-accurate weight
tying; each period keeps its own KV cache.

Training (`lm_loss`, and ``cfg.remat``): where the reference scans a
stage under ``jax.checkpoint``, the port recomputes each block (each
hybrid period as one unit) in the backward pass with
``torch.utils.checkpoint`` — when ``cfg.remat`` is set, grad is enabled
and no cache is passed (`remat`).  Decode and prefill run under
``torch.inference_mode`` and are not touched.

Model parallelism (`sharding.spmd`): ``DecoderLM(cfg, …, mesh=)`` holds
this rank's block of every parameter under `tree_pspecs` in the active
profile, and its forward runs under that mesh (`sharding.mesh_context`)
on this rank's rows of the batch: the layers gather their storage dims
and run tensor-parallel where "model" splits their compute dims, the
embedding and `lm_loss` vocab-parallel (the loss the global mean: each
rank's sum over the global token count, summed over the batch axes).
Every decoder family: the Mamba2 mixer is tensor-parallel over its inner
channels and heads (`mamba`), the hybrid's shared attention block
gathers its storage dims at each period that applies it (its gradient
the sum over the periods).  A recomputed block (a hybrid period as one)
re-issues its collectives in the backward, in the same order on every
rank.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import Attention, KVCache, attention_decl, local_kv_heads
from .. import mesh as M
from ..sharding import spmd
from ..sharding.rules import (block_of, constrain, get_mesh, get_profile,
                              get_rows, rows_context,
                              mesh_context, profile_context)
from .layers import (MLP, Embed, Norm, embed_decl, mlp_decl, norm_decl,
                     rounded, vocab_embed)
from .mamba import MambaBlock, MambaCache, init_mamba_cache, mamba_decl
from .moe import MoE, moe_decl
from .params import (ParamTree, PDecl, assign_state, stack_layers, to_state,
                     tree_init, tree_paths, tree_pspecs)


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


# ------------------------------------------------------------ declares ---

def _attn_block_decl(cfg, ffn: str):
    decl = {"ln1": norm_decl(cfg), "attn": attention_decl(cfg),
            "ln2": norm_decl(cfg)}
    if ffn == "moe":
        decl["moe"] = moe_decl(cfg)
    else:
        decl["mlp"] = mlp_decl(cfg)
    return decl


def _mamba_block_decl(cfg):
    return {"ln1": norm_decl(cfg), "mamba": mamba_decl(cfg)}


def stage_plan(cfg: ModelConfig):
    """[(stage_kind, n_repeat)] — drives decls, apply, and cache layout."""
    if cfg.family == "hybrid":
        period = cfg.attn_period                       # mamba per period + 1
        n_periods = cfg.n_layers // (period + 1)
        tail = cfg.n_layers - n_periods * (period + 1)
        plan = [("period", n_periods)]
        if tail:
            plan.append(("mamba", tail))
        return plan
    if cfg.family == "ssm":
        return [("mamba", cfg.n_layers)]
    if cfg.is_moe:
        plan = []
        if cfg.first_dense:
            plan.append(("dense", cfg.first_dense))
        plan.append(("moe", cfg.n_layers - cfg.first_dense))
        return plan
    return [("dense", cfg.n_layers)]


def _lm_head_decl(cfg):
    return {"w": PDecl((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"))}


def _pos_embed_decl(cfg):
    return {"table": PDecl((cfg.max_target_positions, cfg.d_model),
                           (None, "embed"), "embed",
                           scale=cfg.d_model ** -0.5)}


def decl(cfg: ModelConfig) -> Dict[str, Any]:
    d: Dict[str, Any] = {"embed": embed_decl(cfg),
                         "final_norm": norm_decl(cfg)}
    if not cfg.tie_embeddings:
        d["lm_head"] = _lm_head_decl(cfg)
    if cfg.pos == "learned":
        d["pos_embed"] = _pos_embed_decl(cfg)
    stages = []
    for kind, n in stage_plan(cfg):
        if kind == "dense":
            stages.append(stack_layers(
                lambda: _attn_block_decl(cfg, "mlp"), n))
        elif kind == "moe":
            stages.append(stack_layers(
                lambda: _attn_block_decl(cfg, "moe"), n))
        elif kind == "mamba":
            stages.append(stack_layers(lambda: _mamba_block_decl(cfg), n))
        elif kind == "period":
            stages.append({
                "mambas": stack_layers(
                    lambda: stack_layers(
                        lambda: _mamba_block_decl(cfg), cfg.attn_period), n),
            })
    d["stages"] = stages
    if cfg.family == "hybrid":
        d["shared_attn"] = _attn_block_decl(cfg, "mlp")
    return d


# -------------------------------------------------------------- caches ---

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16,
                device: Union[str, torch.device] = "cuda",
                mesh=None) -> list:
    """Per-stage caches matching `stage_plan`, stacked over each stage's
    layers: a `KVCache` (k, v (L, B, max_len, KV, hd) zeros, length 0)
    for attention stages, a `MambaCache` (conv (L, B, W − 1, CH) in
    ``dtype``, ssm (L, B, H, N, P) f32) for mamba stages, and for the
    period stage {"mambas": a `MambaCache` stacked (n_periods,
    attn_period, …), "attn": a `KVCache` stacked over the periods (the
    shared block's one cache a period)}.

    With ``mesh`` (more than one rank, under the rows of a global batch
    of ``batch``: `sharding.spmd.rows`) this rank's blocks: its rows,
    its KV heads (`attention.local_kv_heads`), its Mamba2 channels and
    heads (`mamba.local_dims`)."""
    dev = resolve_device(device)
    kv_heads = cfg.n_kv_heads
    if mesh is not None:
        batch //= spmd.batch_split(mesh)
        kv_heads = local_kv_heads(cfg, mesh)

    def kv(n):
        shape = (n, batch, max_len, kv_heads, cfg.hd)
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev), 0)

    def mb(*n):
        one = init_mamba_cache(cfg, batch, dtype, dev, mesh)
        return MambaCache(*(a.expand(n + a.shape).contiguous() for a in one))

    caches = []
    for kind, n in stage_plan(cfg):
        if kind in ("dense", "moe"):
            caches.append(kv(n))
        elif kind == "mamba":
            caches.append(mb(n))
        else:  # period
            caches.append({"mambas": mb(n, cfg.attn_period), "attn": kv(n)})
    return caches


def _first_kv(tree) -> Optional[KVCache]:
    if isinstance(tree, KVCache):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, list):
        for t in tree:
            kv = _first_kv(t)
            if kv is not None:
                return kv
    return None


def caches_length(caches) -> int:
    """Current fill position from the first KV cache found (else 0),
    searching nested dicts (keys in sorted order) and lists as the
    reference's ``tree_leaves`` does: a hybrid's is its first period's."""
    kv = _first_kv(caches)
    return 0 if kv is None else kv.length


# --------------------------------------------------------------- modules ---

def remat(cfg, cache) -> bool:
    """Whether a layer recomputes its activations in the backward pass:
    ``cfg.remat``, grad enabled and no cache (training, as the
    reference's ``not decoding``)."""
    return cfg.remat and cache is None and torch.is_grad_enabled()


def rematted(fn, x, *args):
    """``fn(x, *args)`` with its activations recomputed in the backward
    pass (``torch.utils.checkpoint``, non-reentrant), under the mesh,
    profile and rows of the forward: the backward of CUDA tensors runs on
    autograd's device thread, which does not see this thread's
    contexts."""
    mesh, profile, rows = get_mesh(), get_profile(), get_rows()

    def run(*a):
        with mesh_context(mesh), profile_context(profile), \
                rows_context(rows) if rows is not None \
                else contextlib.nullcontext():
            return fn(*a)
    return checkpoint(run, x, *args, use_reentrant=False)


class Block(nn.Module):
    """Pre-norm attention + FFN block (`_attn_block_decl`): the FFN an
    MLP (``ffn="mlp"``) or the MoE layer (``ffn="moe"``)."""

    def __init__(self, cfg, ffn: str = "mlp", *, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = Norm(cfg, dtype=dtype, device=device)
        if ffn == "moe":
            self.moe = MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg, dtype=dtype, device=device)

    def forward(self, x, cache: Optional[KVCache] = None, positions=None):
        a, new_cache = self.attn(self.ln1(x), causal=True,
                                 positions=positions, cache=cache)
        x = x + a
        h = self.ln2(x)
        x = x + (self.moe(h) if "moe" in self._modules else self.mlp(h))
        mesh = spmd.active_mesh()
        if mesh is not None:
            x = constrain(x, "batch", "seq", "act_embed", shape=(
                spmd.global_batch(x.shape[0], mesh), x.shape[1],
                x.shape[2]))
        return x, new_cache


def _layer(cache, i):
    """Layer i's slice of a stacked cache (its tensors are views)."""
    if isinstance(cache, KVCache):
        return KVCache(cache.k[i], cache.v[i], cache.length)
    return MambaCache(cache.conv[i], cache.ssm[i])


def _write_back(stacked: MambaCache, i, new: MambaCache) -> None:
    """A mamba layer's new state into its slice of the stacked cache, in
    place (the reference's scan restacks it)."""
    stacked.conv[i].copy_(new.conv)
    stacked.ssm[i].copy_(new.ssm)


class Stage(nn.Module):
    """``n`` attention blocks (FFN ``ffn``) applied in order; its cache is
    a `KVCache` stacked over them."""

    def __init__(self, cfg, n: int, ffn: str = "mlp", *, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, ffn, dtype=dtype, device=device) for _ in range(n))

    def forward(self, x, cache: Optional[KVCache] = None, positions=None):
        if cache is None:
            for layer in self.layers:
                if remat(layer.attn.cfg, None):
                    x = rematted(lambda h, blk=layer: blk(h, None,
                                                          positions)[0], x)
                else:
                    x, _ = layer(x, None, positions)
            return x, None
        length = cache.length
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, _layer(cache, i), positions)
            length = nc.length
        return x, KVCache(cache.k, cache.v, length)


def _run_mambas(blocks, x, cache: Optional[MambaCache]):
    """Mamba blocks in order over a `MambaCache` stacked over them (its
    tensors written in place), or none."""
    for i, block in enumerate(blocks):
        if remat(block.mamba.cfg, cache):
            x = rematted(lambda h, blk=block: blk(h)[0], x)
            continue
        x, nc = block(x, None if cache is None else _layer(cache, i))
        if cache is not None:
            _write_back(cache, i, nc)
    return x


class MambaStage(nn.Module):
    """``n`` Mamba2 blocks; its cache is a `MambaCache` stacked over them."""

    def __init__(self, cfg, n: int, *, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            MambaBlock(cfg, dtype=dtype, device=device) for _ in range(n))

    def forward(self, x, cache: Optional[MambaCache] = None, positions=None):
        return _run_mambas(self.layers, x, cache), cache


class Period(nn.Module):
    """One hybrid period's own parameters: its ``attn_period`` mamba
    blocks (the shared attention block is the model's)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.mambas = nn.ModuleList(
            MambaBlock(cfg, dtype=dtype, device=device)
            for _ in range(cfg.attn_period))


def _period_body(x, period, shared, positions):
    """One hybrid period without a cache: its mamba blocks, then the
    shared attention block."""
    x = _run_mambas(period.mambas, x, None)
    return shared(x, None, positions)[0]


class PeriodStage(nn.Module):
    """The hybrid's ``n`` periods: each runs its mamba blocks, then the
    shared attention block ``shared`` against the period's own KV cache."""

    def __init__(self, cfg, n: int, *, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            Period(cfg, dtype=dtype, device=device) for _ in range(n))

    def forward(self, x, cache: Optional[dict], positions, shared: Block):
        if cache is None:
            for period in self.layers:
                if remat(shared.attn.cfg, None):
                    x = rematted(_period_body, x, period, shared, positions)
                else:
                    x = _period_body(x, period, shared, positions)
            return x, None
        kv = cache["attn"]
        length = kv.length
        for p, period in enumerate(self.layers):
            x = _run_mambas(period.mambas, x, _layer(cache["mambas"], p))
            x, nc = shared(x, _layer(kv, p), positions)
            length = nc.length
        return x, {"mambas": cache["mambas"],
                   "attn": KVCache(kv.k, kv.v, length)}


class DecoderLM(nn.Module):
    """The decoder LM of every decoder family (dense, MoE, SSM, hybrid).
    State-dict keys follow the reference's parameter paths, one set per
    layer (``stages.0.layers.3.attn.wq``; a period's mamba blocks at
    ``stages.0.layers.<period>.mambas.<j>``; the hybrid's
    ``shared_attn``): `params.from_reference` carries a reference tree
    across.

    ``generator`` (a `torch.Generator` on ``device``) initializes the
    weights with `tree_init`'s rules; without one they are zeros, to be
    loaded (``load_state_dict``).  The weights take the config's
    ``param_dtype``, with ``requires_grad`` off until a trainer turns it
    on (`launch.train.build`).

    With ``mesh`` (more than one rank) the model holds this rank's blocks
    under `tree_pspecs` in the active profile, which it records
    (``mesh``, ``profile``): drawn from ``generator`` as the whole tree is
    (each leaf cut as it is drawn), or zeros until `params.assign_state`
    puts blocks in (`params.from_reference` with ``mesh=`` cuts a
    reference tree)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError("DecoderLM: the encoder-decoder family is "
                             "models.encdec.EncDecLM")
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        if mesh is not None and M.mesh_size(mesh) == 1:
            mesh = None
        self.mesh, self.profile = mesh, get_profile()
        # with a generator (or a mesh) the weights come afterwards: build
        # the skeleton without storage and take its tensors as they are
        build = torch.device("meta") if generator is not None \
            or mesh is not None else dev
        kw = dict(dtype=dtype, device=build)
        self.cfg = cfg
        self.embed = Embed(cfg, **kw)
        self.final_norm = Norm(cfg, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree(_lm_head_decl(cfg), **kw)
        if cfg.pos == "learned":
            self.pos_embed = ParamTree(_pos_embed_decl(cfg), **kw)
        stages = []
        for kind, n in stage_plan(cfg):
            if kind in ("dense", "moe"):
                ffn = "moe" if kind == "moe" else "mlp"
                stages.append(Stage(cfg, n, ffn, **kw))
            elif kind == "mamba":
                stages.append(MambaStage(cfg, n, **kw))
            else:
                stages.append(PeriodStage(cfg, n, **kw))
        self.stages = nn.ModuleList(stages)
        if cfg.family == "hybrid":
            self.shared_attn = Block(cfg, "mlp", **kw)
        if mesh is not None:
            assign_state(self, to_state(
                sharded_init(decl(cfg), mesh, generator, dtype, dev)))
        elif generator is not None:
            self.load_state_dict(
                to_state(tree_init(generator, decl(cfg), dtype, dev)),
                assign=True)

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def forward(self, tokens, caches: Optional[list] = None,
                prefix_embeds=None, positions=None, table=None):
        """tokens: (B, S) integer ids → hidden (B, S', D), S' = S plus
        the ``prefix_embeds`` (B, P, D) length (VLM stub embeddings
        occupying the first P positions).  With ``caches`` (from
        `init_caches`): decode or cached prefill, returning (hidden, new
        caches).

        On a sharded model: under its mesh and profile, tokens (and
        ``prefix_embeds``) this rank's rows of the global batch, the
        caches its blocks (`init_caches` with ``mesh``); ``table`` the
        embedding table already gathered (`sharded_head`, shared with
        the tied loss: one gradient, one reduce-scatter)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        mesh = check_model_mesh(self)
        if mesh is not None:
            if table is None:
                table = spmd.param(self.embed, "table", embed_decl(cfg),
                                   mesh)
            x = vocab_embed(cfg, table, tokens, dt, mesh)
        else:
            x = self.embed(tokens, dt)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dt), x], dim=1)
        if cfg.embed_scale:
            # √d_model rounded to the compute dtype first, as the reference
            x = x * rounded(cfg.d_model ** 0.5, dt)
        if cfg.pos == "learned":
            base = caches_length(caches) if caches is not None else 0
            table = self.pos_embed.table
            pos = torch.clamp(base + torch.arange(x.shape[1],
                                                  device=x.device),
                              max=table.shape[0] - 1)
            if mesh is not None:
                table = spmd.param(self.pos_embed, "table",
                                   _pos_embed_decl(cfg), mesh)
            x = x + table[pos].to(dt)[None]
        if mesh is not None:
            x = constrain(x, "batch", "seq", "act_embed", shape=(
                spmd.global_batch(x.shape[0], mesh), x.shape[1],
                x.shape[2]))
        decoding = caches is not None
        new_caches = []
        for i, stage in enumerate(self.stages):
            cache = caches[i] if decoding else None
            if isinstance(stage, PeriodStage):
                x, nc = stage(x, cache, positions, self.shared_attn)
            else:
                x, nc = stage(x, cache, positions)
            new_caches.append(nc)
        x = self.final_norm(x)
        return (x, new_caches) if decoding else x


def check_model_mesh(model):
    """The active mesh of more than one rank, checked against the one
    ``model`` is sharded over (and the profile it was cut under)."""
    name = type(model).__name__
    mesh = spmd.active_mesh()
    if mesh is not model.mesh:
        raise RuntimeError(
            f"{name} sharded over {model.mesh!r} run under the mesh "
            f"{mesh!r}: enter its mesh_context (and only its)")
    if mesh is not None:
        if get_profile() != model.profile:
            raise RuntimeError(f"{name} cut under the {model.profile!r} "
                               f"profile run under {get_profile()!r}")
    return mesh


def sharded_init(tree, mesh, generator, dtype, dev):
    """This rank's blocks of the declaration ``tree`` on ``mesh`` under
    the active profile (reference layout): drawn leaf by leaf as
    `tree_init` draws the whole tree, each cut at once
    (`sharding.block_of`); zeros of the blocks' shapes without a
    generator (no leaf made whole)."""
    rank = torch.distributed.get_rank()
    cuts = iter(tree_paths(tree_pspecs(tree, mesh)).values())  # its order

    def cut(d, t):
        return block_of(t, next(cuts), mesh, rank).clone()
    if generator is not None:
        return tree_init(generator, tree, dtype, dev, cut=cut)
    return tree_init(None, _blocks(tree, mesh, rank), dtype, dev)


def _blocks(tree, mesh, rank):
    """The declaration tree with every leaf "zeros" of ``rank``'s block
    shape under ``mesh`` (`sharding.block_of` of a meta tensor)."""
    specs = iter(tree_paths(tree_pspecs(tree, mesh)).values())

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(t) for t in node)
        shape = block_of(torch.empty(node.shape, device="meta"),
                         next(specs), mesh, rank).shape
        return PDecl(tuple(shape), node.logical, "zeros", node.scale,
                     node.gated)
    return walk(tree)


# ---------------------------------------------------------------- heads ---

def head_weight(cfg, params) -> torch.Tensor:
    """The output projection: the embedding table (V, D) when tied, else
    ``lm_head.w`` (D, V)."""
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"]["w"])


def logits_fn(cfg, params, hidden):
    return _logits(cfg, head_weight(cfg, params), hidden)


def _head_decl(cfg):
    return (embed_decl(cfg)["table"] if cfg.tie_embeddings
            else _lm_head_decl(cfg)["w"])


def sharded_head(cfg, params, mesh):
    """This rank's block of the output projection with its storage dim
    gathered (`spmd.param`): the (tied) table (V_r, D) or ``lm_head.w``
    (D, V_r), V_r the rank's vocabulary block where "model" splits it."""
    if cfg.tie_embeddings:
        return spmd.param(params["embed"], "table", embed_decl(cfg), mesh)
    return spmd.param(params["lm_head"], "w", _lm_head_decl(cfg), mesh)


def _logits(cfg, head, hidden):
    if cfg.tie_embeddings:
        logits = hidden @ head.to(hidden.dtype).T
    else:
        logits = hidden @ head.to(hidden.dtype)
    if cfg.vocab_padded != cfg.vocab:
        # mask sharding-pad columns so softmax/CE never route mass there
        pad = cfg.vocab_padded - cfg.vocab
        neg = torch.full(logits.shape[:-1] + (pad,), -1e30,
                         dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits[..., :cfg.vocab], neg], dim=-1)
    return logits


def _chunk_nll(cfg, head, hidden, labels):
    """Σ (logsumexp − gold logit) over one chunk, in f32."""
    logits = _logits(cfg, head, hidden).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def _chunk_nll_vp(cfg, head, hidden, labels, mesh):
    """`_chunk_nll` with the vocabulary split over "model": this rank's
    logits are its block of columns; the max and the sum of exponentials
    are taken over the ranks' blocks (the max with no gradient, as
    logsumexp's shift), the gold logit from the rank that owns it."""
    logits = (hidden @ head.to(hidden.dtype).T if cfg.tie_embeddings
              else hidden @ head.to(hidden.dtype))
    n = logits.shape[-1]
    v0 = spmd.model_rank(mesh)[0] * n
    col = v0 + torch.arange(n, device=logits.device)
    logits = torch.where(col < cfg.vocab, logits,
                         torch.full((), -1e30, dtype=logits.dtype,
                                    device=logits.device))
    logits = logits.to(torch.float32)
    top = M.all_gather(logits.detach().amax(-1), mesh, "model").amax(0)
    sumexp = torch.exp(logits - top[..., None]).sum(-1)
    logz = top + torch.log(M.reduce_replicated(sumexp, mesh, "model"))
    local = labels.long() - v0
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None]
                        )[..., 0]
    gold = M.reduce_replicated(torch.where(mine, gold, 0.0), mesh, "model")
    return torch.sum(logz - gold)


def lm_loss(cfg: ModelConfig, params, hidden, labels, head=None):
    """Chunked-over-sequence vocab cross-entropy: the mean over the
    (B, S) tokens, the sequence cut into chunks of ``cfg.loss_chunk``
    positions (lowered until it divides S, as the reference).  Under
    grad each chunk's logits are recomputed in the backward pass
    (``torch.utils.checkpoint``), so the (B, S, V) f32 logits and their
    softmax never materialize: one chunk's at a time.

    Under a mesh of more than one rank, hidden and labels are this rank's
    rows, ``head`` the gathered projection (`sharded_head`; gathered here
    if not given); where "model" splits the vocabulary each chunk's loss
    is vocab-parallel (`_chunk_nll_vp`, its collectives recomputed with
    it).  The result is the global mean on every rank: this rank's sum
    over the global token count, summed over the batch axes."""
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk, s)
    while s % chunk:
        chunk -= 1
    mesh = spmd.active_mesh()
    nll = _chunk_nll
    args = ()
    if mesh is None:
        head = head_weight(cfg, params)
    else:
        head = sharded_head(cfg, params, mesh) if head is None else head
        if spmd.model_split(_head_decl(cfg), 0 if cfg.tie_embeddings else 1,
                            mesh):
            hidden = M.enter_replicated(hidden, mesh, "model")
            nll, args = _chunk_nll_vp, (mesh,)
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        total = total + (checkpoint(nll, cfg, head, h, y, *args,
                                    use_reentrant=False) if grad
                         else nll(cfg, head, h, y, *args))
    if mesh is None:
        return total / (b * s)
    return M.reduce_replicated(total / (spmd.global_batch(b, mesh) * s),
                               mesh, spmd.batch_axes(mesh))
