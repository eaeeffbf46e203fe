"""Decoder-LM assembly — counterpart of `repro.models.transformer`.

Layers are grouped into *stages* (`stage_plan`, every family); the
declarations (`decl`) cover every family, so parameter counts match the
reference's.  The model itself, `DecoderLM`, runs the dense family: a
stage is a `Stage` module holding one `Block` per layer, where the
reference scans stacked parameters.  The MoE, SSM and hybrid families
and learned positions are ROADMAP Queue 1 item 3b; ``lm_loss`` comes
with training (item 3c).

Stage layout per family:

  dense : [(block, L)]
  moe   : [(dense_block, first_dense)?, (moe_block, L - first_dense)]
  ssm   : [(mamba, L)]
  hybrid: [(period = ssm_per_period×mamba + 1 shared-attn, n_periods),
           (mamba, tail)]          # zamba2: 13×(5+1) + 3 = 81
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import Attention, KVCache, attention_decl
from .layers import (MLP, Embed, Norm, embed_decl, mlp_decl, norm_decl,
                     rounded)
from .mamba import mamba_decl
from .moe import moe_decl
from .params import ParamTree, PDecl, stack_layers, to_state, tree_init


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


def _require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 3b)")
    if cfg.pos != "rope":
        raise NotImplementedError(
            f"{what}: pos={cfg.pos!r} is not ported yet (ROADMAP Queue 1 "
            f"item 3b)")


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


def decl(cfg: ModelConfig) -> Dict[str, Any]:
    d: Dict[str, Any] = {"embed": embed_decl(cfg),
                         "final_norm": norm_decl(cfg)}
    if not cfg.tie_embeddings:
        d["lm_head"] = _lm_head_decl(cfg)
    if cfg.pos == "learned":
        d["pos_embed"] = {"table": PDecl(
            (cfg.max_target_positions, cfg.d_model), (None, "embed"),
            "embed", scale=cfg.d_model ** -0.5)}
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
                device: Union[str, torch.device] = "cuda") -> List[KVCache]:
    """One `KVCache` per stage of `stage_plan`, stacked over its layers:
    k, v (L, B, max_len, KV, hd) zeros, length 0."""
    _require_dense(cfg, "init_caches")
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [KVCache(torch.zeros((n,) + shape, dtype=dtype, device=dev),
                    torch.zeros((n,) + shape, dtype=dtype, device=dev), 0)
            for _, n in stage_plan(cfg)]


def caches_length(caches) -> int:
    """Current fill position from the first KV cache found (else 0)."""
    for c in caches or ():
        if isinstance(c, KVCache):
            return c.length
    return 0


# --------------------------------------------------------------- modules ---

class Block(nn.Module):
    """Pre-norm attention + MLP block (`_attn_block_decl(cfg, "mlp")`)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = Norm(cfg, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def forward(self, x, cache: Optional[KVCache] = None, positions=None):
        a, new_cache = self.attn(self.ln1(x), causal=True,
                                 positions=positions, cache=cache)
        x = x + a
        x = x + self.mlp(self.ln2(x))
        return x, new_cache


class Stage(nn.Module):
    """``n`` blocks applied in order; its cache is stacked over them."""

    def __init__(self, cfg, n: int, *, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device) for _ in range(n))

    def forward(self, x, cache: Optional[KVCache] = None, positions=None):
        if cache is None:
            for layer in self.layers:
                x, _ = layer(x, None, positions)
            return x, None
        length = cache.length
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, KVCache(cache.k[i], cache.v[i], cache.length),
                          positions)
            length = nc.length
        return x, KVCache(cache.k, cache.v, length)


class DecoderLM(nn.Module):
    """The dense decoder LM.  State-dict keys follow the reference's
    parameter paths, one set per layer (``stages.0.layers.3.attn.wq``):
    `params.from_reference` carries a reference tree across.

    ``generator`` (a `torch.Generator` on ``device``) initializes the
    weights with `tree_init`'s rules; without one they are zeros, to be
    loaded (``load_state_dict``).  The weights take the config's
    ``param_dtype`` and are frozen (this slice serves)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        _require_dense(cfg, "DecoderLM")
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        # with a generator the weights come from tree_init: build the
        # skeleton without storage and take its tensors as they are
        build = torch.device("meta") if generator is not None else dev
        kw = dict(dtype=dtype, device=build)
        self.cfg = cfg
        self.embed = Embed(cfg, **kw)
        self.final_norm = Norm(cfg, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree(_lm_head_decl(cfg), **kw)
        self.stages = nn.ModuleList(Stage(cfg, n, **kw)
                                    for _, n in stage_plan(cfg))
        if generator is not None:
            self.load_state_dict(
                to_state(tree_init(generator, decl(cfg), dtype, dev)),
                assign=True)

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def forward(self, tokens, caches: Optional[List[KVCache]] = None,
                prefix_embeds=None, positions=None):
        """tokens: (B, S) integer ids → hidden (B, S', D), S' = S plus
        the ``prefix_embeds`` (B, P, D) length (VLM stub embeddings
        occupying the first P positions).  With ``caches`` (from
        `init_caches`): decode or cached prefill, returning (hidden, new
        caches)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        x = self.embed(tokens, dt)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dt), x], dim=1)
        if cfg.embed_scale:
            # √d_model rounded to the compute dtype first, as the reference
            x = x * rounded(cfg.d_model ** 0.5, dt)
        decoding = caches is not None
        new_caches = []
        for i, stage in enumerate(self.stages):
            x, nc = stage(x, caches[i] if decoding else None, positions)
            new_caches.append(nc)
        x = self.final_norm(x)
        return (x, new_caches) if decoding else x


# ---------------------------------------------------------------- heads ---

def logits_fn(cfg, params, hidden):
    if cfg.tie_embeddings:
        logits = hidden @ params["embed"]["table"].to(hidden.dtype).T
    else:
        logits = hidden @ params["lm_head"]["w"].to(hidden.dtype)
    if cfg.vocab_padded != cfg.vocab:
        # mask sharding-pad columns so softmax/CE never route mass there
        pad = cfg.vocab_padded - cfg.vocab
        neg = torch.full(logits.shape[:-1] + (pad,), -1e30,
                         dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits[..., :cfg.vocab], neg], dim=-1)
    return logits
