"""Encoder–decoder backbone (whisper-medium family) — counterpart of
`repro.models.encdec`.

The audio conv front end is a stub, as in the reference: the caller
supplies precomputed frame embeddings (B, n_frames, D).  Encoder =
bidirectional attention blocks; decoder = causal self-attention +
cross-attention blocks with learned positions.  Cross-attention K/V are
computed once at prefill (`init_dec_caches`) and carried in the cache.
The functions take an `EncDecLM` (or anything that reads like it).
Under grad with ``cfg.remat`` (training) each encoder and decoder block
is recomputed in the backward pass, as the reference's
``jax.checkpoint``'ed bodies.

Model parallelism (`sharding.spmd`): ``EncDecLM(cfg, …, mesh=)`` holds
this rank's block of every parameter under `tree_pspecs` in the active
profile, and `encode` / `decode` run under that mesh on this rank's rows
of the batch (frames and tokens alike), in training and in serving
(`init_dec_caches` gives each rank its blocks of the caches): the position
tables gathered over their storage dim, the encoder's bidirectional and
the decoder's causal self-attention and its cross-attention
tensor-parallel where "model" splits the heads (`attention`), the
embedding vocab-parallel and shared with the tied loss
(`transformer.sharded_head`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .. import mesh as M
from ..sharding import spmd
from ..sharding.rules import constrain, get_profile
from .attention import (Attention, KVCache, attention, attention_decl,
                        attention_with_kv, cross_kv, local_kv_heads)
from .layers import (MLP, Embed, Norm, embed_decl, mlp_decl, norm, norm_decl,
                     vocab_embed)
from .params import (ParamTree, PDecl, assign_state, stack_layers, to_state,
                     tree_init)
from .transformer import check_model_mesh, remat, rematted, sharded_init


def _enc_block_decl(cfg):
    return {"ln1": norm_decl(cfg), "attn": attention_decl(cfg),
            "ln2": norm_decl(cfg), "mlp": mlp_decl(cfg)}


def _dec_block_decl(cfg):
    return {"ln1": norm_decl(cfg), "self_attn": attention_decl(cfg),
            "ln2": norm_decl(cfg), "cross_attn": attention_decl(cfg),
            "ln3": norm_decl(cfg), "mlp": mlp_decl(cfg)}


def _pos_decl(cfg, n: int):
    return {"table": PDecl((n, cfg.d_model), (None, "embed"), "embed",
                           scale=cfg.d_model ** -0.5)}


def decl(cfg):
    return {
        "embed": embed_decl(cfg),
        "dec_pos": _pos_decl(cfg, cfg.max_target_positions),
        "enc_pos": _pos_decl(cfg, cfg.n_frames),
        "enc_blocks": stack_layers(lambda: _enc_block_decl(cfg),
                                   cfg.n_enc_layers),
        "dec_blocks": stack_layers(lambda: _dec_block_decl(cfg),
                                   cfg.n_layers),
        "enc_norm": norm_decl(cfg),
        "final_norm": norm_decl(cfg),
    }


class DecCache(NamedTuple):
    """The decoder's caches, stacked over its layers: ``self_kv`` a
    `KVCache` (L, B, max_len, KV, hd); ``cross_k`` / ``cross_v`` (L, B,
    S_enc, KV, hd)."""
    self_kv: KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _act(x, mesh):
    """``x`` (B_loc, S, D) checked to be this rank's rows, D whole."""
    if mesh is None:
        return x
    return constrain(x, "batch", "seq", "act_embed", shape=(
        spmd.global_batch(x.shape[0], mesh), x.shape[1], x.shape[2]))


def _pos_table(cfg, params, name: str, n: int, mesh):
    """A learned position table, its storage dim gathered on a mesh."""
    if mesh is None:
        return params[name].table
    return spmd.param(params[name], "table", _pos_decl(cfg, n), mesh)


def encode(cfg: ModelConfig, params, frames):
    """frames: (B, n_frames, D) stub embeddings → encoder states."""
    dt = _dtype(cfg)
    mesh = check_model_mesh(params)
    x = frames.to(dt)
    table = _pos_table(cfg, params, "enc_pos", cfg.n_frames, mesh)
    x = _act(x + table[:x.shape[1]].to(dt)[None], mesh)
    for p in params.enc_blocks:
        x = (rematted(_enc_block, x, cfg, p) if remat(cfg, None)
             else _enc_block(x, cfg, p))
    return norm(cfg, params.enc_norm, x)


def _enc_block(x, cfg, p):
    a, _ = attention(cfg, p.attn, norm(cfg, p.ln1, x), causal=False)
    x = x + a
    return x + p.mlp(norm(cfg, p.ln2, x))


def _dec_block(cfg, p, x, enc, cache: Optional[DecCache]):
    h = norm(cfg, p.ln1, x)
    a, new_kv = attention(cfg, p.self_attn, h, causal=True,
                          cache=cache.self_kv if cache is not None else None)
    x = x + a
    h = norm(cfg, p.ln2, x)
    if cache is not None:   # decode: precomputed cross K/V
        ca = attention_with_kv(cfg, p.cross_attn, h, cache.cross_k,
                               cache.cross_v)
    else:
        ca, _ = attention(cfg, p.cross_attn, h, causal=False, kv_input=enc)
    x = x + ca
    x = x + p.mlp(norm(cfg, p.ln3, x))
    x = _act(x, spmd.active_mesh())
    new_cache = (DecCache(new_kv, cache.cross_k, cache.cross_v)
                 if cache is not None else None)
    return x, new_cache


def decode(cfg: ModelConfig, params, tokens, enc, *,
           caches: Optional[DecCache] = None, table=None):
    """Decoder forward.  Returns hidden (without caches; ``enc`` the
    encoder states) or (hidden, caches) (with caches from
    `init_dec_caches`; ``enc`` unused).  On a sharded model ``table`` is
    the embedding table already gathered (`transformer.sharded_head`,
    shared with the tied loss), or None to gather it here."""
    dt = _dtype(cfg)
    mesh = check_model_mesh(params)
    if mesh is None:
        x = params.embed(tokens, dt)
    else:
        if table is None:
            table = spmd.param(params.embed, "table", embed_decl(cfg), mesh)
        x = vocab_embed(cfg, table, tokens, dt, mesh)
    base = caches.self_kv.length if caches is not None else 0
    pos_table = _pos_table(cfg, params, "dec_pos", cfg.max_target_positions,
                           mesh)
    pos = torch.clamp(base + torch.arange(x.shape[1], device=x.device),
                      max=pos_table.shape[0] - 1)
    x = _act(x + pos_table[pos].to(dt)[None], mesh)

    if caches is None:
        for p in params.dec_blocks:
            if remat(cfg, None):
                x = rematted(lambda h, e, blk=p: _dec_block(
                    cfg, blk, h, e, None)[0], x, enc)
            else:
                x, _ = _dec_block(cfg, p, x, enc, None)
        return norm(cfg, params.final_norm, x)
    kv = caches.self_kv
    length = kv.length
    for l, p in enumerate(params.dec_blocks):
        c = DecCache(KVCache(kv.k[l], kv.v[l], kv.length), caches.cross_k[l],
                     caches.cross_v[l])
        x, nc = _dec_block(cfg, p, x, None, c)
        length = nc.self_kv.length
    x = norm(cfg, params.final_norm, x)
    return x, DecCache(KVCache(kv.k, kv.v, length), caches.cross_k,
                       caches.cross_v)


def init_dec_caches(cfg: ModelConfig, params, enc, batch: int,
                    max_len: int, dtype=torch.bfloat16) -> DecCache:
    """Stacked cross K/V projected from the encoder states (no bias, in
    the states' dtype, then cast to ``dtype``) and empty self caches, on
    the states' device.  On a sharded model (under its mesh, ``enc``
    this rank's rows of a global batch of ``batch``) this rank's blocks:
    its rows and KV heads (`attention.local_kv_heads`)."""
    mesh = check_model_mesh(params)
    kv_heads = local_kv_heads(cfg, mesh)
    if mesh is not None:
        batch //= spmd.batch_split(mesh)
    cross = [cross_kv(cfg, p.cross_attn, enc) for p in params.dec_blocks]
    ck = torch.stack([k.to(dtype) for k, _ in cross])
    cv = torch.stack([v.to(dtype) for _, v in cross])
    shape = (cfg.n_layers, batch, max_len, kv_heads, cfg.hd)
    self_kv = KVCache(torch.zeros(shape, dtype=dtype, device=enc.device),
                      torch.zeros(shape, dtype=dtype, device=enc.device), 0)
    return DecCache(self_kv, ck, cv)


def logits_fn(cfg, params, hidden):
    logits = hidden @ params["embed"]["table"].to(hidden.dtype).T
    if cfg.vocab_padded != cfg.vocab:
        pad = cfg.vocab_padded - cfg.vocab
        neg = torch.full(logits.shape[:-1] + (pad,), -1e30,
                         dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits[..., :cfg.vocab], neg], dim=-1)
    return logits


# --------------------------------------------------------------- modules ---

class EncBlock(nn.Module):
    """Bidirectional attention + MLP block (`_enc_block_decl`)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = Norm(cfg, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)


class DecBlock(nn.Module):
    """Causal self-attention + cross-attention + MLP block
    (`_dec_block_decl`)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg, dtype=dtype, device=device)
        self.self_attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = Norm(cfg, dtype=dtype, device=device)
        self.cross_attn = Attention(cfg, dtype=dtype, device=device)
        self.ln3 = Norm(cfg, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)


class EncDecLM(nn.Module):
    """The encoder–decoder LM.  State-dict keys follow the reference's
    parameter paths, one set per layer (``enc_blocks.3.attn.wq``,
    ``dec_blocks.0.cross_attn.wk``): `params.from_reference` carries a
    reference tree across.  ``generator`` and ``device`` as in
    `transformer.DecoderLM`; ``requires_grad`` off until a trainer
    turns it on.  With ``mesh`` (more than one rank) the model holds this
    rank's blocks under the active profile, as a sharded
    `transformer.DecoderLM` does (``mesh``, ``profile``)."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM: the {cfg.family!r} family is "
                             f"transformer.DecoderLM")
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.param_dtype)
        if mesh is not None and M.mesh_size(mesh) == 1:
            mesh = None
        self.mesh, self.profile = mesh, get_profile()
        build = torch.device("meta") if generator is not None \
            or mesh is not None else dev
        kw = dict(dtype=dtype, device=build)
        self.cfg = cfg
        self.embed = Embed(cfg, **kw)
        self.dec_pos = ParamTree(_pos_decl(cfg, cfg.max_target_positions),
                                 **kw)
        self.enc_pos = ParamTree(_pos_decl(cfg, cfg.n_frames), **kw)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, **kw) for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.enc_norm = Norm(cfg, **kw)
        self.final_norm = Norm(cfg, **kw)
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

    def encode(self, frames):
        return encode(self.cfg, self, frames)

    def forward(self, tokens, enc=None, caches: Optional[DecCache] = None):
        """`decode`: hidden over ``tokens`` against the encoder states
        ``enc`` (B, S_enc, D), or (hidden, caches) with ``caches``."""
        return decode(self.cfg, self, tokens, enc, caches=caches)
