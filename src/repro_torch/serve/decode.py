"""Serving path: batched prefill + single-token greedy decode with KV/SSM
caches — counterpart of `repro.serve.decode`, every family: decoders
(`models.transformer.DecoderLM`) and the encoder–decoder
(`models.encdec.EncDecLM`, whose batch carries ``"frames"``).

Eager PyTorch under ``torch.inference_mode``: one host call per op where
the reference jits the step.  The caches' tensors are written in place.

On a sharded model (``mesh=``, `sharding.spmd`) every rank makes the
same call with the same global batch, as the sharded trainer does, under
the model's mesh and profile: the rows split over the largest prefix of
the profile's batch axes that divides the batch and are replicated over
the others (`spmd.rows`), and each rank keeps its block of the caches
(`init_caches` / `init_dec_caches` with the mesh).  Under "fsdp", where
the rows leave "model", a dense or MoE decoder's prefill splits the
prompt's positions over "model" (`transformer.split_length`), each rank
writing the gathered K/V of every position into its cache block, and the
last position's hidden state is taken from the rank that holds it;
decode's one position stays replicated.  ``prefill`` returns
this rank's block of the last position's logits — its rows, and its
block of the vocabulary where "model" splits it ("tp") — and
``serve_step`` the global batch's next tokens on every rank: the greedy
argmax taken over the ranks' vocabulary blocks (each block's largest
logit and its index, the lowest index on a tie, as ``jnp.argmax``), the
rows gathered over the batch axes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Union

import torch

from .. import mesh as M
from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import encdec as encdec_lib
from ..models import transformer as tf
from ..sharding import spmd
from ..sharding.rules import get_seq, mesh_context, profile_context


def _model_device(params) -> torch.device:
    return next(params.parameters()).device


@contextlib.contextmanager
def _sharded(params, rows: int, seq_len=None):
    """The model's mesh (None on one rank) with its profile and the rows
    of a global batch of ``rows`` entered (their ``seq_len`` positions
    split where `spmd.rows` splits them)."""
    mesh = getattr(params, "mesh", None)
    if mesh is None:
        yield None
        return
    with mesh_context(mesh), profile_context(params.profile), \
            spmd.rows(rows, mesh, seq_len):
        yield mesh


def _rows(t: torch.Tensor, mesh):
    """This rank's rows of the global ``t`` (all of them on one rank)."""
    if mesh is None:
        return t
    return M.shard_rows(t, mesh, spmd.batch_axes(mesh))


def make_prefill(cfg: ModelConfig, max_len: int):
    """prefill(params, batch) → (logits (B, 1, V) at the last position,
    caches filled with the prompt).  ``batch``: {"tokens": (B, S),
    optionally "patch_embeds": (B, P, D); the encoder–decoder's also
    "frames": (B, n_frames, D)}; ``params`` the family's model.  On a
    sharded model, this rank's block of the logits and of the caches
    (see the module's docstring)."""

    @torch.inference_mode()
    def prefill(params, batch: Dict[str, torch.Tensor]):
        b = batch["tokens"].shape[0]
        dt = tf.torch_dtype(cfg.compute_dtype)
        with _sharded(params, b, tf.split_length(cfg, batch)) as mesh:
            local = {k: _rows(v, mesh) for k, v in batch.items()}
            tokens = local["tokens"]
            if cfg.family == "encdec":
                enc = encdec_lib.encode(cfg, params, local["frames"])
                caches = encdec_lib.init_dec_caches(cfg, params, enc, b,
                                                    max_len, dt)
                hidden, caches = encdec_lib.decode(cfg, params, tokens,
                                                   None, caches=caches)
            else:
                caches = tf.init_caches(cfg, b, max_len, dt,
                                        _model_device(params), mesh)
                hidden, caches = params(
                    tokens, caches=caches,
                    prefix_embeds=local.get("patch_embeds"))
            last = hidden[:, -1:]
            seq = get_seq() if mesh is not None else None
            if seq is not None:         # the last block's rank holds it
                last = M.all_gather(last, mesh, seq.axes)[-1]
            return _logits(cfg, params, last, mesh), caches
    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, caches, tokens (B,1)) → (next (B,1), caches).
    On a sharded model ``tokens`` and the next tokens are the global
    batch's, the caches this rank's blocks."""

    @torch.inference_mode()
    def serve_step(params, caches, tokens):
        with _sharded(params, tokens.shape[0]) as mesh:
            local = _rows(tokens, mesh)
            if cfg.family == "encdec":
                hidden, caches = encdec_lib.decode(cfg, params, local, None,
                                                   caches=caches)
            else:
                hidden, caches = params(local, caches=caches)
            return greedy(cfg, _logits(cfg, params, hidden, mesh),
                          mesh), caches
    return serve_step


def first_tokens(cfg: ModelConfig, params, logits, rows: int
                 ) -> torch.Tensor:
    """`greedy` of the prefill's ``logits`` for a global batch of
    ``rows``, under ``params``' mesh where it is sharded: the first
    generated tokens (B, 1), the global batch's on every rank."""
    with _sharded(params, rows) as mesh:
        return greedy(cfg, logits, mesh)


def _logits(cfg, params, hidden, mesh=None):
    if mesh is not None:
        return _logits_block(cfg, params, hidden, mesh)
    if cfg.family == "encdec":
        return encdec_lib.logits_fn(cfg, params, hidden)
    return tf.logits_fn(cfg, params, hidden)


def _vocab_block(cfg, mesh) -> tuple:
    """(first column, columns) of this rank's block of the vocabulary:
    its block over "model" where the head's vocabulary dim splits (the
    encoder–decoder's head is its tied table)."""
    tied = cfg.tie_embeddings or cfg.family == "encdec"
    decl = (tf.embed_decl(cfg)["table"] if tied
            else tf._lm_head_decl(cfg)["w"])
    if not spmd.model_split(decl, 0 if tied else 1, mesh):
        return 0, cfg.vocab_padded
    m, n = spmd.model_rank(mesh)
    per = cfg.vocab_padded // n
    return m * per, per


def _logits_block(cfg, params, hidden, mesh):
    """This rank's block of the logits (its rows × `_vocab_block`), the
    padded columns masked as `transformer.logits_fn` masks them."""
    head = tf.sharded_head(cfg, params, mesh)
    tied = cfg.tie_embeddings or cfg.family == "encdec"
    logits = hidden @ (head.to(hidden.dtype).T if tied
                       else head.to(hidden.dtype))
    v0, n = _vocab_block(cfg, mesh)
    if v0 + n > cfg.vocab:
        col = v0 + torch.arange(n, device=logits.device)
        logits = torch.where(col < cfg.vocab, logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=logits.device))
    return logits


def greedy(cfg: ModelConfig, logits, mesh=None) -> torch.Tensor:
    """The argmax over the vocabulary of ``logits`` (B, s, V) → (B, s)
    int32.  With ``mesh`` (a sharded model's), ``logits`` this rank's
    block (`make_prefill`'s): each block's largest logit and its index
    gathered over "model" where the vocabulary splits there, the largest
    taken with the lowest index on a tie (``jnp.argmax``'s), and the
    rows gathered over the batch axes — the global batch's tokens on
    every rank."""
    if mesh is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    v0, n = _vocab_block(cfg, mesh)
    idx = torch.argmax(logits, dim=-1)
    if n != cfg.vocab_padded:
        best = torch.gather(logits, -1, idx[..., None])[..., 0]
        vals = M.all_gather(best.float(), mesh, "model")     # (P, B, s)
        cols = M.all_gather(idx + v0, mesh, "model")
        idx = torch.gather(cols, 0, torch.argmax(vals, 0)[None])[0]
    idx = idx.to(torch.int32)
    axes = spmd.batch_axes(mesh)
    if not axes:
        return idx
    got = M.all_gather(idx, mesh, axes)                      # (P, B_l, s)
    return got.reshape((-1,) + tuple(idx.shape[1:]))


def greedy_generate(cfg: ModelConfig, params, batch, *, max_new: int,
                    max_len: int,
                    device: Union[str, torch.device] = "cuda"
                    ) -> torch.Tensor:
    """Host loop: prefill then greedy decode → (B, max_new) int32 tokens.
    ``params`` (the family's model) lies on ``device``; the batch's
    arrays are moved there.  A sharded model's ranks each make the call
    with the global batch, and each gets the global tokens."""
    dev = resolve_device(device)
    if _model_device(params) != dev:
        raise ValueError(f"greedy_generate: the model lies on "
                         f"{_model_device(params)}, not {dev}")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    prefill = make_prefill(cfg, max_len)
    step = make_serve_step(cfg)
    logits, caches = prefill(params, batch)
    tok = first_tokens(cfg, params, logits, batch["tokens"].shape[0])
    out = [tok]
    for _ in range(max_new - 1):
        tok, caches = step(params, caches, tok)
        out.append(tok)
    return torch.cat(out, dim=1)
