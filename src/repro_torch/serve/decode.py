"""Serving path: batched prefill + single-token greedy decode with KV/SSM
caches — counterpart of `repro.serve.decode`, every family: decoders
(`models.transformer.DecoderLM`) and the encoder–decoder
(`models.encdec.EncDecLM`, whose batch carries ``"frames"``).

Eager PyTorch under ``torch.inference_mode``: one host call per op where
the reference jits the step.  The caches' tensors are written in place.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import encdec as encdec_lib
from ..models import transformer as tf


def _model_device(params) -> torch.device:
    return next(params.parameters()).device


def make_prefill(cfg: ModelConfig, max_len: int):
    """prefill(params, batch) → (logits (B, 1, V) at the last position,
    caches filled with the prompt).  ``batch``: {"tokens": (B, S),
    optionally "patch_embeds": (B, P, D); the encoder–decoder's also
    "frames": (B, n_frames, D)}; ``params`` the family's model."""

    @torch.inference_mode()
    def prefill(params, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        dt = tf.torch_dtype(cfg.compute_dtype)
        if cfg.family == "encdec":
            enc = encdec_lib.encode(cfg, params, batch["frames"])
            caches = encdec_lib.init_dec_caches(cfg, params, enc, b,
                                                max_len, dt)
            hidden, caches = encdec_lib.decode(cfg, params, tokens, None,
                                               caches=caches)
        else:
            caches = tf.init_caches(cfg, b, max_len, dt,
                                    _model_device(params))
            hidden, caches = params(tokens, caches=caches,
                                    prefix_embeds=batch.get("patch_embeds"))
        return _logits(cfg, params, hidden[:, -1:]), caches
    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, caches, tokens (B,1)) → (next (B,1), caches)."""

    @torch.inference_mode()
    def serve_step(params, caches, tokens):
        if cfg.family == "encdec":
            hidden, caches = encdec_lib.decode(cfg, params, tokens, None,
                                               caches=caches)
        else:
            hidden, caches = params(tokens, caches=caches)
        logits = _logits(cfg, params, hidden)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches
    return serve_step


def _logits(cfg, params, hidden):
    if cfg.family == "encdec":
        return encdec_lib.logits_fn(cfg, params, hidden)
    return tf.logits_fn(cfg, params, hidden)


def greedy_generate(cfg: ModelConfig, params, batch, *, max_new: int,
                    max_len: int,
                    device: Union[str, torch.device] = "cuda"
                    ) -> torch.Tensor:
    """Host loop: prefill then greedy decode → (B, max_new) int32 tokens.
    ``params`` (the family's model) lies on ``device``; the batch's
    arrays are moved there."""
    dev = resolve_device(device)
    if _model_device(params) != dev:
        raise ValueError(f"greedy_generate: the model lies on "
                         f"{_model_device(params)}, not {dev}")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    prefill = make_prefill(cfg, max_len)
    step = make_serve_step(cfg)
    logits, caches = prefill(params, batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(max_new - 1):
        tok, caches = step(params, caches, tok)
        out.append(tok)
    return torch.cat(out, dim=1)
