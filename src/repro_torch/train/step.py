"""Training step: loss → grads → clip → optimizer, with optional
microbatch gradient accumulation — counterpart of `repro.train.step`.

The parameters are the model's own (`models.transformer.DecoderLM`,
`models.encdec.EncDecLM`, ``requires_grad`` on); autograd takes the
gradients and the optimizer (`repro_torch.optim`) works on them grouped
by the reference's leaves (`param_groups`), updating the parameters and
its state in place.  The step counter and the optimizer's ``count`` are
0-d int32 tensors on the CPU, so the schedule and the bias corrections
need no device sync.

A model sharded over a mesh (``DecoderLM(…, mesh=)``, `sharding.spmd`)
takes the sharded step: every rank is handed the same global batch and
runs on its rows (each microbatch's block, as the reference splits each
microbatch), under the model's mesh and profile.  The rows split over
the largest prefix of the profile's batch axes that divides a
microbatch (`spmd.rows`) and are replicated over the others — where
the rows leave "model" under "fsdp", a dense or MoE decoder splits the
sequence over it instead (`transformer.split_length`), each rank on its
block of positions, no longer a copy of its neighbours'.  The loss is
then the global mean on every rank; the backward, seeded with
1/`spmd.replication` on each rank (a token's copies count once), has
summed each gradient over its leaf's storage axes
(`mesh.gather_param`), and the step sums it over the batch axes its
placement leaves whole (`sync_grads`: one rank-ordered f32 sum per set of
axes) before the clip, whose norm counts each leaf once, and the
update, which is elementwise on the blocks (Adafactor's reductions add
over the ranks).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from .. import mesh as M
from ..configs.base import ModelConfig
from ..models import encdec as encdec_lib
from ..models import transformer as tf
from ..models.params import from_reference, nest, to_reference
from ..models.params import param_groups as _param_groups
from ..optim import (Optimizer, clip_by_global_norm, state_from_reference,
                     state_to_reference)
from ..sharding import spmd
from ..sharding.rules import get_seq, mesh_context, profile_context

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any              # the model (an nn.Module), trainable
    opt_state: Any
    step: torch.Tensor       # 0-d int32, on the CPU


def model_decl(cfg: ModelConfig):
    return (encdec_lib.decl(cfg) if cfg.family == "encdec"
            else tf.decl(cfg))


def param_groups(model) -> dict:
    """The model's parameters by reference leaf (`optim.Group`s)."""
    return _param_groups(model, model_decl(model.cfg))


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params, optimizer.init(param_groups(params)),
                      torch.zeros((), dtype=torch.int32))


def model_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Cross-entropy for any family.  batch keys:
    tokens/labels (all), frames (encdec), patch_embeds (vlm)."""
    mesh = spmd.active_mesh()
    if cfg.family == "encdec":      # sharded: one gathered (tied) table
        head = tf.sharded_head(cfg, params, mesh) if mesh is not None \
            else None
        enc = encdec_lib.encode(cfg, params, batch["frames"])
        hidden = encdec_lib.decode(cfg, params, batch["tokens"], enc,
                                   table=head)
        return tf.lm_loss(cfg, params, hidden, batch["labels"], head=head)
    prefix = batch.get("patch_embeds")
    head = None
    if mesh is not None:            # sharded: one gathered head, tied or not
        head = tf.sharded_head(cfg, params, mesh)
        hidden = params(batch["tokens"], prefix_embeds=prefix,
                        table=head if cfg.tie_embeddings else None)
    else:
        hidden = params(batch["tokens"], prefix_embeds=prefix)
    labels = batch["labels"]
    seq = get_seq() if mesh is not None else None
    if seq is not None:             # this rank's block of the positions
        p = 0 if prefix is None else prefix.shape[1]
        hidden, labels = tf.label_part(seq, hidden, labels, p)
        return tf.lm_loss(cfg, params, hidden, labels, head=head,
                          n_positions=batch["labels"].shape[1])
    if prefix is not None:
        hidden = hidden[:, prefix.shape[1]:]
    return tf.lm_loss(cfg, params, hidden, labels, head=head)


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def on_device(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v), device=device)
            for k, v in batch.items()}


def regroup(groups, flat: List[torch.Tensor]) -> Dict[str, list]:
    """A flat list in the groups' part order as {path: [tensors]}."""
    out, i = {}, 0
    for path, g in groups.items():
        out[path] = list(flat[i:i + len(g.parts)])
        i += len(g.parts)
    return out


def loss_and_grads(cfg, model, groups, batch, weight: float = 1.0):
    """(loss, {path: [gradient of each part]}) of `model_loss`, the
    backward seeded with ``weight``; a parameter the loss does not reach
    gets zeros, as ``jax.grad`` gives."""
    loss = model_loss(cfg, model, batch)
    seed = None if weight == 1.0 else torch.full_like(loss, weight)
    grads = torch.autograd.grad(
        loss, [p for g in groups.values() for p in g.parts],
        grad_outputs=seed, allow_unused=True, materialize_grads=True)
    return loss.detach(), regroup(groups, grads)


def apply_update(state: TrainState, groups, grads, loss, optimizer,
                 lr_fn, grad_clip: float):
    """Clip, then the optimizer's update → (next state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, grad_clip, groups)
    lr = lr_fn(state.step)
    _, new_opt = optimizer.update(grads, state.opt_state, groups, lr)
    metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
               "step": state.step}
    return TrainState(state.params, new_opt, state.step + 1), metrics


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, lr_fn,
                    *, grad_clip: float = 1.0, microbatches: int = 1):
    """Returns train_step(state, batch) → (state, metrics); the batch's
    arrays are moved to the model's device.  With ``microbatches`` > 1
    the batch's rows are cut into that many consecutive slices whose
    losses and f32 gradients are summed, then divided by their count (the
    reference's ``lax.scan``)."""

    def step_fn(state: TrainState, batch):
        model = state.params
        if getattr(model, "mesh", None) is not None:
            with mesh_context(model.mesh), profile_context(model.profile):
                return sharded_step(cfg, state, batch, optimizer, lr_fn,
                                    grad_clip, microbatches)
        groups = param_groups(model)
        dev = model_device(model)
        batch = on_device(batch, dev)
        if microbatches == 1:
            loss, grads = loss_and_grads(cfg, model, groups, batch)
            return apply_update(state, groups, grads, loss, optimizer,
                                lr_fn, grad_clip)
        loss = torch.zeros((), dtype=F32, device=dev)
        grads = {p: [torch.zeros(t.shape, dtype=F32, device=dev)
                     for t in g.parts] for p, g in groups.items()}
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            l, g = loss_and_grads(cfg, model, groups, mb)
            loss = loss + l
            for p, ts in g.items():
                for acc, t in zip(grads[p], ts):
                    acc.add_(t.to(F32))
            del g
        loss = loss / microbatches
        for ts in grads.values():
            for t in ts:
                t.div_(microbatches)
        return apply_update(state, groups, grads, loss, optimizer, lr_fn,
                            grad_clip)

    return step_fn


def sharded_step(cfg, state: TrainState, batch, optimizer, lr_fn,
                 grad_clip: float, microbatches: int):
    """One step of a sharded model on the global ``batch`` (see the
    module's docstring), under its mesh and profile."""
    rows = int(next(iter(batch.values())).shape[0])
    if rows % microbatches:
        raise ValueError(f"{rows} rows do not split into {microbatches} "
                         "microbatches")
    per = rows // microbatches
    with spmd.rows(per, state.params.mesh,
                   tf.split_length(cfg, batch)):
        return _sharded_step(cfg, state, batch, optimizer, lr_fn, grad_clip,
                             microbatches, per)


def _sharded_step(cfg, state, batch, optimizer, lr_fn, grad_clip,
                  microbatches, per):
    model = state.params
    mesh = model.mesh
    groups = param_groups(model)
    dev = model_device(model)
    axes = spmd.batch_axes(mesh)
    weight = 1.0 / spmd.replication(mesh)

    def block(i):
        return on_device({k: M.shard_rows(v[i * per:(i + 1) * per], mesh,
                                          axes)
                          for k, v in batch.items()}, dev)
    if microbatches == 1:
        loss, grads = loss_and_grads(cfg, model, groups, block(0), weight)
    else:
        loss = torch.zeros((), dtype=F32, device=dev)
        grads = {p: [torch.zeros(t.shape, dtype=F32, device=dev)
                     for t in g.parts] for p, g in groups.items()}
        for i in range(microbatches):
            l, g = loss_and_grads(cfg, model, groups, block(i), weight)
            loss = loss + l
            for p, ts in g.items():
                for acc, t in zip(grads[p], ts):
                    acc.add_(t.to(F32))
            del g
        loss = loss / microbatches
        for ts in grads.values():
            for t in ts:
                t.div_(microbatches)
    grads = sync_grads(grads, groups, mesh)
    return apply_update(state, groups, grads, loss, optimizer, lr_fn,
                        grad_clip)


def sync_grads(grads, groups, mesh):
    """Each leaf's gradient summed over the batch axes its placement
    leaves whole (`spmd.grad_sum_axes`; the norm scales and the biases
    of the column-parallel layers, for one): the leaves sharing a set of
    axes as one f32 payload, its parts added in rank order, each
    gradient rounded back to its dtype."""
    by_axes: Dict[tuple, list] = {}
    for path, g in groups.items():
        axes = spmd.grad_sum_axes(g.spec, mesh)
        if axes:
            by_axes.setdefault(axes, []).append(path)
    out = dict(grads)
    for axes, paths in by_axes.items():
        flat = [t for p in paths for t in grads[p]]
        total = M.psum(torch.cat([t.reshape(-1).to(F32) for t in flat]),
                       mesh, axes)
        parts = iter(torch.split(total, [t.numel() for t in flat]))
        for p in paths:
            out[p] = [next(parts).reshape(t.shape).to(t.dtype)
                      for t in grads[p]]
    return out


# ------------------------------------------- the reference's layout ---

def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def train_state_to_reference(state: TrainState) -> Dict[str, Any]:
    """The train state as the reference's ``TrainState`` fields, CPU
    tensors with stacked leaves: ``{"params": tree, "opt_state": tree,
    "step": int32}`` (a sharded model's: this rank's stacked blocks)."""
    model = state.params
    opt = state_to_reference(state.opt_state, param_groups(model))
    return {"params": to_reference(model, model_decl(model.cfg)),
            "opt_state": {k: nest(v) if isinstance(v, dict) else v
                          for k, v in opt.items()},
            "step": state.step.clone()}


def train_state_from_reference(cfg: ModelConfig, ref,
                               device="cuda") -> TrainState:
    """The reference's ``TrainState`` (``ref.params``, ``ref.opt_state``,
    ``ref.step``, leaves as numpy arrays; a namedtuple or a dict with
    those keys) as the port's: a trainable model of ``cfg`` on
    ``device`` and the optimizer state (AdamW, Adafactor or SGD, told by
    its keys) in the port's layout."""
    from ..models import DecoderLM, EncDecLM
    get = (ref.get if isinstance(ref, dict)
           else lambda k: getattr(ref, k))
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    model = cls(cfg, device=device)
    model.load_state_dict(from_reference(get("params"), device=device))
    model.requires_grad_(True)
    groups = param_groups(model)
    opt = {k: (v if k == "count" else {p: _at(v, p) for p in groups})
           for k, v in get("opt_state").items()}
    return TrainState(model, state_from_reference(opt, groups),
                      torch.as_tensor(np.asarray(get("step")),
                                      dtype=torch.int32).cpu())
