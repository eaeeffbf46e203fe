"""Explicit data-parallel gradient synchronization with compression —
counterpart of `repro.train.dp`, over `repro_torch.mesh`.

The reference makes the gradient reduction explicit (``shard_map``) so
its wire dtype is chosen: each device adds its error-feedback residual
to its gradient in f32, rounds it to ``wire_dtype`` (bf16 halves the
bytes of f32), and the rounded gradients are averaged
(``pmean(q.astype(f32))``: bf16 values added in f32); the residual
``g − f32(q)`` is carried to the next step, so compression noise is a
zero-mean perturbation rather than a bias (Seide et al. '14,
Karimireddy et al. '19).

The port is SPMD, one process per rank (`repro_torch.mesh`): every rank
calls the step with the same global batch and computes on its own row
block of it (`mesh.shard_rows` over ``data_axes``).  The rounded
gradients of all parts travel as one bf16 payload (`mesh.all_gather` of
its bytes: gloo's own bf16 support is not counted on, and the bytes are
the same), and every rank adds the ranks' payloads in f32 in
rank order (`mesh.sum_in_order`) — never a bf16 ``all_reduce``, whose
sums would round to bf16.  Parameters and optimizer state stay
replicated: every rank applies the same update to the same values.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from .. import mesh as M
from ..optim import Optimizer
from .step import (F32, TrainState, apply_update, init_train_state,
                   loss_and_grads, model_device, param_groups, regroup)


class DPState(NamedTuple):
    train: TrainState
    error: Any          # error-feedback residual: {path: [f32 tensors]}


def compress(g, wire_dtype):
    return g.to(wire_dtype)


def error_feedback(grads, error, wire_dtype):
    """Each part's gradient plus its residual in f32, rounded to the wire
    → ({path: [wire tensors]}, {path: [new residuals g − f32(q)]})."""
    qs, es = {}, {}
    for path, ts in grads.items():
        qs[path], es[path] = [], []
        for g, e in zip(ts, error[path]):
            g = g.to(F32) + e
            q = compress(g, wire_dtype)
            qs[path].append(q)
            es[path].append(g - q.to(F32))
    return qs, es


def average_in_order(stacks, n: int) -> torch.Tensor:
    """The f32 mean of a (P, …) stack of wire tensors: upcast, added in
    rank order, divided by P (the reference's ``pmean``)."""
    return M.sum_in_order([s.to(F32) for s in stacks]) / n


def make_dp_train_step(cfg, optimizer: Optimizer, lr_fn, mesh, *,
                       data_axes: Sequence[str] = ("data",),
                       wire_dtype=torch.bfloat16, grad_clip: float = 1.0):
    """Replicated-params DP step with a compressed gradient mean and
    error feedback → step(state: DPState, batch) → (state, metrics),
    ``batch`` the global batch (numpy arrays or tensors), this rank
    computing on its ``P(data_axes)`` row block."""
    data_axes = tuple(data_axes)

    def step(state: DPState, batch):
        ts = state.train
        model = ts.params
        groups = param_groups(model)
        dev = model_device(model)
        local = {k: torch.as_tensor(M.shard_rows(v, mesh, data_axes),
                                    device=dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(cfg, model, groups, local)
        qs, new_err = error_feedback(grads, state.error, wire_dtype)
        flat = [q for path in groups for q in qs[path]]
        wire = torch.cat([q.reshape(-1) for q in flat])
        # the payload's bytes (uint8): every backend moves them, where
        # gloo refuses int16 and not every build takes bf16
        stack = M.all_gather(wire.view(torch.uint8), mesh,
                             data_axes).view(wire.dtype)
        mean = average_in_order(stack, stack.shape[0])
        sizes = [q.numel() for q in flat]
        g_sync = regroup(groups, [
            m.reshape(q.shape)
            for m, q in zip(torch.split(mean, sizes), flat)])
        losses = M.all_gather(loss.reshape(1), mesh, data_axes)
        loss = (M.sum_in_order(list(losses)) / losses.shape[0])[0]
        new_ts, metrics = apply_update(ts, groups, g_sync, loss, optimizer,
                                       lr_fn, grad_clip)
        return DPState(new_ts, new_err), metrics

    return step


def init_dp_state(params, optimizer: Optimizer) -> DPState:
    err = {path: [torch.zeros(p.shape, dtype=F32, device=p.device)
                  for p in g.parts]
           for path, g in param_groups(params).items()}
    return DPState(init_train_state(params, optimizer), err)
