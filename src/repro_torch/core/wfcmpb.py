"""WFCMPB — progressive-block weighted FCM (paper Algorithm 2).

Counterpart of the in-memory `repro.core.wfcmpb.wfcmpb`.  Data is split
into blocks; block i is clustered with FCM seeded by the previous
block's centers, and its (centers, weights) summary is merged into the
running summary through the engine's ``flat`` merge plan.  The
reference's ``lax.scan`` over blocks is a host loop here.  The
out-of-core variants (`wfcmpb_batches`, `wfcmpb_store`) come with the
store slice.
"""
from __future__ import annotations

from typing import Union

import torch

from ..device import as_f32, resolve_device
from ..engine import MergePlan, Summary, merge_summaries, resolve_backend
from .fcm import FCMResult, fcm


def wfcmpb(
    x,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    block_size: int = 4096,
    point_weights=None,
    merge_max_iter: int = 200,
    backend=None,
    device: Union[str, torch.device] = "cuda",
) -> FCMResult:
    """Cluster ``x`` block-progressively.  x: (N, d) → FCMResult.

    N is padded up to a multiple of block_size with zero-weight phantom
    records (weight 0 ⇒ no contribution to any accumulation).
    """
    dev = resolve_device(device)
    be = resolve_backend(backend, device=dev)
    x = as_f32(x, dev)
    n, d = x.shape
    v0 = as_f32(init_centers, dev)
    c = v0.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=dev)
         if point_weights is None else as_f32(point_weights, dev))

    n_blocks = max(1, -(-n // block_size))
    pad = n_blocks * block_size - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
        w = torch.cat([w, w.new_zeros((pad,))])
    xb = x.reshape(n_blocks, block_size, d)
    wb = w.reshape(n_blocks, block_size)

    plan = MergePlan("flat", m=m, eps=eps, max_iter=merge_max_iter)
    # Zero-mass init summary: phantom centers are ignored by the merge.
    v_prev, running, iters = v0, Summary(v0, v0.new_zeros((c,))), 0
    for bx, bw in zip(xb, wb):
        # C_i, W_i = FCM(S_i, C_{i−1}) — seed with the previous block's centers.
        res = fcm(bx, v_prev, m=m, eps=eps, max_iter=max_iter,
                  point_weights=bw, backend=be, device=dev)
        # V_final, W_f = WFCM(V_final ∪ C_i, W_f ∪ W_i) — one flat merge
        # of the running summary with the block summary, seeded with C_i.
        merged = merge_summaries(
            [running, Summary(res.centers, res.center_weights)], plan,
            backend=be, init=res.centers)
        v_prev, running, iters = res.centers, merged.summary, \
            iters + res.n_iter
    # Objective of the final sketch against the full (padded) data.
    _, _, q = be.accumulate(x, w, running.centers, m)
    return FCMResult(running.centers, running.masses, iters, q)
