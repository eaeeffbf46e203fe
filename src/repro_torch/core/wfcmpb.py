"""WFCMPB — progressive-block weighted FCM (paper Algorithm 2).

Counterpart of the in-memory `repro.core.wfcmpb.wfcmpb`.  Data is split
into blocks; block i is clustered with FCM seeded by the previous
block's centers, and its (centers, weights) summary is merged into the
running summary through the engine's ``flat`` merge plan.  The
reference's ``lax.scan`` over blocks is a host loop here.

The running summary is a fixed-size (C centers, C weights) sketch, so
WFCMPB is the natural **out-of-core** algorithm: `wfcmpb_store` runs the
same progression over a `repro_torch.data.cache.ChunkStore`, one
memory-mapped chunk batch per block, staged onto the card as
`repro_torch.core.outofcore` stages every batch.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import as_real, resolve_device
from ..engine import MergePlan, Summary, merge_summaries, resolve_backend
from .fcm import FCMResult, fcm
from .outofcore import BatchFactory, device_batches, ooc_accumulate


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
    x = as_real(x, dev)
    n, d = x.shape
    v0 = as_real(init_centers, dev)
    w = (torch.ones((n,), dtype=x.dtype, device=dev)
         if point_weights is None else as_real(point_weights, dev))

    n_blocks = max(1, -(-n // block_size))
    pad = n_blocks * block_size - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
        w = torch.cat([w, w.new_zeros((pad,))])
    xb = x.reshape(n_blocks, block_size, d)
    wb = w.reshape(n_blocks, block_size)

    running, iters = _progress(zip(xb, wb), v0, m, eps, max_iter,
                               merge_max_iter, be, dev)
    # Objective of the final sketch against the full (padded) data.
    _, _, q = be.accumulate(x, w, running.centers, m)
    return FCMResult(running.centers, running.masses, iters, q)


def _progress(blocks, v0, m, eps, max_iter, merge_max_iter, be, dev):
    """The block progression over (x, w) device blocks from seeds ``v0``:
    returns (running summary, Σ block sweeps)."""
    plan = MergePlan("flat", m=m, eps=eps, max_iter=merge_max_iter)
    # Zero-mass init summary: phantom centers are ignored by the merge.
    v_prev, running, iters = v0, Summary(v0, v0.new_zeros((v0.shape[0],))), 0
    n_blocks = 0
    for bx, bw in blocks:
        n_blocks += 1
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
    if not n_blocks:
        raise ValueError("wfcmpb_batches: empty batch stream")
    return running, iters


def wfcmpb_batches(
    batches_factory: BatchFactory,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    merge_max_iter: int = 200,
    backend=None,
    with_objective: bool = True,
    ring=None,
    device: Union[str, torch.device] = "cuda",
) -> FCMResult:
    """The progression of `wfcmpb` over a re-iterable (x, w) batch
    stream — block i is one fixed-size chunk batch (phantom-padded).
    ``with_objective`` runs a second pass over the stream for the final
    objective (mmap re-reads when the factory reads a chunk cache, never
    re-parses); callers that only consume the sketch — the
    `bigfcm_fit_store` combiner — pass False and skip that pass (the
    objective comes back NaN).  ``ring`` shares a
    `repro_torch.core.outofcore.StagingRing` across calls."""
    dev = resolve_device(device)
    be = resolve_backend(backend, device=dev)
    running, iters = _progress(
        device_batches(batches_factory(), dev, ring),
        as_real(init_centers, dev), m, eps, max_iter, merge_max_iter, be, dev)
    if with_objective:
        _, _, q = ooc_accumulate(batches_factory(), running.centers, m,
                                 backend=be, ring=ring, device=dev)
    else:
        q = torch.tensor(float("nan"), device=dev)   # explicitly not computed
    return FCMResult(running.centers, running.masses, iters, q)


def wfcmpb_store(
    store,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    batch_rows: Optional[int] = None,
    merge_max_iter: int = 200,
    backend=None,
    plan=None,
    shard: int = 0,
    with_objective: bool = True,
    ring=None,
    device: Union[str, torch.device] = "cuda",
) -> FCMResult:
    """`wfcmpb` over a `ChunkStore` (out of core, single pass + one
    objective pass).  ``batch_rows`` defaults to the store's chunk size
    (block ≡ cache chunk); with a `repro_torch.data.plane.PartitionPlan`,
    only ``shard``'s chunks are read — the out-of-core combiner of
    `bigfcm_fit_store`."""
    from ..data.plane import batched, shard_batches
    rows = int(batch_rows or store.chunk_rows)
    if plan is None:
        factory = lambda: batched(store.iter_chunks(), rows)   # noqa: E731
    else:
        factory = lambda: shard_batches(store, plan, shard, rows)  # noqa: E731
    return wfcmpb_batches(factory, init_centers, m=m, eps=eps,
                          max_iter=max_iter, merge_max_iter=merge_max_iter,
                          backend=backend, with_objective=with_objective,
                          ring=ring, device=device)
