"""Mahout-KM baseline: hard k-means, one MapReduce job per iteration.

Counterpart of `repro.baselines.kmeans`, single device, in the
reference's float32 math: d² by the expansion x² + v² − 2·x·vᵀ, the
nearest center's one-hot, counts and sums as one matrix product, and an
empty cluster keeps its previous center.  Each job ends in one host
sync, the convergence test's read of the largest center shift.
"""
from __future__ import annotations

import time
from typing import Union

import torch

from ..device import resolve_device, synchronize
from ..engine.backend import pairwise_sqdist


def _kmeans_sweep(x: torch.Tensor, centers: torch.Tensor):
    d2 = pairwise_sqdist(x, centers, torch.float32)
    assign = torch.argmin(d2, dim=-1, keepdim=True)          # (N, 1)
    onehot = torch.zeros_like(d2).scatter_(1, assign, 1.0)   # (N, C)
    counts = onehot.sum(0)
    sums = onehot.T @ x
    v_new = sums / torch.clamp(counts, min=1.0)[:, None]
    # empty clusters keep their previous center
    v_new = torch.where(counts[:, None] > 0, v_new, centers)
    inertia = torch.sum(torch.min(d2, dim=-1).values)
    delta = torch.max(torch.sum((v_new - centers) ** 2, dim=-1))
    return v_new, counts, inertia, delta


def mr_kmeans(
    x,
    init_centers,
    *,
    eps: float = 1e-6,
    max_iter: int = 1000,
    mesh=None,
    launch_overhead: float = 0.0,
    device: Union[str, torch.device] = "cuda",
):
    """Returns (centers, counts, inertia, n_jobs, elapsed_seconds);
    ``launch_overhead`` (seconds) is Hadoop's per-job scheduling
    constant, added per job."""
    if mesh is not None:
        raise NotImplementedError(
            "mr_kmeans on a device mesh is not ported yet; it comes with "
            "the multi-GPU slice")
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    centers = torch.as_tensor(init_centers, dtype=torch.float32, device=dev)
    _kmeans_sweep(x, centers)        # warm-up job, excluded from timing
    synchronize(dev)
    t0 = time.perf_counter()
    n_jobs = 0
    inertia = torch.zeros((), dtype=torch.float32, device=dev)
    counts = torch.zeros((centers.shape[0],), dtype=torch.float32,
                         device=dev)
    for _ in range(max_iter):
        centers, counts, inertia, delta = _kmeans_sweep(x, centers)
        delta = float(delta)   # host sync per job
        n_jobs += 1
        if delta <= eps:
            break
    elapsed = time.perf_counter() - t0 + launch_overhead * n_jobs
    return centers, counts, inertia, n_jobs, elapsed
