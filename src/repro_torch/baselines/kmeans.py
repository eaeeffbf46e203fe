"""Mahout-KM baseline: hard k-means, one MapReduce job per iteration.

Counterpart of `repro.baselines.kmeans`, single device, in the
reference's float32 math: d² by the expansion x² + v² − 2·x·vᵀ, the
nearest center's one-hot, counts and sums as one matrix product, and an
empty cluster keeps its previous center.  Each job ends in one host
sync, the convergence test's read of the largest center shift.

On a device mesh (``mesh=``, `repro_torch.mesh`; every rank calls with
the same arguments) each rank computes the hard-assignment sums of its
``P(data_axes)`` row block (per-center sums, counts, inertia); the sums
are gathered and added in rank order, and every rank finishes the job
the same way.
"""
from __future__ import annotations

import time
from typing import Union

import torch

from ..device import resolve_device, synchronize
from ..engine.backend import pairwise_sqdist
from ..mesh import mesh_size, psum, rank_device, shard_rows


def _kmeans_sums(x: torch.Tensor, centers: torch.Tensor):
    """The map step: per-center sums, counts and the inertia."""
    d2 = pairwise_sqdist(x, centers, torch.float32)
    assign = torch.argmin(d2, dim=-1, keepdim=True)          # (N, 1)
    onehot = torch.zeros_like(d2).scatter_(1, assign, 1.0)   # (N, C)
    inertia = torch.sum(torch.min(d2, dim=-1).values)
    return onehot.T @ x, onehot.sum(0), inertia


def _kmeans_finish(sums, counts, inertia, centers):
    v_new = sums / torch.clamp(counts, min=1.0)[:, None]
    # empty clusters keep their previous center
    v_new = torch.where(counts[:, None] > 0, v_new, centers)
    delta = torch.max(torch.sum((v_new - centers) ** 2, dim=-1))
    return v_new, counts, inertia, delta


def _kmeans_sweep(x: torch.Tensor, centers: torch.Tensor):
    return _kmeans_finish(*_kmeans_sums(x, centers), centers)


def _mesh_sweep(mesh, data_axes):
    """One job over ``mesh``: this rank's sums, added across ranks in rank
    order, then the finish."""
    def sweep(x: torch.Tensor, centers: torch.Tensor):
        sums, counts, inertia = _kmeans_sums(x, centers)
        c, d = sums.shape
        tot = psum(torch.cat([sums.reshape(-1), counts, inertia.reshape(1)]),
                   mesh, data_axes)
        return _kmeans_finish(tot[:c * d].reshape(c, d),
                              tot[c * d:c * d + c], tot[-1], centers)
    return sweep


def mr_kmeans(
    x,
    init_centers,
    *,
    eps: float = 1e-6,
    max_iter: int = 1000,
    mesh=None,
    data_axes=("data",),
    launch_overhead: float = 0.0,
    device: Union[str, torch.device] = "cuda",
):
    """Returns (centers, counts, inertia, n_jobs, elapsed_seconds);
    ``launch_overhead`` (seconds) is Hadoop's per-job scheduling
    constant, added per job.  On a mesh of several ranks ``x`` is the
    global array (its rows must split evenly over ``data_axes``) and
    ``device`` is not read: each rank works on its block on its own
    device."""
    sweep = _kmeans_sweep
    if mesh is not None:
        dev = rank_device(mesh)
        if mesh_size(mesh) > 1:
            x = shard_rows(x, mesh, tuple(data_axes))
            sweep = _mesh_sweep(mesh, tuple(data_axes))
    else:
        dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    centers = torch.as_tensor(init_centers, dtype=torch.float32, device=dev)
    sweep(x, centers)                # warm-up job, excluded from timing
    synchronize(dev)
    t0 = time.perf_counter()
    n_jobs = 0
    inertia = torch.zeros((), dtype=torch.float32, device=dev)
    counts = torch.zeros((centers.shape[0],), dtype=torch.float32,
                         device=dev)
    for _ in range(max_iter):
        centers, counts, inertia, delta = sweep(x, centers)
        delta = float(delta)   # host sync per job
        n_jobs += 1
        if delta <= eps:
            break
    elapsed = time.perf_counter() - t0 + launch_overhead * n_jobs
    return centers, counts, inertia, n_jobs, elapsed
