"""Mahout-FKM / Ludwig-style baseline: ONE MapReduce job PER ITERATION.

Counterpart of `repro.baselines.mr_fkm`.  Each global FCM sweep is a
separate job with a host round-trip (the convergence test on the host),
the dominant cost the paper attributes to prior art: per-iteration job
scheduling and full-data re-reads.  Centers are given (no driver
pre-clustering).

On a device mesh (``mesh=``, `repro_torch.mesh`; every rank calls with
the same arguments) each job is the paper's map-reduce: each rank runs
K1 (the raw accumulate) on its ``P(data_axes)`` row block, the raw
(C·d + C + 1) sums are gathered and added in rank order, every rank
normalizes once and reads ΔV² once — `ooc_fcm`'s shape of a job, not a
per-shard sweep.

On the card the "job launch" cost is the launch plus the host sync;
``launch_overhead`` (seconds, default 0) lets benchmarks add Hadoop's
per-job scheduling constant, so Table 3/4-style comparisons can be made
at both extremes (0 = most favourable to the baseline).
"""
from __future__ import annotations

import itertools
import time
from typing import Optional, Union

import torch

from ..core.fcm import FCMResult
from ..core.outofcore import StagingRing, make_accumulator, \
    ooc_accumulate, ooc_sweep
from ..data.plane import batched
from ..device import as_real, copy_real, resolve_device, synchronize
from ..engine import resolve_backend
from ..engine.backend import BackendLike, normalize_accumulators
from ..mesh import agreed_backend, mesh_size, psum, rank_device, shard_rows


def _one_sweep(be, x, w, centers, m: float):
    v_new, w_i, q = be.sweep(x, w, centers, m)
    delta = torch.max(torch.sum((v_new - centers) ** 2, dim=-1))
    return v_new, w_i, q, delta


def mr_fuzzy_kmeans(
    x,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    mesh=None,
    data_axes=("data",),
    launch_overhead: float = 0.0,
    backend: BackendLike = None,
    device: Union[str, torch.device] = "cuda",
):
    """Returns (FCMResult, n_jobs, elapsed_seconds).  On a mesh of several
    ranks ``x`` is the global array (its rows must split evenly over
    ``data_axes``) and ``device`` is not read: each rank works on its
    block on its own device."""
    if mesh is not None:
        dev = rank_device(mesh)
        if mesh_size(mesh) > 1:
            return _mr_fkm_mesh(x, init_centers, m, eps, max_iter, mesh,
                                tuple(data_axes), launch_overhead, backend,
                                dev)
    else:
        dev = resolve_device(device)
    be = resolve_backend(backend, device=dev)
    x = as_real(x, dev)
    w = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
    centers = as_real(init_centers, dev)
    # Warm-up launch (excluded from timing, like a warm JVM): the kernel
    # is built at its first launch.
    _one_sweep(be, x, w, centers, m)
    synchronize(dev)
    t0 = time.perf_counter()
    n_jobs, q = 0, torch.zeros((), device=dev)
    w_i = torch.zeros((centers.shape[0],), dtype=torch.float32, device=dev)
    for _ in range(max_iter):
        centers, w_i, q, delta = _one_sweep(be, x, w, centers, m)
        # host sync = the reduce job writing to HDFS + driver reading it
        delta = float(delta)
        n_jobs += 1
        if delta <= eps:
            break
    elapsed = time.perf_counter() - t0 + launch_overhead * n_jobs
    return FCMResult(centers, w_i, n_jobs, q), n_jobs, elapsed


def _mr_fkm_mesh(x, init_centers, m, eps, max_iter, mesh, data_axes,
                 launch_overhead, backend, dev):
    be = agreed_backend(backend, mesh)
    x_l = copy_real(shard_rows(x, mesh, data_axes), dev)
    w_l = torch.ones((x_l.shape[0],), dtype=x_l.dtype, device=dev)
    centers = as_real(init_centers, dev)
    c, d = centers.shape

    def job(v):
        # map: K1 on this rank's block; reduce: the raw sums added in
        # rank order; then one normalization, the same on every rank
        v_num, w_i, q = be.accumulate(x_l, w_l, v, m)
        tot = psum(torch.cat([v_num.reshape(-1), w_i, q.reshape(1)]), mesh,
                   data_axes)
        v_new, w_i, q = normalize_accumulators(
            tot[:c * d].reshape(c, d), tot[c * d:c * d + c], tot[-1])
        delta = torch.max(torch.sum((v_new - v) ** 2, dim=-1))
        return v_new, w_i, q, delta

    job(centers)                     # warm-up job, excluded from timing
    synchronize(dev)
    t0 = time.perf_counter()
    n_jobs, q = 0, torch.zeros((), device=dev)
    w_i = torch.zeros((c,), dtype=torch.float32, device=dev)
    for _ in range(max_iter):
        centers, w_i, q, delta = job(centers)
        delta = float(delta)         # host sync = the driver's read
        n_jobs += 1
        if delta <= eps:
            break
    elapsed = time.perf_counter() - t0 + launch_overhead * n_jobs
    return FCMResult(centers, w_i, n_jobs, q), n_jobs, elapsed


def mr_fuzzy_kmeans_store(
    store,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    batch_rows: Optional[int] = None,
    launch_overhead: float = 0.0,
    backend: BackendLike = None,
    device: Union[str, torch.device] = "cuda",
):
    """The per-iteration-job baseline over a `ChunkStore` — and the
    honest version of the cost the paper attributes to Mahout/Ludwig:
    every "job" re-reads EVERY chunk of the cache (an mmap page-in per
    chunk per job, the HDFS re-scan analogue) and stages it onto the
    card, where BigFCM's out-of-core path reads through the same store
    but pays its parse exactly once up front.  Returns (FCMResult,
    n_jobs, elapsed)."""
    dev = resolve_device(device)
    rows = int(batch_rows or store.chunk_rows)
    acc = make_accumulator(backend, m, device=dev)
    ring = StagingRing(dev) if dev.type == "cuda" else None
    centers = as_real(init_centers, dev)
    # Warm-up on one batch (excluded from timing, warm JVM).
    ooc_accumulate(itertools.islice(batched(store.iter_chunks(), rows), 1),
                   centers, m, acc=acc, ring=ring, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    n_jobs, q = 0, torch.zeros((), device=dev)
    w_i = torch.zeros((centers.shape[0],), dtype=torch.float32, device=dev)
    for _ in range(max_iter):
        v_new, w_i, q = ooc_sweep(batched(store.iter_chunks(), rows),
                                  centers, m, acc=acc, ring=ring, device=dev)
        delta = float(torch.max(torch.sum((v_new - centers) ** 2, dim=-1)))
        centers = v_new
        n_jobs += 1          # host sync = reduce job → HDFS → driver read
        if delta <= eps:
            break
    elapsed = time.perf_counter() - t0 + launch_overhead * n_jobs
    return FCMResult(centers, w_i, n_jobs, q), n_jobs, elapsed
