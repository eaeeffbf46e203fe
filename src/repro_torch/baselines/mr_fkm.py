"""Mahout-FKM / Ludwig-style baseline: ONE MapReduce job PER ITERATION.

Counterpart of `repro.baselines.mr_fkm`.  Each global FCM sweep is a
separate job with a host round-trip (the convergence test on the host),
the dominant cost the paper attributes to prior art: per-iteration job
scheduling and full-data re-reads.  Centers are given (no driver
pre-clustering).

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
from ..device import as_real, resolve_device, synchronize
from ..engine import resolve_backend
from ..engine.backend import BackendLike


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
    launch_overhead: float = 0.0,
    backend: BackendLike = None,
    device: Union[str, torch.device] = "cuda",
):
    """Returns (FCMResult, n_jobs, elapsed_seconds)."""
    if mesh is not None:
        raise NotImplementedError(
            "mr_fuzzy_kmeans on a device mesh is not ported yet; it comes "
            "with the multi-GPU slice")
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
