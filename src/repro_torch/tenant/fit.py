"""Batched tenant fitting — thousands of small FCM fits in one loop.

Counterpart of `repro.tenant.fit`.  `fit_tenants` packs ragged
per-tenant record sets into one phantom-padded (T_b, N_b, d) block (the
`data.plane.pad_rows` / `geom_bucket` idiom on both axes: rows pad to
the row bucket with zero weights, the tenant axis pads to the tenant
bucket with all-zero phantom tenants) and runs
`repro_torch.engine.fcm_converge_batched`: the whole cohort converges
in one host loop with a per-tenant done-mask, one tenant-stacked sweep
per iteration (on a card, the Hopper kernel
``kernels/csrc/fcm_batched.cu``).

`fit_tenants_looped` is the same math as T separate fits through the
backend's single-model sweep, the per-tenant baseline the parity tests
hold the batched path to.  Both paths share seeding (`seed_centers`:
numpy draws keyed by ``(cfg.seed, t)``, bit-equal to the reference's),
so their trajectories are comparable tenant by tenant.

Instrumentation (`repro_torch.obs`, the reference's names): each fit is
a ``tenant.fit`` span labelled with its cohort size, ending at the host
copy of its centers, and ``tenant.fit.launches`` counts device
dispatches (`fit_tenants`: 1 per fit; `fit_tenants_looped`: 1 per
tenant).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..data.plane import geom_bucket, pad_rows
from ..device import as_real, resolve_device
from ..engine import fcm_converge_batched, resolve_backend
from ..engine.merge import _converge
from .core import TenantData, TenantSet, normalize_tenant_data, tenant_set

__all__ = ["TenantFitConfig", "pack_tenants", "seed_centers",
           "fit_tenants", "fit_tenants_looped"]

DeviceLike = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class TenantFitConfig:
    """One config shared by a whole tenant cohort (the shape bucket)."""
    n_clusters: int
    m: float = 2.0
    eps: float = 1e-6
    max_iter: int = 300
    seed: int = 0
    backend: Optional[str] = None   # None/"auto"/"torch"/"hopper"/…
    row_base: int = 64              # row-bucket ladder base (geom_bucket)
    row_factor: int = 2
    tenant_base: int = 8            # tenant-axis bucket ladder
    tenant_factor: int = 2

    def __post_init__(self):
        if self.n_clusters <= 0:
            raise ValueError(f"n_clusters must be positive, got "
                             f"{self.n_clusters}")
        if self.m <= 1.0:
            raise ValueError(f"fuzzifier m must be > 1, got {self.m}")


def pack_tenants(xs: Sequence[np.ndarray], cfg: TenantFitConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged per-tenant records → bucketed (T_b, N_b, d) X and (T_b,
    N_b) W.  Rows pad with zero-weight phantom rows; tenants pad with
    all-zero phantom tenants (zero weights everywhere ⇒ their
    accumulators stay 0 and they converge after one masked sweep)."""
    t = len(xs)
    dim = xs[0].shape[1]
    n_b = geom_bucket(max(x.shape[0] for x in xs),
                      base=cfg.row_base, factor=cfg.row_factor)
    t_b = geom_bucket(t, base=cfg.tenant_base, factor=cfg.tenant_factor)
    X = np.zeros((t_b, n_b, dim), np.float32)
    W = np.zeros((t_b, n_b), np.float32)
    for i, x in enumerate(xs):
        X[i, :x.shape[0]] = x        # in-place pad_rows: rest stays 0
        W[i, :x.shape[0]] = 1.0
    return X, W


def seed_centers(xs: Sequence[np.ndarray], cfg: TenantFitConfig
                 ) -> np.ndarray:
    """Deterministic per-tenant seeds: C distinct rows of each tenant's
    own records, keyed by ``(cfg.seed, t)`` — tenant t always draws the
    same seeds regardless of who else is in the batch (so looped and
    batched fits start identically)."""
    c = cfg.n_clusters
    out = np.zeros((len(xs), c, xs[0].shape[1]), np.float32)
    for i, x in enumerate(xs):
        if x.shape[0] < c:
            raise ValueError(f"tenant #{i}: {x.shape[0]} records cannot "
                             f"seed {c} clusters")
        rows = np.random.default_rng((cfg.seed, i)).choice(
            x.shape[0], size=c, replace=False)
        out[i] = x[rows]
    return out


def _per_tenant_m(cfg: TenantFitConfig, m_t, t_b: int, t: int
                  ) -> np.ndarray:
    """A (T_b,) fuzzifier array, whether ``m_t`` is given or not.
    Phantom slots get cfg.m (any value > 1; they carry zero mass)."""
    out = np.full((t_b,), cfg.m, np.float32)
    if m_t is not None:
        m_t = np.asarray(m_t, np.float32)
        if m_t.shape != (t,):
            raise ValueError(f"m_t must be ({t},), got {m_t.shape}")
        if np.any(m_t <= 1.0):
            raise ValueError("per-tenant fuzzifiers must all be > 1")
        out[:t] = m_t
    return out


def fit_tenants(data: TenantData, cfg: TenantFitConfig, *, m_t=None,
                device: DeviceLike = "cuda") -> TenantSet:
    """Fit every tenant's FCM model together on ``device``: one
    tenant-stacked sweep per iteration for the whole cohort.

    ``data`` is a dict ``{tenant_id: (n_t, d) records}``, a sequence of
    ``(id, records)`` pairs, or a bare sequence of arrays; ``m_t`` an
    optional (T,) per-tenant fuzzifier (defaults to ``cfg.m`` for
    all).  Returns a `TenantSet` whose row t reproduces tenant t's own
    single-model fit (same seeds, same stopping rule)."""
    ids, xs = normalize_tenant_data(data)
    t = len(ids)
    X, W = pack_tenants(xs, cfg)
    V0 = np.zeros((X.shape[0], cfg.n_clusters, X.shape[2]), np.float32)
    V0[:t] = seed_centers(xs, cfg)
    m_all = _per_tenant_m(cfg, m_t, X.shape[0], t)
    with obs.span("tenant.fit", labels={"tenants": str(t)},
                  bucket_rows=X.shape[1], bucket_tenants=X.shape[0],
                  rows=int(sum(x.shape[0] for x in xs))):
        v, masses, q, n_iter = fcm_converge_batched(
            X, W, V0, m=m_all, eps=cfg.eps, max_iter=cfg.max_iter,
            backend=cfg.backend, device=device)
        obs.counter("tenant.fit.launches").add(1)
        v = v[:t].cpu().numpy()    # the span ends at the host copy
    return tenant_set(ids, v, masses[:t].cpu().numpy(),
                      objective=q[:t].cpu().numpy(),
                      n_iter=n_iter[:t].cpu().numpy())


def fit_tenants_looped(data: TenantData, cfg: TenantFitConfig, *,
                       m_t=None, device: DeviceLike = "cuda") -> TenantSet:
    """The per-tenant baseline: identical packing, seeding and stopping
    rule as `fit_tenants`, but one fit per tenant through the backend's
    single-model sweep (rows still bucket via `geom_bucket`)."""
    ids, xs = normalize_tenant_data(data)
    t = len(ids)
    seeds = seed_centers(xs, cfg)
    m_all = _per_tenant_m(cfg, m_t, t, t)
    dev = resolve_device(device)
    be = resolve_backend(cfg.backend, device=dev)
    centers, masses, qs, iters = [], [], [], []
    with obs.span("tenant.fit", labels={"tenants": str(t)},
                  mode="looped"):
        for i, x in enumerate(xs):
            n_b = geom_bucket(x.shape[0], base=cfg.row_base,
                              factor=cfg.row_factor)
            w = np.zeros((n_b,), np.float32)
            w[:x.shape[0]] = 1.0
            xt, wt = as_real(pad_rows(x, n_b), dev), as_real(w, dev)
            m = float(m_all[i])
            res = _converge(lambda v: be.sweep(xt, wt, v, m),
                            as_real(seeds[i], dev), eps=cfg.eps,
                            max_iter=cfg.max_iter)
            obs.counter("tenant.fit.launches").add(1)
            centers.append(res.summary.centers.cpu().numpy())
            masses.append(res.summary.masses.cpu().numpy())
            qs.append(float(res.objective))
            iters.append(res.n_iter)
    return tenant_set(ids, np.stack(centers), np.stack(masses),
                      objective=np.asarray(qs, np.float32),
                      n_iter=np.asarray(iters, np.int32))

