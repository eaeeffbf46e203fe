"""Fuzzy C-Means — the Kolen–Hutcheson O(n·c) single-pass formulation.

Counterpart of `repro.core.fcm`: paper Algorithm 1.  The N×C membership
matrix is never stored across iterations; each sweep recomputes u_ik^m
and accumulates the weighted center numerators and denominators.  Plain
FCM is the ``point_weights=None`` case; WFCM (paper Eq. 2) is the same
code with weights.  The sweep math and the convergence loop live in
`repro_torch.engine`; this module is the paper-facing API.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..device import real_dtype
from ..engine.backend import (_D2_FLOOR, BackendLike, fcm_sweep,
                              hard_assign, membership_terms,
                              pairwise_sqdist, soft_assign)
from ..engine.merge import fcm_converge, fcm_converge_batched

__all__ = [
    "FCMResult", "fcm", "wfcm", "fcm_batched", "fcm_sweep",
    "membership_terms",
    "pairwise_sqdist", "soft_assign", "hard_assign", "_D2_FLOOR",
]


class FCMResult(NamedTuple):
    centers: torch.Tensor         # (C, d) final centers
    center_weights: torch.Tensor  # (C,)  Σ_k w_k·u_ik^m  (paper Eq. 6)
    n_iter: int                   # sweeps to convergence
    objective: torch.Tensor       # () final objective value


def fcm(
    x,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    point_weights=None,
    backend: BackendLike = None,
    device: Union[str, torch.device] = "cuda",
) -> FCMResult:
    """Run (weighted) FCM to convergence on ``device``.

    Stopping rule is the paper's: max_i ‖V_i,new − V_i,old‖² ≤ ε, capped
    at ``max_iter`` sweeps.  ``backend`` names the sweep implementation
    (``"torch"``, ``"hopper"``, …), is a `SweepBackend`, or is
    None/"auto" for the device's default.
    """
    res = fcm_converge(x, init_centers, m=m, eps=eps, max_iter=max_iter,
                       point_weights=point_weights, backend=backend,
                       device=device)
    return FCMResult(res.summary.centers, res.summary.masses,
                     res.n_iter, res.objective)


wfcm = fcm  # WFCM == FCM with point_weights (paper Eq. 2)


def fcm_batched(
    x,
    init_centers,
    *,
    m=2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    point_weights=None,
    backend: BackendLike = None,
    device: Union[str, torch.device] = "cuda",
) -> FCMResult:
    """T independent (weighted) FCM fits run together on ``device``.

    ``x`` is a tenant-stacked (T, N, d) block (ragged per-tenant row
    counts ride in as zero-weight phantom padding via
    ``point_weights``), ``init_centers`` (T, C, d), ``m`` a scalar or a
    (T,) per-tenant array.  Every field of the returned `FCMResult`
    carries the leading T axis, ``n_iter`` included; each tenant's
    trajectory matches its own `fcm` run (see
    `repro_torch.engine.merge.fcm_converge_batched`)."""
    x = torch.as_tensor(x, dtype=real_dtype())
    w = (torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
         if point_weights is None else point_weights)
    v, masses, q, n_iter = fcm_converge_batched(
        x, w, init_centers, m=m, eps=eps, max_iter=max_iter,
        backend=backend, device=device)
    return FCMResult(v, masses, n_iter, q)
