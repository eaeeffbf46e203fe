"""Sweep backends — the one place the Kolen–Hutcheson sweep is chosen.

Counterpart of `repro.engine.backend`.  Every layer (driver race,
combiner, reducer, WFCMPB blocks) runs one primitive, the O(n·c)
accumulation sweep (paper Alg. 1 body): recompute the membership term
u_ik^m on the fly and accumulate ``V_i += w_k·u_ik^m·x_k``,
``W_i += w_k·u_ik^m``.  A *backend* is an implementation of it,
selected once by name:

  ``torch``             — f32 eager PyTorch, the port's oracle (the
                          reference's ``jnp``).  It runs its matmuls in
                          IEEE fp32: the d² = x² + v² − 2·x·vᵀ
                          cancellation cannot afford TF32, so the
                          backend sets ``torch.backends.cuda.matmul.
                          allow_tf32 = False`` before it runs.
  ``hopper``            — the hand-written Hopper kernel's fused sweep
                          (`repro_torch.kernels.ops`).
  ``hopper_accumulate`` — the kernel's raw-accumulator entry plus an
                          out-of-kernel normalization.

Every backend also has the tenant-stacked entries ``batched_accumulate``
/ ``batched_sweep``: T independent models, x (T, N, d), w (T, N),
centers (T, C, d), m a scalar or (T,), in one call.

``resolve_backend(None | "auto", device=...)`` picks by device: a CUDA
device gets ``hopper``, a CPU device ``torch``.  The reference's
measured calibration race (`repro.perf.calibrate`) is not ported yet,
nor is the bf16 backend.  Of the reference's two ``obs.warn_once``
calls here, the one announcing a fallback to ``jnp`` has no counterpart
(the port never falls back: a kernel that cannot run raises), and the
calibration one comes with the race.
The kernel backends register from `repro_torch.kernels.ops`, which
`repro_torch.engine` imports outright: a kernel that cannot be built
on a CUDA host makes the fit raise, never degrade.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..device import real_dtype

_D2_FLOOR = 1e-12  # distance floor: a record sitting exactly on a center


# ------------------------------------------------------------ sweep math ---

def pairwise_sqdist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """‖x−v‖² via the matmul expansion x² + v² − 2·x·vᵀ.  x (…, N, d),
    centers (…, C, d) → (…, N, C); leading axes (tenants) batch."""
    x = x.to(real_dtype())
    centers = centers.to(real_dtype())
    x2 = torch.sum(x * x, dim=-1, keepdim=True)          # (…, N, 1)
    v2 = torch.sum(centers * centers, dim=-1)[..., None, :]  # (…, 1, C)
    cross = x @ centers.transpose(-1, -2)                # (…, N, C)
    return torch.clamp(x2 + v2 - 2.0 * cross, min=_D2_FLOOR)


def _u_from_d2(d2: torch.Tensor, m: float) -> torch.Tensor:
    """Membership degrees u from the Eq.-5 ratio in log space with
    max-normalization (u_i = r_i/Σr_j, r_i = (d_min/d_i)^(1/(m−1)) ≤ 1),
    avoiding the d^(2/(m−1)) overflow/underflow for m near 1."""
    expo = 1.0 / (m - 1.0)
    logd = torch.log(d2)
    lmin = torch.min(logd, dim=-1, keepdim=True).values
    r = torch.exp(-expo * (logd - lmin))            # (N, C), in (0, 1]
    return r / torch.sum(r, dim=-1, keepdim=True)


def _um_from_d2(d2: torch.Tensor, m: float) -> torch.Tensor:
    """u^m — the membership *term* the sweep accumulates."""
    return torch.pow(_u_from_d2(d2, m), m)


def membership_terms(x, centers, m: float) -> torch.Tensor:
    """u_ik^m for every record/center pair.  x: (N,d), centers: (C,d) →
    (N,C).  The normalizing denominator is computed once per record —
    the O(n·c) trick of paper Eq. (5)."""
    return _um_from_d2(pairwise_sqdist(x, centers), m)


def fcm_accumulate(x, weights, centers, m):
    """Raw Alg.-1 accumulators (v_num, w_i, q) — normalization deferred.

    All three outputs are plain sums over records, so partial results
    from chunks add elementwise before a single normalization."""
    d2 = pairwise_sqdist(x, centers)
    wum = _um_from_d2(d2, m) * weights.to(d2.dtype)[:, None]  # w_k·u_ik^m
    w_i = torch.sum(wum, dim=0)                          # (C,)
    v_num = wum.T @ x.to(d2.dtype)                       # (C, d)
    q = torch.sum(wum * d2)                              # objective, Eq. (2)
    return v_num, w_i, q


def _batched_m(m, x: torch.Tensor):
    """``m`` for the tenant-stacked math: a number stays a number; one
    fuzzifier per tenant becomes an f32 (T, 1, 1) column that broadcasts
    through `_u_from_d2` / `_um_from_d2`."""
    if isinstance(m, (int, float)):
        return float(m)
    m = torch.as_tensor(m, dtype=x.dtype, device=x.device)
    return m if m.dim() == 0 else m.reshape(-1, 1, 1)


def fcm_accumulate_batched(x, weights, centers, m):
    """Alg.-1 accumulators over a leading tenant axis.

    ``x`` (T, N, d), ``weights`` (T, N), ``centers`` (T, C, d), ``m``
    scalar or (T,) → per-tenant (v_num (T, C, d), w_i (T, C), q (T,)).
    The N axis is a shared shape bucket: per-tenant row counts n_t ≤ N
    ride in as zero-weight phantom padding (`data.plane.pad_rows`), so
    padding is a no-op in every accumulator."""
    x = x.to(real_dtype())
    d2 = pairwise_sqdist(x, centers)                     # (T, N, C)
    wum = _um_from_d2(d2, _batched_m(m, x)) * weights.to(x.dtype)[..., None]
    w_i = torch.sum(wum, dim=1)                          # (T, C)
    v_num = wum.transpose(1, 2) @ x                      # (T, C, d)
    q = torch.sum(wum * d2, dim=(1, 2))                  # (T,)
    return v_num, w_i, q


def normalize_accumulators(v_num, w_i, q):
    """The one deferred normalization: (v_num, w_i, q) → (v_new, w_i, q)."""
    return v_num / torch.clamp(w_i, min=_D2_FLOOR)[..., None], w_i, q


def fcm_sweep(x, weights, centers, m):
    """One full accumulation sweep (Alg. 1 body).  Returns (V_new, W, Q)."""
    return normalize_accumulators(*fcm_accumulate(x, weights, centers, m))


def soft_assign(x, centers, m: float = 2.0) -> torch.Tensor:
    """Membership degrees u_ik (not raised to m), in the log-space form
    the sweep itself accumulates."""
    return _u_from_d2(pairwise_sqdist(x, centers), m)


def hard_assign(x, centers) -> torch.Tensor:
    return torch.argmin(pairwise_sqdist(x, centers), dim=-1)


# -------------------------------------------------------------- backends ---

class SweepBackend:
    """One implementation of the accumulation sweep.

    Subclasses provide ``accumulate`` (raw sums) and may override
    ``sweep`` with a fused version.  Every method computes on the device
    its tensors lie on."""

    name: str = "?"

    def accumulate(self, x, w, centers, m):
        """Raw (v_num, w_i, q) accumulators for one record chunk."""
        raise NotImplementedError

    def sweep(self, x, w, centers, m):
        """(v_new, w_i, q): accumulate + the one deferred normalization."""
        return normalize_accumulators(*self.accumulate(x, w, centers, m))

    def batched_accumulate(self, x, w, centers, m):
        """Raw accumulators for a tenant-stacked batch: ``x`` (T, N, d),
        ``w`` (T, N), ``centers`` (T, C, d), ``m`` scalar or (T,) →
        per-tenant (v_num, w_i, q) with leading T.  Default:
        `torch.func.vmap` of ``accumulate``, as the reference vmaps its
        backends; a backend with a batched kernel overrides this."""
        in_m = 0 if torch.as_tensor(m).dim() else None
        return torch.func.vmap(self.accumulate, in_dims=(0, 0, 0, in_m))(
            x, w, centers, m)

    def batched_sweep(self, x, w, centers, m):
        """Tenant-stacked sweep: batched accumulate + the per-tenant
        deferred normalization."""
        return normalize_accumulators(*self.batched_accumulate(
            x, w, centers, m))

    def soft_assign(self, x, centers, m=2.0):
        return soft_assign(x, centers, m)

    def hard_assign(self, x, centers):
        return hard_assign(x, centers)

    def __repr__(self):
        return f"<SweepBackend {self.name}>"


class TorchBackend(SweepBackend):
    """Eager PyTorch in `real_dtype` (f32 unless raised to f64) — the CPU
    default and the oracle."""

    name = "torch"

    def accumulate(self, x, w, centers, m):
        torch.backends.cuda.matmul.allow_tf32 = False   # IEEE fp32 matmuls
        return fcm_accumulate(x, w, centers, m)

    def batched_accumulate(self, x, w, centers, m):
        torch.backends.cuda.matmul.allow_tf32 = False
        return fcm_accumulate_batched(x, w, centers, m)


_REGISTRY: Dict[str, SweepBackend] = {}

BackendLike = Union[None, str, SweepBackend]


def register_backend(backend: SweepBackend) -> SweepBackend:
    """Register (or replace) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


def available_backends() -> list:
    return sorted(_REGISTRY)


def get_backend(name: str) -> SweepBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown sweep backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def default_backend_name(device: Union[str, torch.device]) -> str:
    """The device rule behind "auto": CUDA → ``hopper``, CPU → ``torch``."""
    return "hopper" if torch.device(device).type == "cuda" else "torch"


def resolve_backend(spec: BackendLike = None, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> SweepBackend:
    """None/"auto" → the device rule for ``device``; str → registry;
    object → itself."""
    if isinstance(spec, SweepBackend):
        return spec
    if spec is None or spec == "auto":
        if device is None:
            raise ValueError("resolve_backend('auto') needs the device "
                             "the sweep runs on")
        return get_backend(default_backend_name(device))
    return get_backend(spec)


register_backend(TorchBackend())
