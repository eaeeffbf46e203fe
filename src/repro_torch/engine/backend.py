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
  ``torch_bf16``        — mixed precision (the reference's
                          ``jnp_bf16``): the two (N,C,d) contractions
                          take bf16 inputs with f32 outputs; norms,
                          membership and accumulators stay f32.  It
                          enters the calibration race like every other
                          backend and is never the device default.
  ``hopper``            — the hand-written Hopper kernel's fused sweep
                          (`repro_torch.kernels.ops`).
  ``hopper_accumulate`` — the kernel's raw-accumulator entry plus an
                          out-of-kernel normalization.

Every backend also has the tenant-stacked entries ``batched_accumulate``
/ ``batched_sweep``: T independent models, x (T, N, d), w (T, N),
centers (T, C, d), m a scalar or (T,), in one call.

``resolve_backend(None | "auto", device=..., shape=...)`` selects by
measurement: the first "auto" per (device, shape bucket) runs a one-shot
timed race of the registered backends through
`repro_torch.perf.calibrate`, gated on parity against the ``torch``
oracle, and caches the winner on disk; later resolutions are a cache
hit.  On a CUDA device only the kernel backends (``kernel = True``) may
win, and one that fails parity raises: "auto" on the card always runs a
hand-written kernel.  The device rule (CUDA → ``hopper``, CPU → ``torch``,
`default_backend_name`) is the fallback when calibration is disabled
(``REPRO_AUTO_CALIBRATE=0``) or the perf layer fails, which warns once
(``obs.warn_once``, as the reference does).  The fallback only changes
which backend is chosen: the reference's other ``warn_once`` (a fallback
from its kernels to ``jnp``) has no counterpart, since the port never
swaps a kernel for its plain version.  The kernel backends register from
`repro_torch.kernels.ops`, which `repro_torch.engine` imports outright:
a kernel that cannot be built on a CUDA host makes the fit raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from .. import obs
from ..device import real_dtype

_D2_FLOOR = 1e-12  # distance floor: a record sitting exactly on a center


# ------------------------------------------------------------ sweep math ---

def pairwise_sqdist(x: torch.Tensor, centers: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """‖x−v‖² via the matmul expansion x² + v² − 2·x·vᵀ in ``dtype``
    (default `real_dtype`).  x (…, N, d), centers (…, C, d) → (…, N, C);
    leading axes (tenants) batch."""
    dtype = dtype or real_dtype()
    x = x.to(dtype)
    centers = centers.to(dtype)
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


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with bf16 inputs and an f32 result (the reference's
    ``dot_general(..., preferred_element_type=f32)``), batched over
    leading axes.  On the card one bf16 tensor-core product with f32
    output (``out_dtype``); a plain ``@`` of two bf16 tensors would round
    its result to bf16 a second time.  On the CPU, which has no such
    kernel, the f32 product of the bf16-rounded inputs: each product of
    two bf16 values is exact in f32, the sums are f32."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        op = torch.mm if a.dim() == 2 else torch.bmm
        return op(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def fcm_accumulate_mixed(x, weights, centers, m):
    """Mixed-precision Alg.-1 accumulators: bf16 contractions, f32
    everything else (the reference's `fcm_accumulate_mixed`).

    The distance cross term x·vᵀ and the center numerators wumᵀ·x take
    bf16 inputs with f32 outputs (`mm_f32`); the squared norms, the
    membership and the three accumulators stay f32, so partials add like
    the f32 backend's.  d² = x² + v² − 2·x·vᵀ keeps f32 norms (bf16 ones
    would poison small distances); the cross term carries the precision
    loss, which the calibration race's parity gate bounds.  Leading axes
    of x (…, N, d), weights (…, N) and centers (…, C, d) batch
    (tenants), with ``m`` a number or a (T, 1, 1) column."""
    xf = x.to(torch.float32)
    vf = centers.to(torch.float32)
    x2 = torch.sum(xf * xf, dim=-1, keepdim=True)            # (…, N, 1)
    v2 = torch.sum(vf * vf, dim=-1)[..., None, :]            # (…, 1, C)
    cross = mm_f32(xf, vf.transpose(-1, -2))                 # (…, N, C)
    d2 = torch.clamp(x2 + v2 - 2.0 * cross, min=_D2_FLOOR)
    wum = _um_from_d2(d2, m) * weights.to(torch.float32)[..., None]
    w_i = torch.sum(wum, dim=-2)                             # (…, C)
    v_num = mm_f32(wum.transpose(-1, -2), xf)                # (…, C, d)
    q = torch.sum(wum * d2, dim=(-2, -1))                    # (…,)
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


def _scoring_dtype(x: torch.Tensor) -> torch.dtype:
    """The float type scoring forms d² in: float64 on the card, the
    working type elsewhere.  cuBLAS picks its f32 GEMM by the batch's row
    count, and the expansion's cancellation (‖x‖² ≫ d² for records far
    from the origin) turns those roundings into labels that change with
    the batch a record is scored in — a coalesced, padded service batch
    against the same record alone.  In float64 the two roundings sit
    about 1e-16 of ‖x‖² apart, so labels agree up to exact ties.  The
    CPU keeps the reference's f32 arithmetic."""
    return torch.float64 if x.device.type == "cuda" else real_dtype()


def soft_assign(x, centers, m: float = 2.0) -> torch.Tensor:
    """Membership degrees u_ik (not raised to m), in the log-space form
    the sweep itself accumulates, returned in `real_dtype`."""
    d2 = pairwise_sqdist(x, centers, _scoring_dtype(x))
    return _u_from_d2(d2, m).to(real_dtype())


def hard_assign(x, centers) -> torch.Tensor:
    """Argmin labels (`_scoring_dtype` says in which float type)."""
    return torch.argmin(pairwise_sqdist(x, centers, _scoring_dtype(x)),
                        dim=-1)


# -------------------------------------------------------------- backends ---

class SweepBackend:
    """One implementation of the accumulation sweep.

    Subclasses provide ``accumulate`` (raw sums) and may override
    ``sweep`` with a fused version.  Every method computes on the device
    its tensors lie on.  ``kernel`` marks a backend that launches a
    hand-written kernel on the card: only those may win the calibration
    race on a CUDA device."""

    name: str = "?"
    kernel: bool = False

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


class Bf16Backend(SweepBackend):
    """Mixed-precision sweep: bf16 contraction inputs, f32 accumulators
    (`fcm_accumulate_mixed`).  Enters the calibration race like every
    other backend and wins only where the card's bf16 path is faster AND
    the race's parity gate passes; it is never the device default."""

    name = "torch_bf16"

    def accumulate(self, x, w, centers, m):
        return fcm_accumulate_mixed(x, w, centers, m)

    def batched_accumulate(self, x, w, centers, m):
        return fcm_accumulate_mixed(x, w, centers, _batched_m(m, x))


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
    """The device rule: CUDA → ``hopper``, CPU → ``torch``.  A fallback
    only: "auto" picks by measured race (`repro_torch.perf.calibrate`)
    and lands here when calibration is disabled or the perf layer
    fails."""
    return "hopper" if torch.device(device).type == "cuda" else "torch"


def _calibrated_name(device, shape: Optional[Tuple[int, int, int]]
                     ) -> Optional[str]:
    """Measured winner via `repro_torch.perf.calibrate`, or None to fall
    back to the device rule (calibration disabled, or the perf layer
    failed — the latter warns once)."""
    from ..perf.calibrate import KernelParityError
    try:
        from ..perf.calibrate import calibrated_backend_name
        name = calibrated_backend_name(shape, device=device)
    except KernelParityError:
        raise
    except Exception as e:
        obs.warn_once(
            "perf_calibration_failed",
            "repro_torch.perf calibration failed — backend auto-selection "
            f"falling back to the device rule: {e!r}",
            stacklevel=3, error=repr(e))
        return None
    return name if name in _REGISTRY else None


def resolve_backend(spec: BackendLike = None, *,
                    device: Optional[Union[str, torch.device]] = None,
                    shape: Optional[Tuple[int, int, int]] = None
                    ) -> SweepBackend:
    """None/"auto" → the measured winner for ``device`` and ``shape``'s
    bucket (the device rule as fallback); str → registry; object →
    itself.  ``shape`` is ``(n_records, n_clusters, dim)``: pass it when
    known so the race runs in the caller's own bucket."""
    if isinstance(spec, SweepBackend):
        return spec
    if spec is None or spec == "auto":
        if device is None:
            raise ValueError("resolve_backend('auto') needs the device "
                             "the sweep runs on")
        name = _calibrated_name(device, shape)
        return get_backend(name or default_backend_name(device))
    return get_backend(spec)


def scoring_backend(spec: BackendLike = None, *,
                    device: Union[str, torch.device]) -> SweepBackend:
    """The backend a scorer calls ``hard_assign`` / ``soft_assign`` on:
    None/"auto" → the device rule, never the race (every registered
    backend scores with the same `hard_assign` / `soft_assign`, so a race
    would choose nothing); anything else as `resolve_backend`."""
    if spec is None or spec == "auto":
        return get_backend(default_backend_name(device))
    return resolve_backend(spec, device=device)


register_backend(TorchBackend())
register_backend(Bf16Backend())
