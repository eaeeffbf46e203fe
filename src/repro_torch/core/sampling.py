"""Sample-size selection for the BigFCM driver (paper Eqs. 3–4).

The port's own copy of `repro.core.sampling` (pure Python).

Thompson's multinomial-proportion bound gives the worst-case sample size;
Parker & Hall's form λ = v(α)·c²/r² adapts it to c clusters with relative
class-proportion difference r.  The paper uses this ONLY as an estimation
facilitator for the driver pre-clustering, never as the final answer —
so do we.
"""
from __future__ import annotations

import math

# v(α) table published by Thompson (1987), Table 1 — worst-case z²·p(1−p)/d²
# coefficient as a function of the confidence level α.
_THOMPSON_V = {
    0.50: 0.44129,
    0.40: 0.50729,
    0.30: 0.60123,
    0.20: 0.74739,
    0.10: 1.00635,
    0.05: 1.27359,
    0.025: 1.55963,
    0.02: 1.65872,
    0.01: 1.96986,
    0.005: 2.28514,
    0.001: 3.02892,
    0.0005: 3.33530,
    0.0001: 4.11209,
}


def thompson_v(alpha: float) -> float:
    """v(α) with conservative (next-smaller-α) lookup for off-table values."""
    if alpha in _THOMPSON_V:
        return _THOMPSON_V[alpha]
    usable = sorted(a for a in _THOMPSON_V if a <= alpha)
    if not usable:
        raise ValueError(f"alpha={alpha} below table range")
    return _THOMPSON_V[max(usable)]


def thompson_sample_size(num_classes: int, d: float, alpha: float = 0.05) -> int:
    """Paper Eq. (3): worst-case multinomial sample size.

    d is the max absolute deviation of any class proportion.  The worst
    case over the true proportions is p(1−p) at p = 1/μ for μ ≥ 2 … but
    Thompson showed the global worst case is captured by v(α); we keep the
    explicit Eq. (3) form for fidelity.
    """
    mu = max(int(num_classes), 2)
    # two-sided z for α/(2μ) tail
    z = _norm_ppf(1.0 - alpha / (2.0 * mu))
    p = 1.0 / mu
    return max(1, math.ceil(z * z * p * (1.0 - p) / (d * d)))


def parker_hall_sample_size(num_clusters: int, r: float, alpha: float = 0.05) -> int:
    """Paper Eq. (4): λ = v(α)·c²/r².

    Example from the paper: c=5, r=0.10, α=0.05 → 1.27359·25/0.01 ≈ 3184.
    """
    lam = thompson_v(alpha) * (num_clusters ** 2) / (r ** 2)
    return max(1, math.ceil(lam))


def _norm_ppf(q: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation);
    avoids a scipy dependency, |err| < 1.15e-9 over (0,1)."""
    if not 0.0 < q < 1.0:
        raise ValueError("q must be in (0,1)")
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        u = math.sqrt(-2 * math.log(q))
        return (((((c[0]*u+c[1])*u+c[2])*u+c[3])*u+c[4])*u+c[5]) / \
               ((((d[0]*u+d[1])*u+d[2])*u+d[3])*u+1)
    if q > phigh:
        u = math.sqrt(-2 * math.log(1 - q))
        return -(((((c[0]*u+c[1])*u+c[2])*u+c[3])*u+c[4])*u+c[5]) / \
               ((((d[0]*u+d[1])*u+d[2])*u+d[3])*u+1)
    u = q - 0.5
    t = u * u
    return (((((a[0]*t+a[1])*t+a[2])*t+a[3])*t+a[4])*t+a[5])*u / \
           (((((b[0]*t+b[1])*t+b[2])*t+b[3])*t+b[4])*t+1)
