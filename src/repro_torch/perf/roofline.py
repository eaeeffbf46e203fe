"""The sweep's roofline: its analytic model and achieved-vs-peak.

Counterpart of the sweep half of `repro.perf.roofline`:

  * the **analytic per-kernel model**: `sweep_flops` / `sweep_bytes`
    count the O(n·c) FCM accumulation sweep exactly — two (N, C, d)
    contractions plus O(N·C) elementwise membership work;
  * **achieved-vs-peak**: `kernel_roofline` times one registered sweep
    backend at a shape, divides the analytic FLOPs and bytes by measured
    wall time, and reports the fraction of the *probed* peaks
    (`repro_torch.perf.microbench`) each rate reaches, the analytic
    roofline bound at those peaks and the fraction of it achieved;
    `roofline_report` fans this over backends × a shape ladder.

The reference's TPU v5e datasheet constants and its compiled-program
half (``Roofline``, ``collective_bytes``, ``compiled_cost``,
``analyze``) serve the LM dry run and come with that stack.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["sweep_flops", "sweep_bytes", "sweep_intensity",
           "kernel_roofline", "roofline_report"]

DeviceLike = Union[str, torch.device]


# ------------------------------------------ FCM sweep analytic model -----

def sweep_flops(n: int, c: int, d: int) -> float:
    """FLOPs of one `fcm_accumulate` sweep at (N, C, d).

    Exact for the implemented math: the two (N,C,d) contractions
    (distance cross term ``x·vᵀ`` and numerator ``(w·u^m)ᵀ·x``, 2·N·C·d
    each), the squared-norm terms (2·N·d + 2·C·d), distance assembly
    (3·N·C), the log-space membership (log, exp, div, pow, min —
    counted 1 FLOP per transcendental, ≈8·N·C), and the three
    accumulator reductions (≈3·N·C)."""
    return (4.0 * n * c * d          # the two contractions
            + 2.0 * n * d + 2.0 * c * d
            + 14.0 * n * c)          # d2 + membership + reductions


def sweep_bytes(n: int, c: int, d: int, *, in_bytes: int = 4) -> float:
    """Minimum device-memory traffic of one sweep: stream X and w once,
    read V, write the three accumulators once.  The (N, C) membership
    matrix is *not* counted — a backend that spills it shows up as
    achieved-bytes ≫ this model (fraction > 1), a finding, not an
    error."""
    return (n * d * in_bytes + n * in_bytes       # X, w streamed
            + c * d * in_bytes                    # V resident, read once
            + (c * d + c + 1) * 4.0)              # v_num, w_i, q written


def sweep_intensity(n: int, c: int, d: int, *, in_bytes: int = 4) -> float:
    """Arithmetic intensity (FLOP/byte) — ≈ C for d ≫ 1."""
    return sweep_flops(n, c, d) / sweep_bytes(n, c, d, in_bytes=in_bytes)


# ------------------------------------------------ achieved vs peak -------

def _race_data(n: int, c: int, d: int, seed: int = 0,
               device: DeviceLike = "cpu"):
    """The race's inputs: the reference's numpy draws, on ``device``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    v = rng.normal(size=(c, d)).astype(np.float32)
    dev = torch.device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, w, v))


def kernel_roofline(backend, shape, *, peaks: Optional[dict] = None,
                    m: float = 2.0, warmup: int = 1, iters: int = 3,
                    in_bytes: int = 4, device: DeviceLike = "cuda",
                    data: Optional[tuple] = None) -> dict:
    """Measure one backend's sweep at ``shape=(n, c, d)`` on ``device``
    against the analytic model and the probed peaks.

    Returns a flat row: measured seconds, achieved FLOPs/s and bytes/s
    (analytic work ÷ wall time), fraction of probed matmul/stream peaks,
    the analytic roofline bound at those peaks, and the fraction of that
    bound achieved.  ``backend`` is a name or SweepBackend.  ``data``
    ``(x, w, centers)`` of that shape, already on the device, replaces
    the race's draws (a caller holding full-size records saves drawing
    them again)."""
    from ..engine.backend import resolve_backend
    from .microbench import probe_peaks, time_fn

    dev = resolve_device(device)
    be = resolve_backend(backend, device=dev) if not hasattr(
        backend, "sweep") else backend
    peaks = peaks if peaks is not None else probe_peaks(iters=iters,
                                                        device=dev)
    n, c, d = (int(s) for s in shape)
    x, w, v = data if data is not None else _race_data(n, c, d, device=dev)
    t = time_fn(lambda a, b, v0: be.sweep(a, b, v0, m), x, w, v,
                warmup=warmup, iters=iters)

    flops, nbytes = sweep_flops(n, c, d), sweep_bytes(n, c, d,
                                                      in_bytes=in_bytes)
    peak_flops = peaks["matmul_bf16_flops_per_s"] \
        if be.name.endswith("bf16") else peaks["matmul_f32_flops_per_s"]
    peak_bw = peaks["stream_bytes_per_s"]
    t_compute, t_memory = flops / peak_flops, nbytes / peak_bw
    t_bound = max(t_compute, t_memory)
    return {
        "backend": be.name,
        "platform": dev.type,
        "n": n, "c": c, "d": d,
        "seconds": t,
        "records_per_s": n / t,
        "achieved_flops_per_s": flops / t,
        "achieved_bytes_per_s": nbytes / t,
        "frac_of_peak_flops": (flops / t) / peak_flops,
        "frac_of_peak_bw": (nbytes / t) / peak_bw,
        "intensity_flop_per_byte": flops / nbytes,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "t_bound_s": t_bound,
        "frac_of_bound": t_bound / t,
    }


def roofline_report(shapes: Sequence = ((16_384, 8, 16), (16_384, 64, 64)),
                    *, backends: Optional[Sequence[str]] = None,
                    peaks: Optional[dict] = None, m: float = 2.0,
                    iters: int = 3, device: DeviceLike = "cuda") -> dict:
    """Achieved-vs-peak rows for every registered backend × shape; a
    backend that cannot run a shape is a row with its error, not a
    crash."""
    from ..engine.backend import available_backends
    from .microbench import probe_peaks

    dev = resolve_device(device)
    peaks = peaks if peaks is not None else probe_peaks(iters=iters,
                                                        device=dev)
    names = list(backends) if backends is not None else \
        available_backends()
    rows = []
    for shape in shapes:
        for name in names:
            try:
                rows.append(kernel_roofline(name, shape, peaks=peaks, m=m,
                                            iters=iters, device=dev))
            except Exception as e:
                rows.append({"backend": name, "platform": dev.type,
                             "n": shape[0], "c": shape[1], "d": shape[2],
                             "error": repr(e)})
    return {"peaks": peaks, "rows": rows}
