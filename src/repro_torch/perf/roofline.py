"""The roofline layer: the compiled-program half (the LM dry run's time
terms) and the sweep's analytic model and achieved-vs-peak.

Counterpart of `repro.perf.roofline`:

  * the **program roofline**: the `Roofline` dataclass with its
    compute / memory / collective time terms under this card's rates
    (`PEAK_FLOPS`, `HBM_BW`, `LINK_BW`), `collective_bytes` over the
    c10d calls a traced step made (where the reference parses post-SPMD
    HLO), `compiled_cost` and `analyze` (`repro_torch.launch.dryrun`
    traces the step, `repro_torch.launch.roofline.ProgramTrace`);

  * the **analytic per-kernel model**: `sweep_flops` / `sweep_bytes`
    count the O(n·c) FCM accumulation sweep exactly — two (N, C, d)
    contractions plus O(N·C) elementwise membership work;
  * **achieved-vs-peak**: `kernel_roofline` times one registered sweep
    backend at a shape, divides the analytic FLOPs and bytes by measured
    wall time, and reports the fraction of the *probed* peaks
    (`repro_torch.perf.microbench`) each rate reaches, the analytic
    roofline bound at those peaks and the fraction of it achieved;
    `roofline_report` fans this over backends × a shape ladder.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "Roofline",
           "collective_bytes", "compiled_cost", "analyze", "COLLECTIVES",
           "collective_kind", "sweep_flops", "sweep_bytes",
           "sweep_intensity", "kernel_roofline", "roofline_report"]

DeviceLike = Union[str, torch.device]

# ------------------------------------------- the program roofline -------

# The card's rates, per card: NVIDIA H100 SXM5 80GB HBM3, 700 W.
# Dense bf16 tensor-core peak (NVIDIA's H100 datasheet, without
# sparsity); chip_smoke.py's BF16_PEAK_FLOP_PER_S.
PEAK_FLOPS = 989e12          # FLOP/s
# HBM3 bandwidth (the same datasheet); chip_smoke.py's PEAK_BYTES_PER_S.
HBM_BW = 3.35e12             # B/s
# One card's network link: 400 Gb/s NDR InfiniBand (ConnectX-7, one per
# card in an 8-card HGX node).  Every axis of the production meshes
# crosses it: the 16×16 mesh's "model" axis is 16 consecutive ranks, so
# it spans two 8-card NVLink nodes, and "data" and "pod" stride across
# nodes; NVLink's 450 GB/s a direction is the rate of no axis.
LINK_BW = 50e9               # B/s

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op → (kind, index of its result argument, index of its operand
# argument): the reduce / broadcast ops work in place on their tensors
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "allgather_": ("all-gather", 0, 1),
    "_allgather_base_": ("all-gather", 0, 1),
    "allgather_coalesced_": ("all-gather", 0, 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "reduce_scatter_": ("reduce-scatter", 0, 1),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "alltoall_": ("all-to-all", 0, 1),
    "alltoall_base_": ("all-to-all", 0, 1),
    "broadcast_": ("collective-permute", 0, 0),
    "send": ("collective-permute", 0, 0),
    "recv_": ("collective-permute", 0, 0),
}


def collective_kind(op_name: str):
    """(kind, result arg, operand arg) of a c10d op by its name (``
    "allgather_"``), or None for one that moves no payload (a barrier,
    a monitored barrier).  An op of no known kind raises: an uncounted
    collective would understate the term."""
    if op_name in _C10D:
        return _C10D[op_name]
    if "barrier" in op_name:
        return None
    raise KeyError(f"c10d op {op_name!r} of no known collective kind")


def collective_bytes(calls) -> Dict[str, int]:
    """Bytes by collective kind of the c10d calls a traced step made —
    ``calls`` an iterable of (kind, operand bytes, result bytes) — each
    call counted as the larger of its operand and its result (the
    reference's convention for an HLO collective).  The port's own
    collectives count as what they are on the wire: `mesh.psum` an
    all-gather of every member's payload, `mesh.reduce_scatter` an
    all-to-all, a 16-bit payload its bytes."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, operand, result in calls:
        out[kind] += max(int(operand), int(result))
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device
    hbm_bytes: float             # per-device
    coll_bytes: float            # per-device
    coll_breakdown: Dict[str, int]
    model_flops: float           # 6·N_active·D global (useful FLOPs)
    n_devices: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total program FLOPs (global)."""
        tot = self.flops * self.n_devices
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound (upper bound on
        achievable MFU for this program)."""
        denom = self.t_bound * self.n_devices * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def compiled_cost(trace) -> Dict[str, float]:
    """{"flops": the FLOPs counted over the traced step (its matmuls and
    convolutions, ``FlopCounterMode``'s formulas), "bytes_accessed": the
    operand and result bytes of every op it dispatched} — the traffic of
    the unfused eager program; ``trace`` a
    `repro_torch.launch.roofline.ProgramTrace`."""
    return {"flops": float(trace.flops),
            "bytes_accessed": float(trace.bytes_accessed)}


def analyze(trace, model_flops: float, n_devices: int, *,
            analytic_flops: float, analytic_bytes: float) -> Roofline:
    """Compute and memory terms from the analytic model
    (`launch.flops_model`: a per-device share of the step's FLOPs and
    device-memory bytes); the collective term from the c10d calls the
    traced step made (`collective_bytes`)."""
    coll = collective_bytes(trace.calls)
    return Roofline(flops=analytic_flops / n_devices,
                    hbm_bytes=analytic_bytes / n_devices,
                    coll_bytes=float(sum(coll.values())),
                    coll_breakdown=coll, model_flops=model_flops,
                    n_devices=n_devices)


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
