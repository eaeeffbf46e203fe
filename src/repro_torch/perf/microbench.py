"""Empirical peak probes (ERT-style) and the one timing harness.

Counterpart of `repro.perf.microbench`.  The device's peaks are
measured, not read off a datasheet: a streaming-bandwidth triad
(``y = a·x + y``, the Berkeley ERT KERNEL2 shape) probes bytes/s and a
square matmul probes FLOPs/s, each over a small ladder of sizes with the
best result kept (ERT's "repeat and take the max" rule: a probe can only
under-estimate the roof).  `repro_torch.perf.roofline` divides achieved
rates by these, and `repro_torch.perf.calibrate` stores them in the
calibration file so the probe runs once per machine.

The f32 matmul probe runs with ``torch.backends.cuda.matmul.allow_tf32``
False, so its peak is an IEEE f32 peak, not a TF32 one (the port's
precision rule).  The bf16 probe takes bf16 inputs with an f32 result
(`repro_torch.engine.backend.mm_f32`), the contraction the
``torch_bf16`` backend runs.  The default ladders are the reference's;
they are far too small to reach an H100's peaks, so a caller that wants
the card's roofs passes bigger ones (2²⁶ floats, n = 8192).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable, Union

import torch

from ..device import resolve_device
from ..engine.backend import mm_f32

__all__ = ["time_fn", "probe_stream_bandwidth", "probe_matmul_flops",
           "probe_peaks"]

DeviceLike = Union[str, torch.device]


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-seconds of ``fn(*args)``, the device of the tensor
    arguments synchronized before and after each call.

    ``warmup`` calls are excluded (a kernel's build at its first launch,
    like a compile, is a one-off a deployed fit pays once; the race
    compares steady-state sweeps)."""
    dev = _device_of(args)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(max(warmup, 0)):
        fn(*args)
        sync()
    times = []
    for _ in range(max(iters, 1)):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def _ieee_f32():
    """IEEE f32 matmuls for the duration (no TF32)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def probe_stream_bandwidth(n_floats: int = 1 << 22, *, iters: int = 3,
                           device: DeviceLike = "cuda") -> float:
    """Achievable streaming bandwidth (bytes/s) via the f32 triad
    ``out = 1.5·x + y``: reads two arrays, writes one ⇒ 12 bytes per
    element.  One fused kernel (``torch.add`` with ``alpha``), as the
    reference's jitted triad is: ``1.5 * x + y`` in eager PyTorch would
    be two kernels moving 20 bytes per element."""
    dev = resolve_device(device)
    x = (torch.arange(n_floats, dtype=torch.float32, device=dev) % 97.0
         ) * 0.25
    y = torch.ones((n_floats,), dtype=torch.float32, device=dev)
    t = time_fn(lambda a, b: torch.add(b, a, alpha=1.5), x, y, iters=iters)
    return 3.0 * 4.0 * n_floats / t


def probe_matmul_flops(n: int = 512, dtype=torch.float32, *,
                       iters: int = 3, device: DeviceLike = "cuda") -> float:
    """Achievable matmul FLOPs/s: (n, n)·(n, n) with an f32 result,
    2·n³ FLOPs — the contraction the sweep's two matmuls lower to."""
    dev = resolve_device(device)
    a = ((torch.arange(n * n, dtype=torch.float32, device=dev) % 13.0)
         / 13.0).reshape(n, n)
    b = ((torch.arange(n * n, dtype=torch.float32, device=dev) % 7.0)
         / 7.0).reshape(n, n)
    if dtype == torch.bfloat16:
        a, b = a.to(dtype), b.to(dtype)
        f = mm_f32
    else:
        f = torch.mm
    with _ieee_f32():
        t = time_fn(f, a, b, iters=iters)
    return 2.0 * float(n) ** 3 / t


def probe_peaks(*, stream_floats: Iterable[int] = (1 << 21, 1 << 22),
                matmul_ns: Iterable[int] = (256, 512), iters: int = 3,
                device: DeviceLike = "cuda") -> dict:
    """Run every probe over its size ladder; keep the best (ERT rule).

    Returns the dict the calibration file stores under ``"peaks"``."""
    dev = resolve_device(device)
    stream_floats, matmul_ns = list(stream_floats), list(matmul_ns)
    bw = max(probe_stream_bandwidth(s, iters=iters, device=dev)
             for s in stream_floats)
    f32 = max(probe_matmul_flops(n, torch.float32, iters=iters, device=dev)
              for n in matmul_ns)
    bf16 = max(probe_matmul_flops(n, torch.bfloat16, iters=iters,
                                  device=dev) for n in matmul_ns)
    return {
        "stream_bytes_per_s": bw,
        "matmul_f32_flops_per_s": f32,
        "matmul_bf16_flops_per_s": bf16,
        "probe": {"stream_floats": stream_floats, "matmul_ns": matmul_ns,
                  "iters": iters, "platform": dev.type},
    }
