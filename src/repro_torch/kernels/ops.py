"""Public kernel entries and the ``hopper`` engine backends.

Counterpart of `repro.kernels.ops`.  Importing it registers two
backends with `repro_torch.engine`:

  ``hopper``            — the fused sweep (`fcm_sweep_cuda`), and for a
                          tenant-stacked batch the fused batched sweep
                          (`fcm_sweep_batched_cuda`);
  ``hopper_accumulate`` — the raw-accumulator entries plus an
                          out-of-kernel normalization, so a whole-sweep
                          consumer and a chunked-accumulate consumer see
                          the same per-chunk sums.

The kernel picks its own tile from the shape (`fcm_update._plan`); the
reference's autotuned block sizes come with the perf slice.  On a CUDA
tensor the kernel launches or raises; a CPU tensor takes the plain
version.
"""
from __future__ import annotations

import torch

from ..engine.backend import (SweepBackend, normalize_accumulators,
                              register_backend)
from .fcm_update import (_D2_FLOOR, fcm_accumulate_batched_cuda,
                         fcm_accumulate_cuda, fcm_sweep_batched_cuda,
                         fcm_sweep_cuda)

fcm_sweep_kernel = fcm_sweep_cuda
fcm_accumulate_kernel = fcm_accumulate_cuda


def accumulate_chunks(chunks, weights, centers, m: float = 2.0):
    """One FCM sweep over a stream of chunks without materializing it.

    ``chunks``/``weights`` are iterables of (n_i, d)/(n_i,) tensors.  Per
    chunk the kernel emits raw accumulators; they sum elementwise across
    chunks and normalize once — a single sweep over the concatenation up
    to float32 summation order.  Returns (v_new, w_i, q)."""
    v_num, w_i, q = None, None, None
    for x, w in zip(chunks, weights, strict=True):
        vn, wi, qi = fcm_accumulate_kernel(x, w, centers, m)
        if v_num is None:
            v_num, w_i, q = vn, wi, qi
        else:
            v_num, w_i, q = v_num + vn, w_i + wi, q + qi
    if v_num is None:
        raise ValueError("accumulate_chunks: empty chunk stream")
    return v_num / torch.clamp(w_i, min=_D2_FLOOR)[:, None], w_i, q


class HopperBackend(SweepBackend):
    """The Hopper kernels' fused sweeps."""

    name = "hopper"
    kernel = True

    def accumulate(self, x, w, centers, m):
        return fcm_accumulate_kernel(x, w, centers, m)

    def sweep(self, x, w, centers, m):
        return fcm_sweep_kernel(x, w, centers, m)

    def batched_accumulate(self, x, w, centers, m):
        return fcm_accumulate_batched_cuda(x, w, centers, m)

    def batched_sweep(self, x, w, centers, m):
        return fcm_sweep_batched_cuda(x, w, centers, m)


class HopperAccumulateBackend(SweepBackend):
    """The kernels' raw-accumulator entries; its sweeps normalize outside
    the kernels."""

    name = "hopper_accumulate"
    kernel = True

    def accumulate(self, x, w, centers, m):
        return fcm_accumulate_kernel(x, w, centers, m)

    def sweep(self, x, w, centers, m):
        return normalize_accumulators(
            *fcm_accumulate_kernel(x, w, centers, m))

    def batched_accumulate(self, x, w, centers, m):
        return fcm_accumulate_batched_cuda(x, w, centers, m)


register_backend(HopperBackend())
register_backend(HopperAccumulateBackend())
