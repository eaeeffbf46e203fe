#!/usr/bin/env python3
"""Time the port's FCM sweep kernels at every shape the four runs of
chip_smoke.py launch them at, for one checkout of `repro_torch`, on one
NVIDIA card:

    python3 scripts/compare_kernels.py [--src DIR] [--label NAME]
                                       [--set all|ctiled]

DIR is the ``src`` directory that holds ``repro_torch`` (default: this
checkout's).  To compare two checkouts on one card, run it on each in
turns (A, B, B, A) within one session on the machine.  Prints one JSON
line per (kernel, shape): ``ms`` (20 full-size or 500 small back-to-back
launches captured in a CUDA graph, one pair of CUDA events around its
replay, divided by their count: the card's time without the host's
enqueue),
``ms_per_call`` (the median of events around single launches, as
PR 11/12's chip_smoke.py timed), then the card's ``nvidia-smi`` name and
power limit.  Inputs are made on the card from a fixed seed, identical
for every checkout.  Exits 1 without a card.

The C-tiled kernel (``csrc/fcm_ctiled.cu``) is timed at router_fit's
four shapes and chip_smoke.py's C-tiled checks (``--set ctiled`` times
these alone), with its launches timed apart (``launch_ms``, named as
chip_smoke.CTILED_STAGES names them), the
two library products of its halves (``member_library_ms``: x·vᵀ;
``contraction_library_ms``: wumᵀx; IEEE f32) and its bound; first its
``-Xptxas -v`` lines.  A source without ``fcm_ctiled_stage`` (the first
version's) is timed apart through a harness built beside it that
launches its kernels one at a time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# (kernel, run/shape label, N, d, C, m): chip_smoke.py's RUNS and every
# size their main paths launch at: the full size, the driver's 3184-row
# sample and 2048-row blocks, the 2·C- and C-point merges, and the
# objective over two blocks (4096 rows).
_RUNS = (("higgs_like", 28, 2, 2.0, 11_000_000),
         ("kdd99_like", 41, 23, 1.2, 4_898_431))
SINGLE = [("fcm_sweep", f"{run}/{label}", n, d, c, m)
          for run, d, c, m, full in _RUNS
          for label, n in (("full", full), ("sample", 3184), ("block", 2048),
                           ("merge", 2 * c), (f"n={c}", c))]
SINGLE += [("fcm_accumulate", f"{run}/{label}", n, d, c, m)
           for run, d, c, m, full in _RUNS
           for label, n in (("full", full), ("n=4096", 4096))]
# (run, T, N): the packed cohorts of chip_smoke.py's tenant runs, d = 4, C = 3.
BATCHED = [("tenants_t16", 1024, 32), ("tenants_65k", 65_536, 512)]
# The C-tiled kernel: router_fit's full size, WFCMPB block, 128-point merge
# and 64-point reducer (d = 2048, C = 64, m = 2), chip_smoke.py's
# CTILED_SHAPES, and K3 at its CTILED_TENANTS (T, N, d, C).
CTILED = [(f"router_fit/{label}", n, 2048, 64)
          for label, n in (("full", 262_144), ("block", 2048),
                           ("merge", 128), ("reducer", 64))]
CTILED += [(f"check/{n}x{d}x{c}", n, d, c)
           for n, d, c in ((4096, 900, 64), (4096, 2048, 64),
                           (1024, 7168, 384))]
CTILED_K3 = (3, 1000, 2048, 64)

# The first C-tiled version launches its three kernels from one C call;
# this harness, compiled with its source, launches one of them, numbered
# as chip_smoke.CTILED_STAGES numbers the current version's.
STAGE_HARNESS = r"""
#include "%s"
extern "C" int fcm_ctiled_stage(
    int stage, const float* x, const float* w, const float* v,
    const float* m_t, float m_s, long long n, int d, int c, int t0,
    int tenants, long long r0, int rows, int ld_rows, int splits,
    int resident, float* wum, float* qrow, float* part, float* out_v,
    float* out_w, float* out_q, int first, int finish, void* stream) {
  if (stage == 1) return 0;  // it has no membership finish
  stage -= stage > 1;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tn = t0;
  x += tn * n * d;
  w += tn * n;
  v += tn * c * d;
  if (m_t) m_t += t0;
  out_v += tn * c * d;
  out_w += tn * c;
  out_q += t0;
  if (stage == 0) {
    if (rows == 0) return 0;
    const int smem = (int)(member_floats(c, resident) * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        ctiled_member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ctiled_member_kernel<<<dim3((rows + kTR - 1) / kTR, tenants), kBlock, smem, s>>>(
        x, w, v, m_t, m_s, n, d, c, r0, rows, ld_rows, resident, wum, qrow);
  } else if (stage == 1) {
    const int blocks = ((c + kOC - 1) / kOC) * ((d + kOD - 1) / kOD);
    ctiled_contract_kernel<<<dim3(blocks, splits, tenants), kBlock, 0, s>>>(
        x, wum, qrow, n, d, c, r0, rows, ld_rows, splits, part);
  } else {
    ctiled_finish_kernel<<<dim3(c + 1, tenants), kBlock, 0, s>>>(
        part, splits, d, c, first, finish, out_v, out_w, out_q);
  }
  return (int)cudaGetLastError();
}
"""


def stage_function(F, build):
    """(``fcm_ctiled_stage`` of the checkout's C-tiled library, the
    ``-Xptxas -v`` lines of its build)."""
    import ctypes
    src = build.CSRC / "fcm_ctiled.cu"
    if b"fcm_ctiled_stage" in src.read_bytes():
        log = build.compile_source("fcm_ctiled", verbose=True)
        return F._ctiled_lib().fcm_ctiled_stage, log
    out = build.BUILD_DIR / "libfcm_ctiled_stage_harness.so"
    harness = build.BUILD_DIR / "fcm_ctiled_stage_harness.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    harness.write_text(STAGE_HARNESS % src)
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(harness)], capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.fcm_ctiled_stage
    fn.argtypes = [ctypes.c_int] + list(F._ctiled_lib().fcm_ctiled_chunk
                                        .argtypes)
    fn.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def time_ctiled(F, build, emit, dev, g) -> None:
    """The C-tiled kernel at CTILED and CTILED_K3: whole, each launch
    apart, both library yardsticks and the bound."""
    import torch
    from chip_smoke import (bound, bound_batched, contraction_library_ms,
                            ctiled_launch_ms, membership_library_ms)
    stage_fn, log = stage_function(F, build)

    def dsplit(*shape):
        plan = (F._plan(0, *shape) if len(shape) == 3
                else F._batched_plan(0, *shape))
        return getattr(plan, "dsplits", 1) > 1

    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "smem" in ln
                                or "spill" in ln or "Compiling" in ln]}),
          flush=True)
    for run, n, d, c in CTILED:
        x = torch.randn((n, d), generator=g, device=dev)
        w = torch.rand((n,), generator=g, device=dev) + 0.5
        v = torch.randn((c, d), generator=g, device=dev)
        reps = 20 if n * d > 1 << 26 else 200
        fn = F.fcm_sweep_cuda
        emit("fcm_sweep", run, [n, d, c],
             *timed(lambda: fn(x, w, v, 2.0), reps),
             launch_ms=ctiled_launch_ms(fn, (x, w, v, 2.0), reps,
                                        dsplit(n, d, c), stage_fn),
             member_library_ms=membership_library_ms(x, v, reps),
             contraction_library_ms=contraction_library_ms(x, c, reps),
             bound_ms=bound(n, d, c)[0])
        del x, w, v
        torch.cuda.empty_cache()
    t, n, d, c = CTILED_K3
    x = torch.randn((t, n, d), generator=g, device=dev)
    w = torch.rand((t, n), generator=g, device=dev) + 0.5
    w[-1] = 0.0
    v = torch.randn((t, c, d), generator=g, device=dev)
    fn = F.fcm_sweep_batched_cuda
    emit("fcm_sweep_batched", "check/K3", [t, n, d, c],
         *timed(lambda: fn(x, w, v, 2.0), 200),
         launch_ms=ctiled_launch_ms(fn, (x, w, v, 2.0), 200,
                                    dsplit(t, n, d, c), stage_fn),
         bound_ms=bound_batched(t, n, d, c)[0])


def timed(fn, reps: int):
    """(ms per launch over a CUDA-graph replay of ``reps`` back-to-back
    calls, median ms of events around single calls), as chip_smoke.py
    times them."""
    from chip_smoke import time_loop_ms, time_ms
    return time_loop_ms(fn, reps), time_ms(fn, reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--set", choices=("all", "ctiled"), default="all")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels import fcm_update as F
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def emit(kernel, run, shape, ms, per_call, **extra):
        print(json.dumps({"label": args.label, "kernel": kernel, "run": run,
                          "shape": shape, "ms": ms, "ms_per_call": per_call,
                          **extra}), flush=True)

    time_ctiled(F, build, emit, dev, g)
    for kernel, run, n, d, c, m in (SINGLE if args.set == "all" else ()):
        x = torch.randn((n, d), generator=g, device=dev)
        w = torch.rand((n,), generator=g, device=dev) + 0.5
        v = torch.randn((c, d), generator=g, device=dev)
        fn = getattr(F, kernel + "_cuda")
        emit(kernel, run, [n, d, c],
             *timed(lambda: fn(x, w, v, m), 20 if n > 1 << 20 else 500))
        del x, w
        torch.cuda.empty_cache()
    for run, t, n in (BATCHED if args.set == "all" else ()):
        x = torch.randn((t, n, 4), generator=g, device=dev)
        w = torch.rand((t, n), generator=g, device=dev) + 0.5
        v = torch.randn((t, 3, 4), generator=g, device=dev)
        m = torch.rand((t,), generator=g, device=dev) * 1.5 + 1.5
        emit("fcm_sweep_batched", run, [t, n, 4, 3],
             *timed(lambda: F.fcm_sweep_batched_cuda(x, w, v, m),
                    20 if t * n > 1 << 20 else 500))
        del x, w
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
