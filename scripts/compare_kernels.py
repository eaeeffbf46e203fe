#!/usr/bin/env python3
"""Time the port's FCM sweep kernels at every shape the four runs of
chip_smoke.py launch them at, for one checkout of `repro_torch`, on one
NVIDIA card:

    python3 scripts/compare_kernels.py [--src DIR] [--label NAME]
                      [--set all|ctiled|wide|route|tenant|tenant_route]

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

``--set wide`` times the single-model sweep where C ≤ 128 and d is too
wide for the tile kernel, at the LM widths (``WIDE``: the ``curriculum``
run's shapes at d = 1536, C = 16, m = 1.2; the other config widths at
C = 16; the plan's boundary checks; tests/test_kernels.py's C > 128
shapes): each on the checkout's own plan (``path``), held against its
plain version; where that path is the first version ("first"), its two
launches apart (``first_launch_ms``: partial, reduce, through a harness
built beside its source); the C-tiled kernel forced at the same shape
(``ctiled_ms``, ``ctiled_launch_ms``, held too), both library
yardsticks and the bound; first the ``-Xptxas -v`` lines of
``fcm_accumulate.cu``.  On a checkout with the wide kernel each wide
launch is also timed with each stage of its tile loop left out
(``wide_stage_ms``: a build with FCM_WIDE_STAGES cleared of that stage's
bit; "none" keeps only the walk's fixed cost), and at full sizes under
other plan choices (``wide_choice_ms``).

``--set route`` times the wide kernel and the C-tiled kernel, each forced,
over ``ROUTE`` (C = 8 … 128 across the wide domain's d, at N = 65,536,
2048 and 32): the measurements behind the launch plan's choice between
them (``fcm_update.wide_wins``).

``--set tenant`` times the tenant-stacked sweep (K3) where C·d is past
the rows kernel (``TENANT``: phase 2b's (66, 300, 41, 23), the
``tenants_kdd99`` cohort's (4096, 512, 41, 23) and others, ragged live
rows, per-tenant m): on the checkout's plan, held against its plain
version; on a checkout whose plan takes the first tenant-stacked version
there, its two launches apart (``first_launch_ms``); on the tile
kernel's tenant axis, each stage of its tile loop left out
(``tile_stage_ms``: builds that define ``FCM_TILE_STAGES``); the C-tiled
kernel forced (``ctiled_ms``); then the single-model KDD99-like shapes,
which share the tile kernel.  ``--set tenant_route`` times K3 on the
checkout's plan beside the C-tiled kernel forced over ``TENANT_ROUTE``
(past the tile kernel's micro-tiles while V_t and one record fit shared
memory): the measurements behind ``plan_batched``'s choice there.
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
# The wide single-model sweep (C <= 128, d past the tile kernel): the
# curriculum run's full size, driver sample, WFCMPB block, 32- and
# 16-point merges and K1 at 32,768 rows (d = 1536, C = 16, m = 1.2); the
# other d_model of the configs at C = 16; the plan's boundary checks; and
# tests/test_kernels.py's C > 128 shapes.  (kernel, label, N, d, C, m)
WIDE = [("fcm_sweep", f"curriculum/{label}", n, 1536, 16, 1.2)
        for label, n in (("full", 65_536), ("sample", 32_604),
                         ("block", 2048), ("merge", 32), ("n=16", 16))]
WIDE += [("fcm_accumulate", "curriculum/n=32768", 32_768, 1536, 16, 1.2)]
WIDE += [("fcm_sweep", f"width/{d}", 65_536, d, 16, 1.2)
         for d in (1024, 2048, 3072)]
WIDE += [("fcm_sweep", f"check/{n}x{d}x{c}", n, d, c, 2.0)
         for n, d, c in ((4096, 100, 128), (3000, 887, 64))]
WIDE += [("fcm_sweep", f"c>128/{n}x{d}x{c}", n, d, c, 2.0)
         for n, d, c in ((512, 8, 129), (300, 130, 131), (200, 129, 140),
                         (96, 257, 129), (513, 131, 200))]

# The first single-model version launches its two kernels from one C
# call; this harness, compiled with its source, launches one of them
# (0: the partials, 1: their sum).
FIRST_HARNESS = r"""
#include "%s"
extern "C" int fcm_first_stage(
    int stage, const float* x, const float* w, const float* v, long long n,
    int d, int c, float m, float expo, int t, int grid, int block,
    float* part, float* out_v, float* out_w, float* out_q, int normalize,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == 0) {
    const size_t smem = make_layout(d, c, t, block).total * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fcm_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fcm_partial_kernel<<<grid, block, smem, s>>>(x, w, v, n, d, c, m, expo, t, part);
  } else {
    const int p_len = c * d + c + 1;
    fcm_reduce_kernel<<<(p_len + 255) / 256, 256, 0, s>>>(part, grid, d, c, normalize,
                                                         out_v, out_w, out_q);
  }
  return (int)cudaGetLastError();
}
"""

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
    fn, log = harness(build, "fcm_ctiled_stage_harness", STAGE_HARNESS % src,
                      "fcm_ctiled_stage")
    fn.argtypes = [ctypes.c_int] + list(F._ctiled_lib().fcm_ctiled_chunk
                                        .argtypes)
    fn.restype = ctypes.c_int
    return fn, log


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


def harness(build, name, text, symbol):
    """(``symbol`` of a shared library built from ``text``, a harness that
    includes a kernel source, beside the checkout's builds; the build's
    ``-Xptxas -v`` lines)."""
    import ctypes
    out = build.BUILD_DIR / f"lib{name}.so"
    src = build.BUILD_DIR / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(src)], capture_output=True, text=True, check=True)
    return (getattr(ctypes.CDLL(str(out)), symbol),
            proc.stdout + proc.stderr)


def first_launch_ms(F, build, kern, args, reps) -> dict:
    """The first version's two launches timed apart (``partial``, its
    CTAs' partials; ``reduce``, their sum in a second launch), each as
    `time_loop_ms` times the whole.  Alone, the sum reads partials that
    no launch wrote: its time, not its values, is what this measures."""
    import ctypes
    from chip_smoke import _StageLib, time_loop_ms
    src = build.CSRC / "fcm_accumulate.cu"
    fn, _ = harness(build, "fcm_first_stage_harness", FIRST_HARNESS % src,
                    "fcm_first_stage")
    real = F._lib
    lib = real()
    fn.argtypes = [ctypes.c_int] + list(lib.fcm_accumulate.argtypes)
    fn.restype = ctypes.c_int
    out = {}
    try:
        for stage, name in enumerate(("partial", "reduce")):
            F._lib = lambda s=stage: _StageLib(lib, fn, s, "fcm_accumulate")
            out[name] = time_loop_ms(lambda: kern(*args), reps)
    finally:
        F._lib = real
    return out


# The wide kernel's tile-loop stages (csrc/fcm_accumulate.cu,
# FCM_WIDE_STAGES): a variant is built with one of them left out, or with
# none of them (the walk's fixed cost: V, |v|², the final reduce).
WIDE_STAGES = {"loads": 1, "x.v": 2, "post": 4, "cluster barrier": 8,
               "contraction": 16, "membership": 32}
WIDE_VARIANTS = {"none": 0, **{f"no {k}": 63 & ~b
                               for k, b in WIDE_STAGES.items()}}


class _Variant:
    """The single-model library of a build of fcm_accumulate.cu with some
    stages of a tile loop left out, its calls typed as ``lib``'s."""

    def __init__(self, lib, path):
        import ctypes
        self._cdll = ctypes.CDLL(str(path))
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._cdll, name)
        real = getattr(self._lib, name)
        fn.argtypes, fn.restype = real.argtypes, real.restype
        return fn


def stage_variants(F, build, macro, masks) -> dict:
    """{variant name: library} of fcm_accumulate.cu built with ``macro``
    (FCM_WIDE_STAGES or FCM_TILE_STAGES) set to each of ``masks`` (stages
    of that kernel's tile loop left out), one nvcc each, all at once; {}
    for a source without ``macro``."""
    from concurrent.futures import ThreadPoolExecutor
    src = build.CSRC / "fcm_accumulate.cu"
    if macro.encode() not in src.read_bytes():
        return {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, mask = item
        cu = build.BUILD_DIR / f"{macro.lower()}_{mask}.cu"
        out = cu.with_suffix(".so")
        cu.write_text(f"#define {macro} {mask}\n#include \"{src}\"\n")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(cu)], capture_output=True, text=True, check=True)
        return name, out

    lib = F._lib()
    with ThreadPoolExecutor(len(masks)) as pool:
        built = dict(pool.map(one, masks.items()))
    return {name: _Variant(lib, path) for name, path in built.items()}


def stage_ms(F, variants, kern, args, reps) -> dict:
    """``kern(*args)`` on each variant (a stage of the wide or the tile
    kernel's tile loop left out, or all of them), each timed as
    `time_loop_ms` times the whole.  Such a variant computes wrong values: its time, not its
    values, is what this measures."""
    from chip_smoke import time_loop_ms
    real = F._lib
    out = {}
    try:
        for name, lib in variants.items():
            F._lib = lambda lib=lib: lib
            out[name] = time_loop_ms(lambda: kern(*args), reps)
    finally:
        F._lib = real
    return out


# The wide domain's (d, C) between the tile kernel's micro-tiles and V's
# shared memory, at three N: the wide and C-tiled kernels forced.
ROUTE = [(n, d, c) for c, ds in ((8, (1536, 3072, 6144)),
                                 (16, (768, 1536, 3072)),
                                 (24, (512, 1024, 2300)),
                                 (32, (384, 1024, 1700)),
                                 (64, (256, 512, 887)),
                                 (128, (100, 256, 443)))
         for d in ds for n in (65_536, 4096, 2048, 32)]


def time_route(F, emit, dev, g) -> None:
    """The wide and C-tiled kernels, each forced, at ROUTE (K2, m = 1.2),
    each held against the plain version."""
    import torch
    from chip_smoke import (RTOL, SWEEP_ATOL, bound, forced_ctiled, max_err,
                            plain_in_rows, time_loop_ms)
    for n, d, c in ROUTE:
        x = torch.randn((n, d), generator=g, device=dev)
        w = torch.rand((n,), generator=g, device=dev) + 0.5
        v = torch.randn((c, d), generator=g, device=dev)
        want = plain_in_rows(F.fcm_accumulate_ref, True)(x, w, v, 1.2)
        reps = 20 if n * d > 1 << 24 else 200
        wide, wplan = F.fcm_sweep_wide, F.wide_plan(dev, n, d, c)
        ct, _ = forced_ctiled(F, n, d, c, True)
        for kern in (wide, ct):
            max_err(kern(x, w, v, 1.2), want, RTOL, SWEEP_ATOL,
                    f"{kern.__name__} at {(n, d, c)}")
        emit("fcm_sweep", f"route/{n}x{d}x{c}", [n, d, c],
             time_loop_ms(lambda: wide(x, w, v, 1.2), reps), None,
             path=F._plan(0, n, d, c).path,
             ctiled_ms=time_loop_ms(lambda: ct(x, w, v, 1.2), reps),
             rows=wplan.rows, dsplits=wplan.dsplits, grid=wplan.grid,
             bound_ms=bound(n, d, c)[0])
        del x, w, v, want
        torch.cuda.empty_cache()


# Plan choices timed on the wide path: records per tile and d-split CTAs
# scaled (PlanChoice.tile, .dsplit).
WIDE_CHOICES = [(1.0, 1.0), (0.5, 1.0), (2.0, 1.0), (1.0, 0.5), (1.0, 2.0),
                (1.0, 4.0), (0.5, 2.0)]


def time_wide(F, build, emit, dev, g) -> None:
    """The single-model sweep at WIDE: on the checkout's plan, its first
    version's launches apart, the C-tiled kernel forced, both library
    yardsticks and the bound; every kernel held against its plain
    version (row chunks) at the test_kernels.py tolerances."""
    import torch
    from chip_smoke import (ACC_ATOL, RTOL, SWEEP_ATOL, bound,
                            contraction_library_ms, ctiled_launch_ms,
                            forced_ctiled, max_err, membership_library_ms,
                            plain_in_rows, time_loop_ms)
    log = build.compile_source("fcm_accumulate", verbose=True)
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "smem" in ln
                                or "spill" in ln or "Compiling" in ln]}),
          flush=True)
    has_first = b"fcm_partial_kernel" in (
        build.CSRC / "fcm_accumulate.cu").read_bytes()
    variants = stage_variants(F, build, "FCM_WIDE_STAGES", WIDE_VARIANTS)
    for kernel, run, n, d, c, m in WIDE:
        x = torch.randn((n, d), generator=g, device=dev)
        w = torch.rand((n,), generator=g, device=dev) + 0.5
        v = torch.randn((c, d), generator=g, device=dev)
        normalize = kernel == "fcm_sweep"
        fn = getattr(F, kernel + "_cuda")
        plain = plain_in_rows(F.fcm_accumulate_ref, normalize)
        atol = SWEEP_ATOL if normalize else ACC_ATOL
        if c > 128:
            atol = max(atol, 3e-4)
        reps = 20 if n * d > 1 << 24 else 200
        want = plain(x, w, v, m)
        err = max_err(fn(x, w, v, m), want, RTOL, atol, f"{kernel} {run}")
        ct, ct_plan = forced_ctiled(F, n, d, c, normalize)
        ct_err = max_err(ct(x, w, v, m), want, RTOL, atol,
                         f"forced ctiled {run}")
        del want
        plan = F._plan(0, n, d, c)
        extra = {}
        if has_first and plan.path == "first":
            extra["first_launch_ms"] = first_launch_ms(
                F, build, fn, (x, w, v, m), reps)
        if plan.path == "wide":
            extra["clusters"] = plan.grid // plan.dsplits
            extra["wide_stage_ms"] = stage_ms(F, variants, fn, (x, w, v, m),
                                              reps)
            extra["wide_choice_ms"] = {}
            grid = WIDE_CHOICES
            if n <= 4096:
                # small N: tiles of r records on s-CTA clusters
                grid = [(r / plan.rows, s / plan.dsplits)
                        for r in (1, 2, 4, 8, 16, 32, 64) if r <= 2 * n
                        for s in sorted({plan.dsplits, 2, 3, 5, 9})]
            for t, sp in grid:
                ch = F.PlanChoice(tile=t, dsplit=sp)
                cp = F._plan(0, n, d, c, ch)
                extra["wide_choice_ms"][f"tile={t},dsplit={sp}"] = [
                    time_loop_ms(lambda: F._launch(x, w, v, m, normalize, ch),
                                 reps), cp.rows, cp.dsplits, cp.grid]
        emit(kernel, run, [n, d, c], *timed(lambda: fn(x, w, v, m), reps),
             path=plan.path, grid=plan.grid, rows=plan.rows,
             dsplits=plan.dsplits, smem=plan.smem, max_abs_err=err,
             **extra,
             ctiled_ms=time_loop_ms(lambda: ct(x, w, v, m), reps),
             ctiled_launch_ms=ctiled_launch_ms(
                 ct, (x, w, v, m), reps, ct_plan.dsplits > 1),
             ctiled_dsplits=ct_plan.dsplits, ctiled_max_abs_err=ct_err,
             member_library_ms=membership_library_ms(x, v, reps),
             contraction_library_ms=contraction_library_ms(x, c, reps),
             bound_ms=bound(n, d, c)[0], bound_by=bound(n, d, c)[1])
        del x, w, v
        torch.cuda.empty_cache()


# K3, the tenant-stacked sweep, where C·d is past the rows kernel
# (T, N, d, C; m = 1.2 per tenant, as the tenant plane passes it): phase
# 2b's check, a shape just past the rows kernel's C, the tenants_kdd99
# cohort's bucket and a quarter of it, and two shapes past the tile
# kernel's micro-tiles (C-tiled), the second one where the first version
# measured faster (many tenants at small d, C > 128).  Each tenant's live
# rows are U[64, 513) at N = 512 (the cohort's), else U[N/3, N]; the rest
# zero-weight zeros.
TENANT = [(66, 300, 41, 23), (5, 300, 4, 9), (4096, 512, 41, 23),
          (1024, 512, 41, 23), (66, 300, 256, 64), (1024, 512, 8, 129)]
# The single-model KDD99-like sweep, which shares the tile kernel.
KDD_SINGLE = [e for e in SINGLE if e[1].startswith("kdd99_like/")]
# The tile kernel's tile-loop stages (csrc/fcm_accumulate.cu,
# FCM_TILE_STAGES), left out one at a time, or all of them.
TILE_STAGES = {"loads": 1, "x.v": 2, "membership": 4, "contraction": 8}
TILE_VARIANTS = {"none": 0, **{f"no {k}": 15 & ~b
                               for k, b in TILE_STAGES.items()}}
# The domain past the tile kernel's micro-tiles where V_t and one record
# fit shared memory (the first tenant-stacked version's): d from 129 to
# 445 at C = 64, C from 129 to 200 at d from 8 to 64, at nine (T, N) from
# (3, 4096) to (4096, 16).
TENANT_ROUTE = [(t, n, d, c)
                for d, c in ((129, 64), (160, 64), (192, 64), (256, 64),
                             (445, 64), (8, 129), (8, 200), (16, 160),
                             (24, 129), (32, 129), (32, 200), (48, 160),
                             (64, 160))
                for t, n in ((3, 4096), (66, 300), (66, 4096), (256, 128),
                             (1024, 32), (1024, 512), (4096, 16), (4096, 32),
                             (4096, 128))]

# The first tenant-stacked version launches its two kernels from one C
# call; this harness, compiled with its source, launches one of them
# (0: the partials, 1: their sum).
BATCHED_FIRST_HARNESS = r"""
#include "%s"
extern "C" int fcm_batched_first_stage(
    int stage, const float* x, const float* w, const float* v,
    const float* m_t, long long tenants, long long n, int d, int c, int t,
    int splits, int smem_bytes, int block, float* part, float* out_v,
    float* out_w, float* out_q, int normalize, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stage == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fcm_batched_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    fcm_batched_partial_kernel<<<dim3((unsigned)tenants, (unsigned)splits), block,
                                 smem_bytes, s>>>(x, w, v, m_t, n, d, c, t, part);
  } else {
    const long long outs = tenants * (c * d + c + 1);
    fcm_batched_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
        part, tenants, splits, d, c, normalize, out_v, out_w, out_q);
  }
  return (int)cudaGetLastError();
}
"""


def first_batched_launch_ms(F, build, kern, args, reps) -> dict:
    """The first tenant-stacked version's two launches timed apart
    (``partial``, ``reduce``), as `first_launch_ms` times the single-model
    one's."""
    import ctypes
    from chip_smoke import _StageLib, time_loop_ms
    src = build.CSRC / "fcm_batched.cu"
    fn, _ = harness(build, "fcm_batched_first_stage_harness",
                    BATCHED_FIRST_HARNESS % src, "fcm_batched_first_stage")
    real = F._batched_lib
    lib = real()
    fn.argtypes = [ctypes.c_int] + list(lib.fcm_batched_accumulate.argtypes)
    fn.restype = ctypes.c_int
    out = {}
    try:
        for stage, name in enumerate(("partial", "reduce")):
            F._batched_lib = lambda s=stage: _StageLib(
                lib, fn, s, "fcm_batched_accumulate")
            out[name] = time_loop_ms(lambda: kern(*args), reps)
    finally:
        F._batched_lib = real
    return out


def tenant_inputs(t, n, d, c, dev, g):
    """(x, w, v, m, live share) at (T, N, d, C): ragged live rows (TENANT's
    note), zero-weight zero rows after them, m = 1.2 per tenant."""
    import torch
    lo, hi = (64, 513) if n == 512 else (max(1, n // 3), n + 1)
    live = torch.randint(lo, hi, (t, 1), generator=g, device=dev)
    keep = torch.arange(n, device=dev)[None] < live
    x = torch.randn((t, n, d), generator=g, device=dev) * keep[..., None]
    w = (torch.rand((t, n), generator=g, device=dev) * 1.5 + 0.5) * keep
    v = torch.randn((t, c, d), generator=g, device=dev)
    m = torch.full((t,), 1.2, device=dev)
    return x, w, v, m, float(keep.sum()) / (t * n)


def tile_plan_ms(F, plan, t, n, d, c, kern, args, reps) -> dict:
    """``kern(*args)`` on other tile plans at this shape, each timed as
    `time_loop_ms` times the whole: one split per tenant (the CTA walks
    its tenant's tiles alone) where the plan splits, and each tile scale
    of autotuning's TILE_GRID below 1."""
    import dataclasses
    from chip_smoke import time_loop_ms
    sms, smem = F._card(0)
    alts = {}
    if plan.splits > 1:
        alts["splits=1"] = dataclasses.replace(plan, grid=t, splits=1,
                                               slices=0)
    for scale in (0.5, 0.25):
        alts[f"tile={scale}"] = F.plan_batched(
            t, n, d, c, sms=sms, smem_limit=smem,
            ctas_per_sm=F._occupancy, choice=F.PlanChoice(tile=scale))
    real = F._batched_plan
    out = {}
    try:
        for name, alt in alts.items():
            F._batched_plan = lambda *a, alt=alt: alt
            out[name] = [time_loop_ms(lambda: kern(*args), reps), alt.rows,
                         alt.splits, alt.grid]
    finally:
        F._batched_plan = real
    return out


def time_tenant(F, build, emit, dev, g) -> None:
    """K3 at TENANT on the checkout's plan, held against its plain version
    (row chunks); the first version's two launches apart where the plan
    takes it ("first"); the tile path's loop stages left out in turn
    (``tile_stage_ms``); the C-tiled kernel forced at each shape, held
    too; the bound.  Then the single-model KDD99-like shapes, which share
    the tile kernel.  First the ``-Xptxas -v`` lines of
    ``fcm_accumulate.cu``."""
    from chip_smoke import (RTOL, SWEEP_ATOL, bound_batched, forced_ctiled,
                            max_err, plain_in_rows, time_loop_ms)
    import torch
    log = build.compile_source("fcm_accumulate", verbose=True)
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "smem" in ln
                                or "spill" in ln or "Compiling" in ln]}),
          flush=True)
    has_first = b"fcm_batched_partial_kernel" in (
        build.CSRC / "fcm_batched.cu").read_bytes()
    variants = stage_variants(F, build, "FCM_TILE_STAGES", TILE_VARIANTS)
    fn = F.fcm_sweep_batched_cuda
    for t, n, d, c in TENANT:
        x, w, v, m, live = tenant_inputs(t, n, d, c, dev, g)
        reps = 20 if t * n * d > 1 << 24 else 200
        want = plain_in_rows(F.fcm_accumulate_batched_ref, True)(x, w, v, m)
        what = f"K3 at {(t, n, d, c)}"
        err = max_err(fn(x, w, v, m), want, RTOL, SWEEP_ATOL, what)
        ct, ct_plan = forced_ctiled(F, n, d, c, True, tenants=t)
        ct_err = max_err(ct(x, w, v, m), want, RTOL, SWEEP_ATOL,
                         "forced C-tiled " + what)
        del want
        plan = F._batched_plan(0, t, n, d, c)
        extra = {}
        if has_first and plan.path == "first":
            extra["first_launch_ms"] = first_batched_launch_ms(
                F, build, fn, (x, w, v, m), reps)
        if plan.path == "tile" and variants:
            extra["tile_stage_ms"] = stage_ms(F, variants, fn, (x, w, v, m),
                                              reps)
        if plan.path == "tile":
            extra["tile_plan_ms"] = tile_plan_ms(F, plan, t, n, d, c, fn,
                                                 (x, w, v, m), reps)
        b_ms, b_by = bound_batched(t, n, d, c)
        emit("fcm_sweep_batched", f"tenant/{t}x{n}x{d}x{c}", [t, n, d, c],
             *timed(lambda: fn(x, w, v, m), reps), path=plan.path,
             grid=plan.grid, rows=plan.rows, splits=plan.splits,
             smem=plan.smem, live_share=live, max_abs_err=err, **extra,
             ctiled_ms=time_loop_ms(lambda: ct(x, w, v, m), reps),
             ctiled_max_abs_err=ct_err, bound_ms=b_ms, bound_by=b_by)
        del x, w, v
        torch.cuda.empty_cache()
    for kernel, run, n, d, c, m in KDD_SINGLE:
        x = torch.randn((n, d), generator=g, device=dev)
        w = torch.rand((n,), generator=g, device=dev) + 0.5
        v = torch.randn((c, d), generator=g, device=dev)
        f1 = getattr(F, kernel + "_cuda")
        emit(kernel, run, [n, d, c],
             *timed(lambda: f1(x, w, v, m), 20 if n > 1 << 20 else 500),
             path=F._plan(0, n, d, c).path)
        del x, w
        torch.cuda.empty_cache()


def time_tenant_route(F, emit, dev, g) -> None:
    """K3 on the checkout's plan and the C-tiled kernel forced, at
    TENANT_ROUTE, the plan's kernel held against the C-tiled one: on a
    checkout whose plan takes the first tenant-stacked version there, the
    measurements behind the plan's choice past the tile kernel's
    micro-tiles."""
    import torch
    from chip_smoke import (OFF_LANE_ATOL, RTOL, bound_batched,
                            forced_ctiled, max_err, time_loop_ms)
    fn = F.fcm_sweep_batched_cuda
    for t, n, d, c in TENANT_ROUTE:
        x, w, v, m, live = tenant_inputs(t, n, d, c, dev, g)
        ct, ct_plan = forced_ctiled(F, n, d, c, True, tenants=t)
        err = max_err(fn(x, w, v, m), ct(x, w, v, m), 2 * RTOL,
                      2 * OFF_LANE_ATOL, f"K3 vs forced C-tiled at "
                      f"{(t, n, d, c)}")
        reps = 20 if t * n * d > 1 << 24 else 100
        emit("fcm_sweep_batched", f"tenant_route/{t}x{n}x{d}x{c}",
             [t, n, d, c], time_loop_ms(lambda: fn(x, w, v, m), reps), None,
             path=F._batched_plan(0, t, n, d, c).path,
             ctiled_ms=time_loop_ms(lambda: ct(x, w, v, m), reps),
             ctiled_grid=ct_plan.grid, live_share=live, max_gap=err,
             bound_ms=bound_batched(t, n, d, c)[0])
        del x, w, v
        torch.cuda.empty_cache()


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
    ap.add_argument("--set", choices=("all", "ctiled", "wide", "route",
                                      "tenant", "tenant_route"),
                    default="all")
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

    if args.set == "wide":
        time_wide(F, build, emit, dev, g)
    elif args.set == "route":
        time_route(F, emit, dev, g)
    elif args.set == "tenant":
        time_tenant(F, build, emit, dev, g)
    elif args.set == "tenant_route":
        time_tenant_route(F, emit, dev, g)
    else:
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
