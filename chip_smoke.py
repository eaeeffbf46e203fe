#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BigFCM (`src/repro_torch`) on one NVIDIA
card and check it.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

Phases, each printed as JSON lines; any failure raises and exits non-zero:

1. device  — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the ``nvcc`` build of every kernel source in the
   checkout (one ``nvcc`` each, all started together), timed.
2. kernels — the Hopper FCM kernel against its plain PyTorch version on
   the card: every shape of tests/test_kernels.py for m in
   {1.05, 1.2, 2.0, 3.0} at that file's tolerances, chunk additivity,
   and bitwise determinism of two launches.  Then the inputs the driver
   race gives it at each run's d, C and m: the 3184-row sample, WFCMPB's
   last 2048-row block with zero-weight phantom rows, and WFCMPB's first
   2·C-point merge, whose running half has zero mass.
   Then it holds the tenant-stacked kernel (K3) against its plain
   version: T ∈ {1, 5, 64} ragged tenants plus two all-zero phantom
   tenants, d ∈ {4, 41}, C ∈ {3, 23}, per-tenant m from {1.05, 1.2, 2.0,
   3.0} and a scalar m, with bit-identical reruns, exact zeros on the
   phantoms, and one tenant against K1/K2.  Then the C-tiled kernel
   (``csrc/fcm_ctiled.cu``, where V does not fit shared memory) against
   its plain version computed in row chunks: K1/K2 at (N, d, C) =
   (4096, 900, 64), (4096, 2048, 64), (1024, 7168, 384), m = 2 and 1.2,
   with phantom rows and with records on centers; K3 at (3, 1000, 2048,
   64) with one all-phantom tenant; and with its scratch cut so that its
   sums add over tenant groups and row chunks.
   Then the perf plane (``calibrate``), in a calibration sandbox (a fresh
   ``build/chip_smoke_calib_*/`` as ``REPRO_CALIB_DIR``, deleted at the
   end, so no earlier run's winners or tuned plans change a plan): the
   card's probed peaks beside the datasheet's; at the default bucket and
   each run's driver-sample bucket the backend race ("auto"'s winner,
   each backend's µs and parity; the winner must be ``hopper`` or
   ``hopper_accumulate``, both in parity with ``torch``); and at those
   buckets and the tenant cohorts' the launch-plan search (a host-bound
   bucket keeps its untuned plan; elsewhere a choice must beat the
   untuned plan's card time by more than 5 %), every plan of the grid
   held against the plain version.  Every later
   phase runs on the plans it chose.
3. main path — `bigfcm_fit` on backend ``hopper`` at the paper's dataset
   sizes (HIGGS-like 11,000,000 × 28, C=2, m=2; KDD99-like
   4,898,431 × 41, C=23, m=1.2; ε=5e-7 as in benchmarks/t6_datasets.py),
   data made from ``--seed``.  Launch counts are zeroed right before the
   fit and read right after the global objective pass.  Then the fit
   with injected seeds through ``hopper`` is held against the ``torch``
   backend on the card, and each kernel entry against its plain version
   at the full shape, and timed.  The driver race's two branches (FCM
   and WFCMPB on the full-size sample) run through ``hopper``, every
   sweep over records held against the plain version on the same
   inputs, and their centers against the ``torch`` backend's.
   Then ``router_fit``: `bigfcm_fit` with src/repro/integration/
   router_init.py:40-42's config (C = 64, m = 2, ε 1e-6 / 1e-8, 200
   sweeps) at OLMoE-1B-7B's d_model (262,144 × 2048 token-embedding-like
   rows from 64 Gaussian components of unequal mass), every launch on
   the C-tiled path, held against the ``torch`` backend from the same
   draws (`hold_router_fits`); each shape held and timed, the
   contraction's ``torch.matmul`` timed as its yardstick.  The HIGGS- and
   KDD99-like records print `kernel_roofline` of ``hopper`` at full size,
   its `sweep_bytes` held equal to `bound_bytes`.
4. tenant path — `fit_tenants` on backend ``hopper`` at two cohorts made
   from ``--seed``: ``tenants_t16``, benchmarks/t16_tenant.py's own
   (1024 tenants of 8–30 rows, d=4, C=3, m=2, ε=1e-3, 12 sweeps at
   most), and ``tenants_65k`` (65,536 tenants of 64–512 rows, per-tenant
   m ~ U(1.5, 3), ε=1e-6, 300 sweeps at most).  The K3 launch count is
   zeroed right before each fit and read right after.  Each fit is held
   tenant by tenant against the same fit through the ``torch`` backend
   (`hold_tenant_fits`), ``tenants_t16``'s first 16 tenants also
   against `fit_tenants_looped`; a burst of 4 rows per tenant goes
   through `TenantScorer` on the card and on the CPU; and K3 is held
   against its plain version at the packed shape, and timed.  At
   ``tenants_65k`` a `TenantScoringService` serves requests of 8–64 rows
   from 4096 random tenants and one firehose tenant (half the rows,
   ``max_group_rows`` 512), swapping to the ``torch`` refit mid-traffic:
   each response's version and labels are one fleet's.
5. store path — the two arrays ingested into on-disk
   `ChunkStore`s of 1,048,576-row chunks: `bigfcm_fit_store` with
   counted launches and peak device memory, held against the in-memory
   fits; a pass's time split; at KDD99 size the 4-shard fit,
   `wfcmpb_store`, MR-FKM and `assign_store`.  The KDD99-like fit also
   prints `repro_torch.obs`'s phase breakdown, its ``data.cache``
   counters held to the chunks the fit reads.
   Then ``fleet`` (`run_fleet_path`) over the HIGGS-like store, from
   `driver_seeds` at the main path's draws: (a) `fleet_fit`, 4 host
   threads x 2 shards on ``hopper``, counts zeroed just before it: no
   host lost, K1 launches at the batch shape equal to the obs plane's
   ``engine.sweep`` spans, K2 launches at the 2·C-point merge shape
   equal to the hosts' pairwise merge recomputed over the gathered
   frames, held against the ``torch`` backend's fleet and the 1-shard
   store fit's global q (1e-5); (b) the bf16 wire (every frame element
   within ``BF16_REL_BOUND``); (c) a straggler evicted and replanned; (d)
   `spawn_fleet`, 3 host processes on the card, host 1 stopped after
   the others posted, the survivors bit-equal to a fleet born at 2
   hosts; (e) `mr_kmeans` on the KDD99-like array, its inertia held to
   a float64 recompute.  K1 and K2 are held and timed at the fleet's own
   inputs; their launches join the entries of the same shape.
   Then ``serve``: `ScoringService` over `Scorer` replicas at the
   KDD99-like fit's centers with benchmarks/t14_serve.py's traffic
   (1200 requests over 40 sizes in 16–1024 rows, 4096-row batches on a
   64-base bucket ladder): closed-loop runs at 1, 4 and 16 clients with
   1 then 2 replicas (p50/p99 of ``span.serve.assign`` per bucket and of
   ``serve.request``, records/s, each replica's shape count equal to the
   buckets it used), the ``coalesce=False`` ablation and the shed policy
   (every rejection typed, the queue-rows gauge within 4096); every
   response held against `make_assigner` (`label_ties`).
6. stream path — `StreamingBigFCM` on backend ``hopper``, launch counts
   zeroed before each run and read after it:
   ``kdd99_stream``, the KDD99-like array replayed through
   `assign_stream(model, stream_loader(replay_source(x, 262144),
   262144))` (C = 23, m = 1.2, `StreamConfig` defaults otherwise; 19
   ingests, the last batch phantom-padded), its last labels held against
   `make_assigner`, the model checkpointed and restored at step
   STREAM_CKPT_STEP and both fed the next batch (bit-identical); and
   the live path (`run_live_serve`): a second ``kdd99_stream`` model
   publishing each ingest through `SnapshotPublisher` to a
   `ScoringService` that scores each batch while the next one ingests;
   ``drift_streams`` at d = 28, C = 8, m = 2 from `make_moving_blobs`:
   (a) global drift, re-seeding once within the cooldown and ending
   within 5 % of a fresh `bigfcm_fit` of its last window; (b) one
   component splitting off, one birth and no re-seed (unless a step up
   to it is shown not fixed at f32 against float64); (c) (a)'s
   stationary prefix in event time, in order and out of order within a
   skew below the lateness: no drops, a monotone watermark, objectives
   within 5 % both ways.  Every ingest of ``kdd99_stream``, (a) and (b)
   is step-locked against ``torch``-backend twins in float32 and float64
   started from the pre-ingest state (`StreamRun.hold_step`; the driver
   race pinned to the branch the model kept, `DriverPin`); each ingest's
   wall time is split into drift probe, combiner, window merge and
   driver.  K1 and K2 at every shape the streams launched them at are
   held against their plain versions and timed.  ``kdd99_stream`` also
   prints the obs phase breakdown, its counters held against the run
   (records, births, deaths, re-seeds, labels), and obs's cost share of
   a steady ingest from a host microbenchmark, held to 5 %.  Obs stays
   on for the whole script (checks beside the main path record
   nothing).
7. the kernels line (one entry per kernel), the ``nvidia-smi`` line,
   and the final ``{"ok": true, ...}`` line.

Launches are priced at their own shapes.  Each wrapper counts its
launches per (path, N, C) (K3: per (path, T, N)); each main-path record
prints that split (``launches_by_shape``) and fails unless every launch
took the path the launch plan gives that run (``EXPECTED_PATH``).  Every
shape a run launches at (the full size, the driver's 3184-row sample and
2048-row blocks, the 2·C-point merges, any other size as "n=N"; K3's
packed cohort) is held against the plain version and timed two
ways: ``ms``, CUDA events around a run of back-to-back launches divided
by their count, the run captured in a CUDA graph and replayed so that the
host's enqueue drops out (the card's time), and ``ms_per_call``, the
median of events around single launches (which also counts the host's
enqueue at small shapes, as PR 11/12's times did).

Bounds use an H100 SXM's published peaks at 700 W: 3.35 TB/s of device
memory and 67 TFLOP/s of f32 outside the tensor cores.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
SOURCES = ("fcm_accumulate", "fcm_batched", "fcm_ctiled")  # csrc/<name>.cu
CSRC = "src/repro_torch/kernels/csrc"
# The source of each launch plan path: the rows kernel (which the
# single-model sweep runs at T = 1) is the tenant-stacked source's.
PATH_SOURCE = {("fcm_sweep", "rows"): "fcm_batched",
               ("fcm_accumulate", "rows"): "fcm_batched",
               ("fcm_sweep", "tile"): "fcm_accumulate",
               ("fcm_accumulate", "tile"): "fcm_accumulate",
               ("fcm_sweep", "first"): "fcm_accumulate",
               ("fcm_accumulate", "first"): "fcm_accumulate",
               ("fcm_sweep_batched", "rows"): "fcm_batched",
               ("fcm_sweep_batched", "first"): "fcm_batched",
               ("fcm_sweep", "ctiled"): "fcm_ctiled",
               ("fcm_accumulate", "ctiled"): "fcm_ctiled",
               ("fcm_sweep_batched", "ctiled"): "fcm_ctiled"}
REPLACES = {"fcm_sweep": "src/repro/kernels/fcm_update.py:154",
            "fcm_accumulate": "src/repro/kernels/fcm_update.py:40",
            "fcm_sweep_batched": "src/repro/engine/backend.py:216"}

# tests/test_kernels.py: SHAPES (sweep atol 3e-5) and OFF_LANE_SHAPES
# (atol 3e-4); the raw accumulators at atol 3e-3; rtol 3e-4 throughout.
SHAPES = [(64, 2, 2), (100, 130, 7), (257, 4, 3), (1000, 18, 10),
          (2048, 28, 50), (31, 41, 23), (512, 8, 129)]
OFF_LANE_SHAPES = [(300, 130, 131), (200, 129, 140), (96, 257, 129),
                   (513, 131, 200)]
M_SWEEP = (1.05, 1.2, 2.0, 3.0)
RTOL, SWEEP_ATOL, OFF_LANE_ATOL, ACC_ATOL = 3e-4, 3e-5, 3e-4, 3e-3
SAMPLE_SIZE, BLOCK_SIZE = 3184, 2048    # the driver's λ; WFCMPB's block
DRIVER_LABEL = {"sample": "sample", "last_block": "block",
                "first_merge": "merge"}
# The path the launch plan (repro_torch.kernels.fcm_update.plan_sweep /
# plan_batched) gives each run's d and C on an H100; every main-path
# launch must take it.
EXPECTED_PATH = {"higgs_like": "rows", "kdd99_like": "tile",
                 "tenants_t16": "rows", "tenants_65k": "rows",
                 "kdd99_stream": "tile", "drift_global": "tile",
                 "drift_split": "tile", "drift_event": "tile",
                 "router_fit": "ctiled"}


@dataclasses.dataclass(frozen=True)
class Run:
    name: str
    maker: str        # generator in repro_torch.data.synth
    n: int
    d: int
    c: int
    m: float
    eps: float


RUNS = (Run("higgs_like", "make_higgs_like", 11_000_000, 28, 2, 2.0, 5e-7),
        Run("kdd99_like", "make_kdd_like", 4_898_431, 41, 23, 1.2, 5e-7))


@dataclasses.dataclass(frozen=True)
class TenantRun:
    name: str
    tenants: int
    rows: tuple        # [lo, hi) records per tenant
    m: tuple           # per-tenant m ~ U(lo, hi), or () for the scalar 2.0
    eps: float
    max_iter: int
    row_base: int
    obj_rtol: float    # float64 objective bar against the exact trajectory


# benchmarks/t16_tenant.py:47-53,66-70 (d = 4, C = 3, blobs at 4.0·(i % 5)),
# at its cohort and at the per-user scale the tenant plane is built for.
# tests/test_tenant.py holds converged fits' objectives to 1e-5; t16's
# fits stop after at most 12 sweeps at ε = 1e-3, far from convergence,
# where the objective moves to first order with the centers, so there it
# gets the 1e-4 bar that file gives fits one sweep apart.
TENANT_D, TENANT_C = 4, 3
TENANT_RUNS = (TenantRun("tenants_t16", 1024, (8, 30), (), 1e-3, 12, 16,
                         1e-4),
               TenantRun("tenants_65k", 65_536, (64, 513), (1.5, 3.0), 1e-6,
                         300, 64, 1e-5))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def max_err(got, want, rtol, atol, what):
    """Largest |got − want| over the outputs; raises past rtol/atol
    (``atol`` one number, or one per output)."""
    import torch
    worst = 0.0
    atols = atol if isinstance(atol, tuple) else (atol,) * len(want)
    for i, (g, e, atol) in enumerate(zip(got, want, atols)):
        if g.shape != e.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: output {i} has shape "
                                 f"{tuple(g.shape)} or non-finite values")
        diff = (g - e).abs()
        over = diff - (atol + rtol * e.abs())
        if bool((over > 0).any()):
            raise AssertionError(
                f"{what}: output {i} off by {float(diff.max()):.3e} "
                f"(rtol {rtol}, atol {atol})")
        worst = max(worst, float(diff.max()))
    return worst


def time_ms(fn, reps: int) -> float:
    """Median milliseconds per call, CUDA events around each call after
    two warm-up calls (at small shapes this counts the host's enqueue)."""
    import torch
    for _ in range(2):
        fn()
    events = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


@functools.cache
def graph_stream():
    """The one side stream every CUDA graph here is captured on: a library
    call keeps a workspace per stream it ran on (cuBLAS's is tens of MB),
    so a fresh stream per timing would leave a new one behind each time."""
    import torch
    return torch.cuda.Stream()


def time_loop_ms(fn, reps: int) -> float:
    """Milliseconds per launch on the card: ``reps`` back-to-back calls
    captured in one CUDA graph (after two warm-up calls on its stream),
    one pair of CUDA events around its replay, divided by ``reps``.  The
    replay takes the host's per-call enqueue out, so at small shapes this
    is the card's time: the kernels and the gaps between them."""
    import torch
    stream = graph_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    del graph
    return s.elapsed_time(e) / reps


def shape_counts(fn) -> dict:
    """A wrapper's launches per shape, as {"path NxC" or "path TxN":
    count}."""
    return {" ".join([k[0], "x".join(map(str, k[1:]))]): v
            for k, v in sorted(fn.shapes.items(), key=str)}


def check_paths(run: str, *fns) -> None:
    """Every launch of ``fns`` took ``EXPECTED_PATH[run]``."""
    other = {k: v for fn in fns for k, v in fn.shapes.items()
             if k[0] != EXPECTED_PATH[run]}
    if other:
        raise AssertionError(f"{run}: launches off the expected "
                             f"{EXPECTED_PATH[run]!r} path: {other}")


def bound_bytes(n: int, d: int, c: int) -> int:
    """Bytes one sweep must move: x, w and V read once, v_num, w_i and q
    written once."""
    return 4 * (n * (d + 1) + c * d + c * d + c + 1)


def bound(n: int, d: int, c: int):
    """(ms, what sets it): each input read once, each output written
    once (`bound_bytes`), against 4·N·C·d f32 flops (the two
    contractions)."""
    nbytes = bound_bytes(n, d, c)
    flops = 4 * n * c * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _inputs(n, d, c, seed, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a).to(device) for a in (
        rng.normal(size=(n, d)).astype(np.float32),
        rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32),
        rng.normal(size=(c, d)).astype(np.float32))]


def q_rounding_bound(x, w, v) -> float:
    """How far the kernel's q may sit from the plain version's when
    records lie on centers.  The kernel forms d² = ‖x‖² + ‖v‖² − 2x·v,
    as the TPU kernel does (src/repro/kernels/fcm_update.py:56-61); the
    plain version forms ‖x − v‖² directly.  In f32 the two differ by up
    to 2·γ_{d+2}·(‖x‖² + ‖v‖²) per entry (γ_k = k·2⁻²⁴, the dot-product
    rounding bound), which is all of d² for a record on a center, and
    Σ_i u_ik^m ≤ 1."""
    gamma = (x.shape[1] + 2) * 2.0 ** -24
    return 2 * gamma * float(
        (w * ((x * x).sum(1) + (v * v).sum(1).max())).sum())


def driver_cases(run: Run, seed: int, device):
    """The kernel's inputs on the driver race at ``run``'s d, C and m, with
    records drawn from N(0, 1): (label, x, w, centers, atol of q).

    * ``sample``: FCM on the λ-row sample, unit weights, seeded with C of
      its rows;
    * ``last_block``: WFCMPB's last block, the rows past the sample's end
      zero-weight phantoms of zeros;
    * ``first_merge``: WFCMPB's first merge, the zero-mass running summary
      beside the block's C centers with their masses, seeded with those
      centers (so C records lie on centers: q is held to
      `q_rounding_bound`)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lam, d, c = min(SAMPLE_SIZE, run.n), run.d, run.c

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    x = rng.normal(size=(lam, d))
    yield "sample", t(x), t(np.ones(lam)), t(x[:c]), 0.0
    real = lam - (-(-lam // BLOCK_SIZE) - 1) * BLOCK_SIZE
    xb, wb = np.zeros((BLOCK_SIZE, d)), np.zeros(BLOCK_SIZE)
    xb[:real], wb[:real] = x[lam - real:], 1.0
    yield "last_block", t(xb), t(wb), t(rng.normal(size=(c, d))), 0.0
    vb = rng.normal(size=(c, d))
    pts = t(np.concatenate([x[:c], vb]))
    masses = t(np.concatenate([np.zeros(c), rng.uniform(1.0, BLOCK_SIZE, c)]))
    yield ("first_merge", pts, masses, t(vb),
           q_rounding_bound(pts, masses, t(vb)))


def check_kernels(device) -> dict:
    """Phase 2: kernel vs plain at the test shapes, chunk additivity,
    determinism, and at the driver race's inputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, fcm_sweep_ref)
    worst = {"fcm_sweep": 0.0, "fcm_accumulate": 0.0}
    cases = 0
    for shape in SHAPES + OFF_LANE_SHAPES:
        n, d, c = shape
        x, w, v = _inputs(n, d, c, n + d + c, device)
        atol = SWEEP_ATOL if shape in SHAPES else OFF_LANE_ATOL
        for m in M_SWEEP:
            what = f"shape {shape} m={m}"
            got = fcm_sweep_cuda(x, w, v, m)
            worst["fcm_sweep"] = max(worst["fcm_sweep"], max_err(
                got, fcm_sweep_ref(x, w, v, m), RTOL, atol, "sweep " + what))
            acc = fcm_accumulate_cuda(x, w, v, m)
            worst["fcm_accumulate"] = max(worst["fcm_accumulate"], max_err(
                acc, fcm_accumulate_ref(x, w, v, m), RTOL, ACC_ATOL,
                "accumulate " + what))
            if not all(torch.equal(a, b) for a, b in zip(
                    acc, fcm_accumulate_cuda(x, w, v, m))):
                raise AssertionError(f"two launches differ at {what}")
            cases += 1
    x, w, v = _inputs(900, 11, 5, 17, device)
    cuts = [0, 250, 600, 900]
    chunked = ops.accumulate_chunks([x[a:b] for a, b in zip(cuts, cuts[1:])],
                                    [w[a:b] for a, b in zip(cuts, cuts[1:])],
                                    v, 2.0)
    max_err(chunked, fcm_sweep_cuda(x, w, v, 2.0), 1e-5, 1e-5,
            "chunk additivity")
    driver = {}
    for run in RUNS:
        for label, x, w, v, q_atol in driver_cases(run, 7, device):
            what = f"{label} of {run.name} {tuple(x.shape)} C={run.c}"
            got = fcm_sweep_cuda(x, w, v, run.m)
            acc = fcm_accumulate_cuda(x, w, v, run.m)
            driver[f"{run.name}/{label}"] = max(
                max_err(got, fcm_sweep_ref(x, w, v, run.m), RTOL,
                        (SWEEP_ATOL, SWEEP_ATOL, SWEEP_ATOL + q_atol),
                        "sweep at " + what),
                max_err(acc, fcm_accumulate_ref(x, w, v, run.m), RTOL,
                        (ACC_ATOL, ACC_ATOL, ACC_ATOL + q_atol),
                        "accumulate at " + what))
            if not all(torch.equal(a, b) for a, b in zip(
                    acc, fcm_accumulate_cuda(x, w, v, run.m))):
                raise AssertionError(f"two launches differ at {what}")
    return {"phase": "kernels", "cases": cases, "m": list(M_SWEEP),
            "max_abs_err": worst, "chunk_additivity": "ok",
            "driver_cases_max_abs_err": driver,
            "bitwise_deterministic": True}


def checked_hopper():
    """The ``hopper`` backend with every sweep over records (the driver's
    sample, WFCMPB's blocks and its final objective pass) held against
    the plain version on the same inputs, at the sweep tolerances.
    Merges (at most 2·C points) are counted, not held: their records sit
    on or next to centers, where the kernel's d² expansion and the plain
    version's direct ‖x − v‖² part by rounding (see `q_rounding_bound`);
    phase 2's ``first_merge`` holds the kernel at their shape."""
    from repro_torch.engine import SweepBackend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, fcm_sweep_ref)

    class CheckedHopper(SweepBackend):
        name = "hopper_checked"
        compared = merges = 0
        worst = 0.0

        def _hold(self, kern, plain, atol, x, w, v, m):
            got = kern(x, w, v, m)
            if x.shape[0] <= 2 * v.shape[0]:
                self.merges += 1
                return got
            self.worst = max(self.worst, max_err(
                got, plain(x, w, v, m), RTOL, atol,
                f"{kern.__name__} on the driver race, x {tuple(x.shape)}"))
            self.compared += 1
            return got

        def accumulate(self, x, w, v, m):
            return self._hold(fcm_accumulate_cuda, fcm_accumulate_ref,
                              ACC_ATOL, x, w, v, m)

        def sweep(self, x, w, v, m):
            return self._hold(fcm_sweep_cuda, fcm_sweep_ref, SWEEP_ATOL,
                              x, w, v, m)

    return CheckedHopper()


def check_driver(x, sample_idx, seed_idx, cfg, device) -> dict:
    """The driver race's two branches on the full-size sample, as
    `run_driver` runs them: through `checked_hopper`, and through the
    ``torch`` backend.  A branch whose ``torch`` centers move by more
    than 1e-4 of the sample's RMS when the sample is scaled by 1 + 2⁻²²
    is not fixed by its data at f32 precision: its hopper-vs-torch gap
    is printed, not held.  Iteration counts are printed, not held: the
    driver's ε = 5e-11 on max ‖ΔV‖² lies near the rounding floor of one
    f32 sweep, so when the loop stops is set by summation order."""
    import torch
    from repro_torch.core import fcm, wfcmpb
    xs = x[torch.as_tensor(sample_idx, device=x.device)]
    seeds = xs[torch.as_tensor(seed_idx, device=x.device)]
    scale = float(torch.sqrt(torch.mean(xs * xs)))
    common = dict(m=cfg.m, eps=cfg.driver_eps, max_iter=cfg.max_iter,
                  device=device)
    branches = (
        ("fcm", lambda a, be: fcm(a, seeds, backend=be, **common)),
        ("wfcmpb", lambda a, be: wfcmpb(a, seeds, block_size=cfg.block_size,
                                        backend=be, **common)))
    out = {}
    for name, fit in branches:
        checked = checked_hopper()
        hop, tor = fit(xs, checked), fit(xs, "torch")
        nudged = fit(xs * (1 + 2.0 ** -22), "torch")
        rec = {"center_gap_rel_rms": float(
                   (hop.centers - tor.centers).abs().max()) / scale,
               "q_rel": abs(float(hop.objective) - float(tor.objective))
               / abs(float(tor.objective)),
               "iters_hopper": hop.n_iter, "iters_torch": tor.n_iter,
               "iters_torch_nudged": nudged.n_iter,
               "torch_nudged_rel_rms": float(
                   (nudged.centers - tor.centers).abs().max()) / scale,
               "sweeps_held": checked.compared,
               "merges_counted": checked.merges,
               "sweep_max_abs_err": checked.worst}
        rec["held"] = rec["torch_nudged_rel_rms"] <= 1e-4
        out[name] = rec
        if checked.compared == 0 or rec["held"] and (
                rec["center_gap_rel_rms"] > 1e-3 or rec["q_rel"] > 1e-4):
            raise AssertionError(f"driver {name} hopper vs torch: {rec}")
    return out


def shape_entries(run_name, cases, by_shape, d, m, device, reps,
                  full="full") -> list:
    """Each kernel entry against its plain version, and timed, at every
    case of ``cases`` ({label: (x, w, centers, extra)}, ``extra`` the
    atol added to q's, or one per output)) whose (N, C)
    the run launched it at (``by_shape``: each wrapper's {(path, N, C):
    launches}); the ``full`` case always.  Two launches must agree bit
    for bit.  Returns one kernel-line entry per (kernel, case)."""
    import torch
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, fcm_sweep_ref,
                                                launch_plan)
    entries = []
    for kname, kern, plain_fn, atol in (
            ("fcm_sweep", fcm_sweep_cuda, fcm_sweep_ref, SWEEP_ATOL),
            ("fcm_accumulate", fcm_accumulate_cuda, fcm_accumulate_ref,
             ACC_ATOL)):
        for label, (xs, ws, vs, extra) in cases.items():
            ns, c = xs.shape[0], vs.shape[0]
            if not isinstance(extra, tuple):
                extra = (0.0, 0.0, extra)
            count = sum(v for k, v in by_shape[kname].items()
                        if k[1:] == (ns, c))
            if label != full and count == 0:
                continue
            path = launch_plan(device, ns, d, c).path
            plain = plain_fn
            if path == "ctiled":    # its broadcast takes N·C·d floats
                plain = plain_in_rows(fcm_accumulate_ref,
                                      kname == "fcm_sweep")
            got = kern(xs, ws, vs, m)
            if not all(torch.equal(a, b) for a, b in zip(
                    got, kern(xs, ws, vs, m))):
                raise AssertionError(f"{kname}: two launches differ at "
                                     f"{run_name}/{label}")
            want = plain(xs, ws, vs, m)
            err = max_err(got, want, RTOL, tuple(atol + e for e in extra),
                          f"{kname} at {run_name}/{label}")
            del want
            n_rep = reps if label == full else 500
            ms = time_loop_ms(lambda: kern(xs, ws, vs, m), n_rep)
            per_call = time_ms(lambda: kern(xs, ws, vs, m), n_rep)
            plain_ms = time_ms(lambda: plain(xs, ws, vs, m),
                               3 if label == full else 50)
            torch.cuda.empty_cache()
            b_ms, b_by = bound(ns, d, c)
            entries.append({
                "name": kname, "run": f"{run_name}/{label}",
                "launches": count, "max_abs_err": err, "ms": ms,
                "ms_per_call": per_call, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                "shape": [ns, d, c], "path": path})
            if path == "ctiled":
                plan = launch_plan(device, ns, d, c)
                entries[-1]["launch_ms"] = ctiled_launch_ms(
                    kern, (xs, ws, vs, m), n_rep, plan.dsplits > 1)
                entries[-1]["dsplits"] = plan.dsplits
                entries[-1]["member_library_ms"] = membership_library_ms(
                    xs, vs, n_rep)
                entries[-1]["contraction_library_ms"] = (
                    contraction_library_ms(xs, c, n_rep))
                if label == full:
                    entries[-1]["library_ms"] = entries[-1][
                        "contraction_library_ms"]
    return entries


def contraction_library_ms(x, c, reps) -> float:
    """The C-tiled kernel's contraction half, v_num = wumᵀx, is one matrix
    product: ``torch.matmul`` of an (N, C) f32 block with x (IEEE f32, no
    TF32), timed as the kernel is.  A yardstick only: the port never
    calls it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    wum = torch.rand((x.shape[0], c), dtype=torch.float32, device=x.device)
    return time_loop_ms(lambda: torch.matmul(wum.T, x), reps)


def membership_library_ms(x, v, reps) -> float:
    """The membership half's product x·vᵀ, the (N, C) block the C-tiled
    kernel forms d² from: ``torch.matmul`` in IEEE f32, timed as the
    kernel is.  A yardstick only: the port never calls it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    return time_loop_ms(lambda: torch.matmul(x, v.T), reps)


# One chunk's launches: the membership (with d-splits, their partials and
# then their sum), the contraction, the finish.
CTILED_STAGES = ("member", "member_finish", "contract", "finish")


class _StageLib:
    """The C-tiled library with its chunk call cut to one launch:
    ``fcm_ctiled_chunk(*args)`` runs ``stage_fn(stage, *args)``."""

    def __init__(self, lib, stage_fn, stage):
        self._lib, self._stage_fn, self._stage = lib, stage_fn, stage

    def fcm_ctiled_chunk(self, *args):
        return self._stage_fn(self._stage, *args)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def ctiled_launch_ms(kern, args, reps, dsplit, stage_fn=None) -> dict:
    """The C-tiled sweep's launches timed apart: ``kern(*args)`` with each
    row chunk cut to one of its launches (CTILED_STAGES), each timed as
    `time_loop_ms` times the whole; "member_finish" is 0.0 unless
    ``dsplit`` (the plan splits d, so that it launches).  ``stage_fn``
    (stage, *chunk args) launches one of them; by default the library's
    own ``fcm_ctiled_stage``.  Alone, a launch reads scratch that the one
    before it did not write: its time, not its values, is what this
    measures."""
    from repro_torch.kernels import fcm_update as fu
    real = fu._ctiled_lib
    lib = real()
    stage_fn = stage_fn or lib.fcm_ctiled_stage
    out = {}
    try:
        for stage, name in enumerate(CTILED_STAGES):
            if name == "member_finish" and not dsplit:
                out[name] = 0.0
                continue
            fu._ctiled_lib = lambda s=stage: _StageLib(lib, stage_fn, s)
            out[name] = time_loop_ms(lambda: kern(*args), reps)
    finally:
        fu._ctiled_lib = real
    return out


def run_main_path(run: Run, n: int, seed: int, device, reps: int):
    """Phase 3 for one dataset: the main path with counted launches, the
    hopper-vs-torch comparison at full size, and the per-kernel checks
    and times.  Returns (phase record, kernel entries)."""
    import numpy as np
    import torch
    from repro_torch.core import BigFCMConfig, bigfcm_fit
    from repro_torch.data import synth
    from repro_torch.device import synchronize
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)

    t0 = time.perf_counter()
    x_np, _ = getattr(synth, run.maker)(n, seed=seed)
    x = torch.from_numpy(x_np).to(device)
    n, d = x.shape
    if d != run.d:
        raise AssertionError(f"{run.maker} gave d={d}, expected {run.d}")
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    cfg = BigFCMConfig(n_clusters=run.c, m=run.m, combiner_eps=run.eps,
                       reducer_eps=run.eps, max_iter=1000,
                       sample_size=min(SAMPLE_SIZE, n),
                       block_size=BLOCK_SIZE, seed=seed, backend="hopper")
    backend = cfg.backend

    # -- the main path, with launch counts zeroed just before it
    reset_counts()
    synchronize(device)
    t0 = time.perf_counter()
    res = bigfcm_fit(x, cfg, device=device)
    _, _, q = get_backend("hopper_accumulate").accumulate(
        x, ones, res.centers, run.m)
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    if device.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    check_paths(run.name, fcm_sweep_cuda, fcm_accumulate_cuda)
    if res.centers.shape != (run.c, d) or not (
            bool(torch.isfinite(res.centers).all()) and math.isfinite(float(q))):
        raise AssertionError("main path gave non-finite or mis-shaped output")
    diag = res.diagnostics
    roof = roofline_record(n, run.c, d, x, ones, res.centers, run.m, device)
    record = {"phase": "main_path", "run": run.name, "n": n, "d": d,
              "c": run.c, "m": run.m, "eps": run.eps, "backend": backend,
              "setup_s": setup_s, "wall_s": wall, "flag": diag.flag,
              "t_fcm_driver_s": diag.t_fcm_driver,
              "t_wfcmpb_driver_s": diag.t_wfcmpb_driver,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "global_q": float(q),
              "launches": launches,
              "launches_by_shape": {
                  "fcm_sweep": shape_counts(fcm_sweep_cuda),
                  "fcm_accumulate": shape_counts(fcm_accumulate_cuda)},
              "roofline": roof}

    # -- hopper vs the torch backend, same injected seeds, full size
    rng = np.random.default_rng(seed)
    sample_idx = rng.choice(n, cfg.sample_size, replace=False)
    seed_idx = rng.choice(cfg.sample_size, run.c, replace=False)
    fits, qs = {}, {}
    for name, acc_backend in (("hopper", "hopper_accumulate"),
                              ("torch", "torch")):
        fits[name] = bigfcm_fit(
            x, dataclasses.replace(cfg, use_driver=False, backend=name),
            sample_idx=sample_idx, seed_idx=seed_idx, device=device)
        qs[name] = float(get_backend(acc_backend).accumulate(
            x, ones, fits[name].centers, run.m)[2])
    scale = float(torch.sqrt(torch.mean(x * x)))
    center_err = float((fits["hopper"].centers - fits["torch"].centers)
                       .abs().max()) / scale
    q_rel = abs(qs["hopper"] - qs["torch"]) / abs(qs["torch"])
    it = {k: (f.diagnostics.combiner_iters[0], f.diagnostics.reducer_iters)
          for k, f in fits.items()}
    # What the store phase holds its fits against: the in-memory fits of
    # the same array from the same injected draws.
    held = {"x": x_np, "cfg": cfg, "sample_idx": sample_idx,
            "seed_idx": seed_idx, "q": qs, "iters": it,
            "centers": {k: f.centers.cpu() for k, f in fits.items()}}
    record["vs_torch"] = {"center_err_rel_rms": center_err, "q_rel": q_rel,
                          "iters_hopper": it["hopper"],
                          "iters_torch": it["torch"]}
    # f32 summation order over 10^7 rows differs, and ε bounds only ΔV².
    if center_err > 1e-3 or q_rel > 1e-4 or any(
            abs(a - b) > 2 for a, b in zip(it["hopper"], it["torch"])):
        raise AssertionError(f"hopper vs torch at {run.name}: "
                             f"{record['vs_torch']}")
    record["driver_vs_torch"] = check_driver(x, sample_idx, seed_idx, cfg,
                                             device)
    emit(record)

    # -- each kernel entry vs its plain version at every shape the main
    #    path launched it at, and timed there
    cases = {"full": (x, ones, res.centers, 0.0)}
    for label, xs, ws, vs, q_atol in driver_cases(run, 7, device):
        cases[DRIVER_LABEL[label]] = (xs, ws, vs, q_atol)
    # Any other size the main path launched at (C-point merges, the
    # objective over a run of blocks): its first records, unit weights.
    for ns in sorted({k[1] for shapes in by_shape.values() for k in shapes}
                     - {xs.shape[0] for xs, *_ in cases.values()}):
        xs = x[:ns]
        cases[f"n={ns}"] = (xs, ones[:ns], res.centers,
                            q_rounding_bound(xs, ones[:ns], res.centers))
    entries = shape_entries(run.name, cases, by_shape, d, run.m, device,
                            reps)
    return entries, held


# router_fit: the fit src/repro/integration/router_init.py:40-47 runs
# through bigfcm_fit, at OLMoE-1B-7B's d_model x n_experts
# (src/repro/configs/olmoe_1b_7b.py:6,8), with router_init.py:40-42's own
# config; the driver's sample is Parker-Hall's (521,663 rows at C = 64:
# every row).
ROUTER_N, ROUTER_D, ROUTER_C, ROUTER_M = 262_144, 2048, 64, 2.0
ROUTER_SEP = 2.0        # spread of the component means, per dim


def make_router_like(n, d, c, seed):
    """Token-embedding-like rows: c Gaussian components of unequal mass
    (p_k ∝ (k + 1)^-0.8, as token frequencies fall off), means N(0,
    ROUTER_SEP²) per dim, unit spread; f32, made with numpy from
    ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, ROUTER_SEP, size=(c, d)).astype(np.float32)
    p = (np.arange(1, c + 1) ** -0.8)
    labels = rng.choice(c, size=n, p=p / p.sum())
    x = rng.standard_normal((n, d), dtype=np.float32)
    for r0 in range(0, n, 1 << 15):
        x[r0:r0 + (1 << 15)] += means[labels[r0:r0 + (1 << 15)]]
    return x


def router_config(seed):
    from repro_torch.core import BigFCMConfig
    return BigFCMConfig(n_clusters=ROUTER_C, m=ROUTER_M, combiner_eps=1e-6,
                        reducer_eps=1e-8, max_iter=200, seed=seed,
                        backend="hopper")


def hold_router_fits(x, ones, cfg, draws, device) -> dict:
    """``hold_fit``'s gates on the fit through ``hopper`` against the
    ``torch`` backend from the same injected draws (driver off, as
    `run_main_path` holds its fits).  What a ``torch`` fit of the data
    scaled by 1 + 2⁻²² moves is not fixed by the data at f32: a sweep
    count that misses its ±2 must move so there (the reducer polishes C
    points on their own centers, where the d² expansion is rounding
    noise, and can wander to ``max_iter``); centers or q that miss their
    bars must have moved by more than 1e-4 of the RMS there, and are
    then held against a float64 ``torch`` twin as PR 15's steps are: the
    hopper fit as near it as the ``torch`` one (2×)."""
    import torch
    from repro_torch.core import bigfcm_fit
    from repro_torch.engine import get_backend

    def fit(xs, backend):
        f = bigfcm_fit(xs, dataclasses.replace(cfg, use_driver=False,
                                               backend=backend),
                       sample_idx=draws[0], seed_idx=draws[1], device=device)
        acc = "hopper_accumulate" if backend == "hopper" else "torch"
        q = float(get_backend(acc).accumulate(
            xs, ones.to(xs.dtype), f.centers, cfg.m)[2])
        return f.centers, q, fit_iters(f)

    scale = float(torch.sqrt(torch.mean(x * x)))
    hop, tor = fit(x, "hopper"), fit(x, "torch")
    rec = {"center_err_rel_rms": float((hop[0] - tor[0]).abs().max())
           / scale, "q_rel": abs(hop[1] - tor[1]) / abs(tor[1]),
           "iters": [hop[2], tor[2]]}
    bars = rec["center_err_rel_rms"] <= 1e-3 and rec["q_rel"] <= 1e-4
    if bars and all(abs(a - b) <= 2 for a, b in zip(hop[2], tor[2])):
        return rec
    nudged = fit(x * (1 + 2.0 ** -22), "torch")
    rec["torch_nudged_iters"] = nudged[2]
    rec["torch_nudged_rel_rms"] = float(
        (nudged[0] - tor[0]).abs().max()) / scale
    if bars:
        if all(abs(a - b) <= 2 or abs(u - b) > 2
               for a, b, u in zip(hop[2], tor[2], nudged[2])):
            return rec
        raise AssertionError(f"router_fit sweeps: {rec}")
    with float64():
        exact = fit(x.double(), "torch")

    def gap(a):
        return (float((a[0].double() - exact[0]).abs().max()) / scale,
                abs(a[1] - exact[1]) / abs(exact[1]))
    rec.update(hopper_vs_float64=gap(hop), torch_vs_float64=gap(tor),
               float64_iters=exact[2])
    if rec["torch_nudged_rel_rms"] <= 1e-4 or any(
            h > 2 * t for h, t in zip(rec["hopper_vs_float64"],
                                      rec["torch_vs_float64"])):
        raise AssertionError(f"router_fit: {rec}")
    return rec


def run_router_fit(seed: int, device, reps: int):
    """Phase 3b: `bigfcm_fit` on backend ``hopper`` at router_fit's full width
    (the C-tiled kernel's main path), launch counts zeroed just before it
    and read after the global objective pass; the fit held against the
    ``torch`` backend (`hold_router_fits`); each kernel entry against its
    plain version (in row chunks) at every shape the fit launched it at,
    and timed.  Returns (phase record, kernel entries)."""
    import numpy as np
    import torch
    from repro_torch.core import bigfcm_fit
    from repro_torch.device import synchronize
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)

    t0 = time.perf_counter()
    x_np = make_router_like(ROUTER_N, ROUTER_D, ROUTER_C, seed)
    x = torch.from_numpy(x_np).to(device)
    del x_np
    ones = torch.ones((ROUTER_N,), dtype=torch.float32, device=device)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    cfg = router_config(seed)
    backend = cfg.backend

    reset_counts()
    synchronize(device)
    t0 = time.perf_counter()
    res = bigfcm_fit(x, cfg, device=device)
    _, _, q = get_backend("hopper_accumulate").accumulate(
        x, ones, res.centers, cfg.m)
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    if min(launches.values()) == 0:
        raise AssertionError(f"router_fit: a kernel was not launched: "
                             f"{launches}")
    check_paths("router_fit", fcm_sweep_cuda, fcm_accumulate_cuda)
    if res.centers.shape != (ROUTER_C, ROUTER_D) or not (
            bool(torch.isfinite(res.centers).all())
            and math.isfinite(float(q))):
        raise AssertionError("router_fit gave non-finite or mis-shaped "
                             "output")
    diag = res.diagnostics
    record = {"phase": "main_path", "run": "router_fit", "n": ROUTER_N,
              "d": ROUTER_D, "c": ROUTER_C, "m": cfg.m,
              "combiner_eps": cfg.combiner_eps,
              "reducer_eps": cfg.reducer_eps, "max_iter": cfg.max_iter,
              "sample_size": diag.sample_size, "backend": backend,
              "setup_s": setup_s, "wall_s": wall, "flag": diag.flag,
              "t_fcm_driver_s": diag.t_fcm_driver,
              "t_wfcmpb_driver_s": diag.t_wfcmpb_driver,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "global_q": float(q),
              "launches": launches,
              "launches_by_shape": {
                  "fcm_sweep": shape_counts(fcm_sweep_cuda),
                  "fcm_accumulate": shape_counts(fcm_accumulate_cuda)}}
    record["ctiled_plans"] = router_plans(by_shape, device)
    rng = np.random.default_rng(seed)
    lam = diag.sample_size
    draws = (rng.choice(ROUTER_N, lam, replace=False),
             rng.choice(lam, ROUTER_C, replace=False))
    record["hold"] = hold_router_fits(x, ones, cfg, draws, device)
    emit(record)

    cases = {"full": (x, ones, res.centers, 0.0)}
    for ns in sorted({k[1] for shapes in by_shape.values() for k in shapes}
                     - {ROUTER_N}):
        xs = x[:ns]
        cases[f"n={ns}"] = (xs, ones[:ns], res.centers,
                            q_rounding_bound(xs, ones[:ns], res.centers))
    entries = shape_entries("router_fit", cases, by_shape, ROUTER_D,
                            cfg.m, device, reps)
    del x
    torch.cuda.empty_cache()
    return entries


ROUTER_DSPLIT_N = (2 * ROUTER_C, BLOCK_SIZE)   # WFCMPB's merges and blocks


def router_plans(by_shape, device) -> dict:
    """The C-tiled plan of every (N, C) router_fit launched at, with its
    launches (`_ctiled_launch` runs the plan's d-splits at every
    launch); fails unless the 2·C-point merges and the 2048-row blocks
    were launched with d split across CTAs."""
    from repro_torch.kernels.fcm_update import launch_plan
    launched = collections.Counter()
    for shapes in by_shape.values():
        for (_, ns, c), count in shapes.items():
            launched[ns, c] += count
    plans = {}
    for (ns, c), count in sorted(launched.items()):
        plan = launch_plan(device, ns, ROUTER_D, c)
        plans[f"{ns}x{c}"] = {"launches": count, "tile": plan.tile,
                              "dsplits": plan.dsplits,
                              "member_ctas": plan.grid,
                              "contract_splits": plan.splits}
    for ns in ROUTER_DSPLIT_N:
        got = plans.get(f"{ns}x{ROUTER_C}")
        if got is None or got["dsplits"] < 2:
            raise AssertionError(f"router_fit: no d-split launch at N = {ns}: "
                                 f"{plans}")
    return plans


def tenant_stack(t, n, d, c, seed, device, phantoms=2):
    """K3's inputs: t tenants of ragged rows (at least n/3 of the n-row
    bucket, the rest zero-weight phantom rows), then ``phantoms``
    all-zero phantom tenants, and per-tenant m drawn from M_SWEEP."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = np.zeros((t + phantoms, n, d), np.float32)
    w = np.zeros((t + phantoms, n), np.float32)
    v = np.zeros((t + phantoms, c, d), np.float32)
    for i in range(t):
        rows = int(rng.integers(max(1, n // 3), n + 1))
        x[i, :rows] = rng.normal(size=(rows, d))
        w[i, :rows] = rng.uniform(0.1, 3.0, size=rows)
        v[i] = rng.normal(size=(c, d))
    m = rng.choice(M_SWEEP, size=t + phantoms).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, w, v, m)]


def check_tenant_kernels(device) -> dict:
    """Phase 2b: the tenant-stacked kernel (K3) against its plain version
    at the test_kernels tolerances, per-tenant and scalar m, two
    phantom tenants; bit-identical reruns, exact zeros on phantoms, and
    one tenant against the single-model kernel (K1/K2)."""
    import torch
    from repro_torch.kernels.fcm_update import (
        fcm_accumulate_batched_cuda, fcm_accumulate_batched_ref,
        fcm_accumulate_cuda, fcm_sweep_batched_cuda, fcm_sweep_batched_ref,
        fcm_sweep_cuda)
    worst = {"fcm_sweep_batched": 0.0, "fcm_accumulate_batched": 0.0}
    cases = 0
    for t in (1, 5, 64):
        for d in (4, 41):
            for c in (3, 23):
                x, w, v, m_t = tenant_stack(t, 300, d, c, t + d + c, device)
                for m in (m_t, 1.2):
                    what = (f"T={t}+2 phantoms N=300 d={d} C={c} "
                            f"m={'per-tenant' if m is m_t else m}")
                    got = fcm_sweep_batched_cuda(x, w, v, m)
                    acc = fcm_accumulate_batched_cuda(x, w, v, m)
                    worst["fcm_sweep_batched"] = max(
                        worst["fcm_sweep_batched"], max_err(
                            got, fcm_sweep_batched_ref(x, w, v, m), RTOL,
                            SWEEP_ATOL, "batched sweep " + what))
                    worst["fcm_accumulate_batched"] = max(
                        worst["fcm_accumulate_batched"], max_err(
                            acc, fcm_accumulate_batched_ref(x, w, v, m),
                            RTOL, ACC_ATOL, "batched accumulate " + what))
                    again = (fcm_sweep_batched_cuda(x, w, v, m)
                             + fcm_accumulate_batched_cuda(x, w, v, m))
                    if not all(torch.equal(a, b)
                               for a, b in zip(got + acc, again)):
                        raise AssertionError(f"two K3 launches differ: {what}")
                    if any(bool(o[t:].abs().any()) for o in got + acc):
                        raise AssertionError(f"phantom tenants not 0: {what}")
                    cases += 1
    one = {}
    for d, c, m in ((4, 3, 2.0), (41, 23, 1.2)):
        x, w, v = _inputs(20_000, d, c, d + c, device)
        for kb, k1, atol in ((fcm_sweep_batched_cuda, fcm_sweep_cuda,
                              SWEEP_ATOL),
                             (fcm_accumulate_batched_cuda,
                              fcm_accumulate_cuda, ACC_ATOL)):
            got = [o[0] for o in kb(x[None], w[None], v[None], m)]
            one[f"{kb.__name__}/d{d}c{c}"] = max_err(
                got, k1(x, w, v, m), RTOL, atol,
                f"{kb.__name__} T=1 vs {k1.__name__} d={d} C={c}")
    return {"phase": "tenant_kernels", "cases": cases,
            "max_abs_err": worst, "one_tenant_vs_k1_max_abs_err": one,
            "bitwise_deterministic": True, "phantom_tenants_exact_zero": True}


# The C-tiled kernel's checks (phase 2c): K1/K2 at router-fit widths
# (d = 900; OLMoE's 2048 × 64; Kimi-K2's 7168 × 384), K3 at 2048 × 64.
CTILED_SHAPES = ((4096, 900, 64), (4096, 2048, 64), (1024, 7168, 384))
CTILED_TENANTS = (3, 1000, 2048, 64)     # T with one all-phantom tenant
CTILED_CHUNKED_BUDGET = 1_200_000        # bytes: 2 tenant groups x 4 chunks
PLAIN_CHUNK_BYTES = 1 << 30


def plain_in_rows(acc_ref, normalize: bool):
    """A plain version over row chunks whose (rows, C, d) broadcast takes
    at most about PLAIN_CHUNK_BYTES (it takes N·C·d floats in one call:
    11 GB at (1024, 7168, 384)), raw sums added in row order, then the
    sweep's normalization: one call when one chunk holds every row.
    ``acc_ref`` is fcm_accumulate_ref or fcm_accumulate_batched_ref."""
    def plain(x, w, v, m):
        import torch
        axis = x.dim() - 2
        n = x.shape[axis]
        lead = x.shape[0] if x.dim() == 3 else 1
        rows = max(1, PLAIN_CHUNK_BYTES // (4 * lead * v.shape[-2]
                                            * x.shape[-1]))
        out = None
        for r0 in range(0, n, rows):
            part = acc_ref(x.narrow(axis, r0, min(rows, n - r0)),
                           w.narrow(axis, r0, min(rows, n - r0)), v, m)
            out = part if out is None else tuple(
                a + b for a, b in zip(out, part))
        if normalize:
            v_num, w_i, q = out
            out = (v_num / torch.clamp(w_i, min=1e-12)[..., None], w_i, q)
        return out
    return plain


def launched_path(fn, before) -> str:
    """The one path ``fn`` launched since its ``shapes`` were ``before``."""
    new = fn.shapes - before
    if len(new) != 1:
        raise AssertionError(f"{fn.__name__}: launched {dict(new)}")
    return next(iter(new))[0]


def hold_ctiled(kern, plain, args, atols, what) -> float:
    """One C-tiled launch against its plain version (``atols`` per
    output), counted on path "ctiled", and a bit-identical rerun."""
    import torch
    before = kern.shapes.copy()
    got = kern(*args)
    if launched_path(kern, before) != "ctiled":
        raise AssertionError(f"{what}: not on the C-tiled path")
    err = max_err(got, plain(*args), RTOL, atols, what)
    if not all(torch.equal(a, b) for a, b in zip(got, kern(*args))):
        raise AssertionError(f"{what}: two launches differ")
    return err


def check_ctiled_kernels(device) -> dict:
    """Phase 2c: the C-tiled kernel (csrc/fcm_ctiled.cu) against its plain
    version (computed in row chunks) at test_kernels.py's tolerances:
    K1/K2 at CTILED_SHAPES for m = 2 and 1.2, with zero-weight phantom
    rows, and with C records on the centers (q held to the expansion's
    rounding bound); K3 at CTILED_TENANTS with per-tenant and scalar m,
    the phantom tenant exactly 0; and K3/K1 with the scratch cut to
    CTILED_CHUNKED_BUDGET, so that raw sums add over tenant groups and
    row chunks.  Every launch is counted on path "ctiled"; each shape's
    kernel and plain times are printed."""
    import torch
    from repro_torch.kernels import fcm_update as fu
    sweep = plain_in_rows(fu.fcm_accumulate_ref, True)
    acc = plain_in_rows(fu.fcm_accumulate_ref, False)
    bsweep = plain_in_rows(fu.fcm_accumulate_batched_ref, True)
    bacc = plain_in_rows(fu.fcm_accumulate_batched_ref, False)
    errs, times = {}, {}
    for n, d, c in CTILED_SHAPES:
        x, w, v = _inputs(n, d, c, n + d + c, device)
        phantom_w = w.clone()
        phantom_w[n // 2:] = 0.0
        on_centers = x[:c]
        cases = [("m=2", (x, w, v, 2.0), 0.0), ("m=1.2", (x, w, v, 1.2), 0.0),
                 ("phantom rows", (x, phantom_w, v, 2.0), 0.0),
                 ("records on centers", (x, w, on_centers, 1.2),
                  q_rounding_bound(x, w, on_centers))]
        for label, args, q_atol in cases:
            what = f"ctiled ({n}, {d}, {c}) {label}"
            errs[what] = max(
                hold_ctiled(fu.fcm_sweep_cuda, sweep, args,
                            (SWEEP_ATOL, SWEEP_ATOL, SWEEP_ATOL + q_atol),
                            "sweep " + what),
                hold_ctiled(fu.fcm_accumulate_cuda, acc, args,
                            (ACC_ATOL, ACC_ATOL, ACC_ATOL + q_atol),
                            "accumulate " + what))
        times[f"{n}x{d}x{c}"] = {
            "sweep_ms": time_loop_ms(lambda: fu.fcm_sweep_cuda(x, w, v, 2.0),
                                     10),
            "launch_ms": ctiled_launch_ms(
                fu.fcm_sweep_cuda, (x, w, v, 2.0), 10,
                fu._plan(device.index, n, d, c).dsplits > 1),
            "plain_ms": time_ms(lambda: sweep(x, w, v, 2.0), 3),
            "bound_ms": bound(n, d, c)[0]}
        del x, w, v, phantom_w
        torch.cuda.empty_cache()
    t, n, d, c = CTILED_TENANTS
    x, w, v, m_t = tenant_stack(t - 1, n, d, c, t + n + d + c, device,
                                phantoms=1)
    for label, m in (("per-tenant m", m_t), ("m=1.2", 1.2)):
        what = f"ctiled K3 {CTILED_TENANTS} {label}"
        for kern, plain, atol in ((fu.fcm_sweep_batched_cuda, bsweep,
                                   SWEEP_ATOL),
                                  (fu.fcm_accumulate_batched_cuda, bacc,
                                   ACC_ATOL)):
            errs[f"{kern.__name__} {what}"] = hold_ctiled(
                kern, plain, (x, w, v, m), atol, what)
            if any(bool(o[t - 1:].abs().any()) for o in kern(x, w, v, m)):
                raise AssertionError(f"{what}: phantom tenant not 0")
    times["K3 " + "x".join(map(str, CTILED_TENANTS))] = {
        "sweep_ms": time_loop_ms(
            lambda: fu.fcm_sweep_batched_cuda(x, w, v, m_t), 10),
        "launch_ms": ctiled_launch_ms(
            fu.fcm_sweep_batched_cuda, (x, w, v, m_t), 10,
            fu._batched_plan(device.index, t, n, d, c).dsplits > 1),
        "plain_ms": time_ms(lambda: bsweep(x, w, v, m_t), 3),
        "bound_ms": bound_batched(t, n, d, c)[0]}
    # The scratch cut: several tenant groups and row chunks per launch.
    old = fu.CTILED_SCRATCH_BYTES
    fu.CTILED_SCRATCH_BYTES = CTILED_CHUNKED_BUDGET
    fu._plan.cache_clear()
    fu._batched_plan.cache_clear()
    try:
        plan = fu._batched_plan(device.index, t, n, d, c)
        chunks = len(fu.ctiled_chunks(plan, t, n))
        for kern, plain, atol in ((fu.fcm_sweep_batched_cuda, bsweep,
                                   SWEEP_ATOL),
                                  (fu.fcm_accumulate_batched_cuda, bacc,
                                   ACC_ATOL)):
            errs[f"{kern.__name__} chunked"] = hold_ctiled(
                kern, plain, (x, w, v, m_t), atol,
                f"{kern.__name__} in {chunks} chunks")
        errs["fcm_sweep_cuda chunked"] = hold_ctiled(
            fu.fcm_sweep_cuda, sweep, (x[0], w[0], v[0], float(m_t[0])),
            SWEEP_ATOL, "fcm_sweep_cuda in chunks")
    finally:
        fu.CTILED_SCRATCH_BYTES = old
        fu._plan.cache_clear()
        fu._batched_plan.cache_clear()
    if chunks < 3 or plan.scratch > CTILED_CHUNKED_BUDGET:
        raise AssertionError(f"chunked case: {chunks} chunks, scratch "
                             f"{plan.scratch}")
    return {"phase": "ctiled_kernels", "max_abs_err": errs,
            "chunked": {"chunks": chunks, "group": plan.group,
                        "rows": plan.rows, "scratch": plan.scratch},
            "times": times, "bitwise_deterministic": True,
            "phantom_tenant_exact_zero": True}


def tenant_cohort(run: TenantRun, seed: int):
    """``run``'s cohort, as benchmarks/t16_tenant.py makes it: tenant i
    holds U[lo, hi) records of N(0, 1) in d = 4 around 4.0·(i % 5); and
    its per-tenant fuzzifiers (None: the config's scalar m)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    data = [(rng.normal(size=(int(rng.integers(*run.rows)), TENANT_D))
             + 4.0 * (i % 5)).astype(np.float32)
            for i in range(run.tenants)]
    m_t = (rng.uniform(*run.m, size=run.tenants).astype(np.float32)
           if run.m else None)
    return data, m_t


def sweep64(X, W, V, m):
    """One tenant-stacked sweep in float64 with the direct ‖x − v‖²:
    (new centers, each tenant's Eq.-(2) objective at V, masses w_i)."""
    import torch
    x, mm = X.double(), m.double()[:, None, None]
    v = V.double()
    d2 = ((x[:, :, None, :] - v[:, None, :, :]) ** 2).sum(-1).clamp_min(
        1e-12)
    lg = d2.log()
    r = torch.exp(-(lg - lg.min(-1, keepdim=True).values) / (mm - 1.0))
    wum = (r / r.sum(-1, keepdim=True)) ** mm * W.double()[..., None]
    w_i = wum.sum(1)
    v_new = (wum.transpose(1, 2) @ x) / w_i.clamp_min(1e-12)[..., None]
    return v_new, (wum * d2).sum((1, 2)), w_i


def exact_trajectory(X, W, V0, m, counts, chunk=8192):
    """The exact trajectory: each tenant's float64 centers after
    ``counts[t]`` sweeps from its seeds V0, and max_i ‖ΔV_i‖² of its
    sweeps number counts[t] and counts[t] − 1."""
    import torch
    out = ([], [], [])
    for s in range(0, X.shape[0], chunk):
        sl = slice(s, s + chunk)
        v = V0[sl].double()
        c = torch.as_tensor(counts[sl], device=X.device)
        snap = v.clone()
        last = torch.zeros(v.shape[0], dtype=torch.float64, device=X.device)
        prev = last.clone()
        for k in range(1, int(c.max()) + 1):
            v_new = sweep64(X[sl], W[sl], v, m[sl])[0]
            dv2 = ((v_new - v) ** 2).sum(-1).amax(-1)
            v = v_new
            snap = torch.where((c == k)[:, None, None], v, snap)
            last = torch.where(c == k, dv2, last)
            prev = torch.where(c == k + 1, dv2, prev)
        for o, a in zip(out, (snap, last, prev)):
            o.append(a)
    return [torch.cat(o) for o in out]


def exact_sweep(X, W, V, m, chunk=8192):
    """`sweep64` over all tenants, a chunk at a time."""
    import torch
    parts = [sweep64(X[s:s + chunk], W[s:s + chunk], V[s:s + chunk],
                     m[s:s + chunk]) for s in range(0, X.shape[0], chunk)]
    return [torch.cat(p) for p in zip(*parts)]


def objective64(X, W, V, m):
    """Each tenant's float64 objective at centers V."""
    return exact_sweep(X, W, V, m)[1]


def q_bound(X, W, V):
    """How far two f32 evaluations of a tenant's q through the d²
    expansion may part: each within 2·γ_{d+2}·Σ_k w_k (‖x_k‖² +
    max_i ‖v_i‖²) of the exact value."""
    gamma = (X.shape[2] + 2) * 2.0 ** -24
    x2 = (X.double() ** 2).sum(-1)
    v2 = (V.double() ** 2).sum(-1).max(-1).values[:, None]
    return 4 * gamma * (W.double() * (x2 + v2)).sum(1)


def exactness(fit, X, W, V0, m):
    """How far fit's tenants lie from the exact trajectory at their own
    sweep counts: per tenant, the excess of |v − v_exact| over
    1e-4 + 1e-4·|v_exact| (≤ 0 passes, as `np.allclose` at rtol = atol
    = 1e-4, tests/test_tenant.py's center bar), the float64 objective's
    relative gap, and the exact trajectory's ΔV² at the fit's last two
    sweeps."""
    import numpy as np
    import torch
    t = fit.n_tenants
    X, W, V0, m = X[:t], W[:t], V0[:t], m[:t]
    exact, last, prev = exact_trajectory(X, W, V0, m, fit.n_iter)
    v = torch.from_numpy(fit.centers).to(X.device).double()
    excess = ((v - exact).abs() - 1e-4 - 1e-4 * exact.abs()).amax((1, 2))
    ja, je = objective64(X, W, v, m), objective64(X, W, exact, m)
    rel = (ja - je).abs() / je.abs().clamp_min(1e-12)
    return (excess.cpu().numpy(), rel.cpu().numpy().astype(np.float64),
            last.cpu().numpy(), prev.cpu().numpy())


def hold_tenant_fits(a, b, X, W, V0, m, fixed, allowed_gap, obj_rtol,
                     what) -> dict:
    """Fit ``a`` (through a kernel) against fit ``b`` (the plain ``torch``
    backend) and against the exact float64 trajectory, tenant by tenant.

    Held on the tenants ``fixed`` at f32 precision (`fixed_at_f32`):
    ``a`` lies on the exact trajectory at its own sweep count within
    tests/test_tenant.py's bars (centers 1e-4, float64 objective
    ``obj_rtol`` relative); its sweep count is within ``allowed_gap`` of
    ``b``'s; where the counts are equal, the f32 q each reports is within
    the expansion's rounding bound (`q_bound`) plus 1e-5 relative.  The
    direct comparison with ``b`` (centers, objective) is printed, not
    held: where the sweeps amplify rounding (few records, far from
    convergence) or ε is crossed slowly, two f32 fits part by more than
    those bars while both follow the exact trajectory (PERF.md, section 6)."""
    import numpy as np
    import torch
    t = a.n_tenants
    fixed, allowed_gap = fixed[:t], allowed_gap[:t]
    exc, rel, _, _ = exactness(a, X, W, V0, m)
    gap = np.abs(a.n_iter.astype(np.int64) - b.n_iter)
    same = (gap == 0) & fixed
    va, vb = (torch.from_numpy(s.centers).to(X.device) for s in (a, b))
    ja = objective64(X[:t], W[:t], va, m[:t])
    jb = objective64(X[:t], W[:t], vb, m[:t])
    rel_ab = ((ja - jb).abs() / jb.abs().clamp_min(1e-12)).cpu().numpy()
    qdiff = np.abs(a.objective.astype(np.float64) - b.objective)
    qlim = (1e-5 * np.abs(b.objective)
            + q_bound(X[:t], W[:t], vb).cpu().numpy())
    cab = np.abs(a.centers - b.centers).max(axis=(1, 2))
    rec = {"tenants": t, "fixed_at_f32": int(fixed.sum()),
           "n_iter_differ": int((gap > 0).sum()),
           "n_iter_differ_by_2_or_more": int((gap > 1).sum()),
           "max_n_iter_gap_fixed": int(gap[fixed].max(initial=0)),
           "max_n_iter_gap_not_fixed": int(gap[~fixed].max(initial=0)),
           "gap_over_allowed_fixed": int((gap > allowed_gap)[fixed].sum()),
           "vs_exact_center_excess_max_fixed": float(
               exc[fixed].max(initial=-1)),
           "vs_exact_obj64_rel_max_fixed": float(rel[fixed].max(initial=0)),
           "vs_exact_failing_not_fixed": int(
               ((exc > 0) | (rel > obj_rtol))[~fixed].sum()),
           "vs_b_center_err_max_equal_iters": float(
               cab[gap == 0].max(initial=0)),
           "vs_b_obj64_rel_max_equal_iters": float(
               rel_ab[gap == 0].max(initial=0)),
           "vs_b_obj64_rel_max": float(rel_ab.max()),
           "vs_b_q_rel_max": float((qdiff / np.abs(b.objective)).max()),
           "vs_b_q_over_bound_max_fixed_equal_iters": float(
               (qdiff / qlim)[same].max(initial=0))}
    if (2 * fixed.sum() < t or rec["gap_over_allowed_fixed"]
            or rec["vs_exact_center_excess_max_fixed"] > 0
            or rec["vs_exact_obj64_rel_max_fixed"] > obj_rtol
            or rec["vs_b_q_over_bound_max_fixed_equal_iters"] > 1):
        raise AssertionError(f"{what}: {rec}")
    return rec


def fixed_at_f32(ref, nudged, X, W, V0, m, obj_rtol):
    """(fixed, allowed_gap) per tenant, from the plain ``torch`` backend's
    fit ``ref``.  A tenant is fixed at f32 precision where ``ref`` lies
    on the exact float64 trajectory within tests/test_tenant.py's bars
    (`exactness`) and its fits of the records scaled by 1 ± 2⁻²²
    (``nudged``) stop at the same sweep with centers within 1e-4.

    ``allowed_gap`` is how far another f32 fit's stop may lie from
    ``ref``'s: a rounding error of less than a factor 2 in ΔV² moves the
    crossing of ε by at most ⌈ln 2 / ln(1/ρ²)⌉ sweeps, where ρ² is the
    exact trajectory's ΔV² ratio over ``ref``'s last sweep (at least 1;
    unbounded where ΔV² does not fall there)."""
    import numpy as np
    exc, rel, last, prev = exactness(ref, X, W, V0, m)
    fixed = (exc <= 0) & (rel <= obj_rtol)
    for n in nudged:
        fixed &= n.n_iter == ref.n_iter
        fixed &= np.all(np.abs(n.centers - ref.centers)
                        <= 1e-4 + 1e-4 * np.abs(ref.centers), axis=(1, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        rho2 = np.where(prev > 0, last / prev, 0.0)
        allowed = np.where(rho2 < 1, np.ceil(np.log(2) / -np.log(rho2)),
                           np.inf)
    return fixed, np.maximum(allowed, 1)


def check_scorer(ts, run: TenantRun, seed: int, device) -> dict:
    """A burst of 4 rows per tenant through `TenantScorer` on the card,
    hard and soft, against the same scorer on the CPU: equal
    assignments (a differing row must be a tie within f32 rounding),
    soft memberships within rtol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.serve import TenantScorer
    rng = np.random.default_rng(seed + 1)
    tidx = np.repeat(np.arange(ts.n_tenants), 4)
    x = (rng.normal(size=(tidx.size, TENANT_D))
         + 4.0 * (tidx % 5)[:, None]).astype(np.float32)
    rec = {"rows": int(tidx.size)}
    for soft in (False, True):
        t0 = time.perf_counter()
        gpu = TenantScorer(ts, soft=soft, device=device).score(x, tidx)
        torch.cuda.synchronize(device)
        rec[f"{'soft' if soft else 'hard'}_s"] = time.perf_counter() - t0
        cpu = TenantScorer(ts, soft=soft, device="cpu").score(x, tidx)
        gpu = gpu.cpu()
        if soft:
            rec["soft_max_abs_err"] = max_err([gpu], [cpu], 1e-5, 0.0,
                                              f"soft scorer at {run.name}")
            continue
        bad = np.flatnonzero((gpu != cpu).numpy())
        d2 = ((x[bad, None, :] - ts.centers[tidx[bad]]) ** 2).sum(-1)
        rows = np.arange(bad.size)
        ga, ca = d2[rows, gpu.numpy()[bad]], d2[rows, cpu.numpy()[bad]]
        if np.any(np.abs(ga - ca) > 1e-6 * np.maximum(ga, ca)):
            raise AssertionError(f"hard scorer at {run.name}: {bad.size} "
                                 "rows differ beyond a tie")
        rec["hard_ties_differing"] = int(bad.size)
    return rec


def run_tenant_path(run: TenantRun, seed: int, device, reps: int):
    """Phase 4 for one cohort: `fit_tenants` on ``hopper`` with the K3 launch
    count zeroed just before it and read just after; the same fit on the
    ``torch`` backend, held tenant by tenant; the looped fit of 16
    tenants (``tenants_t16``); the scorer; and K3 against its plain
    version at the cohort's packed shape, timed.  Returns (phase record,
    kernel entry)."""
    import numpy as np
    import torch
    from repro_torch.device import synchronize
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import (fcm_sweep_batched_cuda,
                                                fcm_sweep_batched_ref,
                                                launch_plan, reset_counts)
    from repro_torch.tenant import (TenantFitConfig, fit_tenants,
                                    fit_tenants_looped, pack_tenants,
                                    seed_centers)
    from repro_torch.tenant.fit import _per_tenant_m

    t0 = time.perf_counter()
    data, m_t = tenant_cohort(run, seed)
    setup_s = time.perf_counter() - t0
    cfg = TenantFitConfig(n_clusters=TENANT_C, eps=run.eps,
                          max_iter=run.max_iter, seed=seed,
                          row_base=run.row_base, backend="hopper")
    backend = cfg.backend

    # -- the main path, with the K3 launch count zeroed just before it
    reset_counts()
    synchronize(device)
    t0 = time.perf_counter()
    ts = fit_tenants(data, cfg, m_t=m_t, device=device)
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = fcm_sweep_batched_cuda.launches
    by_shape = shape_counts(fcm_sweep_batched_cuda)
    if launches == 0:
        raise AssertionError(f"K3 was not launched at {run.name}")
    check_paths(run.name, fcm_sweep_batched_cuda)
    if not (np.isfinite(ts.centers).all() and np.isfinite(ts.objective).all()
            and ts.centers.shape == (run.tenants, TENANT_C, TENANT_D)):
        raise AssertionError(f"{run.name}: non-finite or mis-shaped fit")

    # -- the host's share of the fit: packing and seeding alone
    t0 = time.perf_counter()
    X, W = pack_tenants(data, cfg)
    seeds = seed_centers(data, cfg)
    host_s = time.perf_counter() - t0
    V0 = np.zeros((X.shape[0], TENANT_C, TENANT_D), np.float32)
    V0[:run.tenants] = seeds
    m_all = _per_tenant_m(cfg, m_t, X.shape[0], run.tenants)
    X, W, V0, m_dev = (torch.from_numpy(a).to(device)
                       for a in (X, W, V0, m_all))
    record = {"phase": "tenant_path", "run": run.name,
              "tenants": run.tenants, "bucket": list(X.shape),
              "c": TENANT_C, "m": list(run.m) or 2.0, "eps": run.eps,
              "max_iter": run.max_iter, "backend": backend,
              "setup_s": setup_s, "wall_s": wall, "host_pack_seed_s": host_s,
              "batched_sweeps": launches, "launches_by_shape": by_shape,
              "n_iter_max": int(ts.n_iter.max()),
              "n_iter_mean": float(ts.n_iter.mean()),
              "at_max_iter": int((ts.n_iter == run.max_iter).sum())}

    # -- the same fit through the torch backend, same seeds, and with
    #    the records scaled by 1 ± 2⁻²² to find the tenants it fixes
    torch_cfg = dataclasses.replace(cfg, backend="torch")
    t0 = time.perf_counter()
    tor = fit_tenants(data, torch_cfg, m_t=m_t, device=device)
    synchronize(device)
    record["torch_wall_s"] = time.perf_counter() - t0
    fixed, allowed = fixed_at_f32(tor, [
        fit_tenants([x * np.float32(1 + sign * 2.0 ** -22) for x in data],
                    torch_cfg, m_t=m_t, device=device) for sign in (1, -1)],
        X, W, V0, m_dev, run.obj_rtol)
    record["vs_torch"] = hold_tenant_fits(
        ts, tor, X, W, V0, m_dev, fixed, allowed, run.obj_rtol,
        f"hopper vs torch at {run.name}")
    if run.name == "tenants_t16":
        looped = fit_tenants_looped(
            data[:16], cfg, m_t=None if m_t is None else m_t[:16],
            device=device)
        record["looped_vs_batched"] = hold_tenant_fits(
            looped, ts.select(ts.ids[:16]), X, W, V0, m_dev, fixed,
            allowed, run.obj_rtol, f"looped vs batched at {run.name}")
    if run.name == "tenants_65k":
        record["service"] = run_tenant_service(ts, tor, seed, device)
    del tor
    record["scorer"] = check_scorer(ts, run, seed, device)

    # -- K3 against its plain version at the packed shape, at the seeds
    #    (the fit's first launch) and at the fitted centers (its last).
    #    v_new, and q to its rounding bound, are held at the sweep
    #    tolerances.  Off the origin the d² expansion that K3 shares with
    #    the TPU kernel and the torch backend rounds by up to
    #    2·γ_{d+2}·(‖x‖² + ‖v‖²), which moves the memberships of records
    #    near a center, and so w_i, by more than rtol 3e-4 (the blobs
    #    here sit up to 16 from the origin).  So every output is also held
    #    no farther from the exact float64 sweep than twice the torch
    #    backend's own distance from it on the same inputs.
    V = torch.zeros((X.shape[0], TENANT_C, TENANT_D), device=device)
    V[:run.tenants] = torch.from_numpy(ts.centers).to(device)
    torch_be = get_backend("torch")
    held = {}
    for label, centers in (("seeds", V0), ("fitted", V)):
        got = fcm_sweep_batched_cuda(X, W, centers, m_dev)
        if not all(torch.equal(a, b) for a, b in zip(
                got, fcm_sweep_batched_cuda(X, W, centers, m_dev))):
            raise AssertionError(f"two K3 launches differ at {run.name}")
        want = fcm_sweep_batched_ref(X, W, centers, m_dev)
        what = f"fcm_sweep_batched at {run.name}, {label} centers"
        held[label] = max_err(
            (got[0], got[2]), (want[0], want[2]), RTOL,
            (SWEEP_ATOL, SWEEP_ATOL + q_bound(X, W, centers).float()), what)
        held[label + "_w_i_vs_plain"] = float((got[1] - want[1]).abs().max())
        del want
        v64, q64, w64 = exact_sweep(X, W, centers, m_dev)
        tor = torch_be.batched_sweep(X, W, centers, m_dev)
        for name, k3, tb, ex in zip(("v_new", "w_i", "q"), got, tor,
                                    (v64, w64, q64)):
            ek = float((k3.double() - ex).abs().max())
            et = float((tb.double() - ex).abs().max())
            held[f"{label}_{name}_vs_exact"] = [ek, et]
            if ek > 2 * et + SWEEP_ATOL:
                raise AssertionError(f"{what}: {name} {ek:.3e} from the "
                                     f"exact sweep, torch backend {et:.3e}")
        del got, tor, v64, q64, w64
    record["k3_vs_plain"] = held
    emit(record)
    err = max(held["seeds"], held["fitted"])
    tb, n, d = X.shape
    n_rep = reps if tb * n > 1 << 20 else 500
    ms = time_loop_ms(lambda: fcm_sweep_batched_cuda(X, W, V, m_dev), n_rep)
    per_call = time_ms(lambda: fcm_sweep_batched_cuda(X, W, V, m_dev), n_rep)
    plain_ms = time_ms(lambda: fcm_sweep_batched_ref(X, W, V, m_dev), 3)
    torch.cuda.empty_cache()
    b_ms, b_by = bound_batched(tb, n, d, TENANT_C)
    return {"name": "fcm_sweep_batched", "run": run.name,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "ms_per_call": per_call, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "shape": [tb, n, d, TENANT_C],
            "path": launch_plan(device, n, d, TENANT_C, tb).path}


# The store phase: 1,048,576-row chunks (117 MB at d = 28, 172 MB at
# d = 41, near Hadoop 2's 128 MB block), one batch per chunk; peak device
# memory of a store fit held to PEAK_BATCHES batches of x and w.
STORE_CHUNK_ROWS = 1 << 20
STORE_SHARDS = 4
PEAK_BATCHES = 4


def pinned_h2d_bytes_per_s(rows: int, cols: int, device, reps: int = 9):
    """Host→device rate of one plain pinned copy of a (rows, cols) f32
    batch: the median of ``reps`` copies, each between CUDA events."""
    import torch
    host = torch.ones((rows, cols), dtype=torch.float32).pin_memory()
    dev = torch.empty((rows, cols), dtype=torch.float32, device=device)
    times = []
    for _ in range(reps + 1):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        dev.copy_(host, non_blocking=True)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 1e3)
    return host.numel() * 4 / sorted(times[1:])[reps // 2]


def timed_store_pass(store, centers, m, device):
    """One out-of-core pass (`ooc_accumulate` through ``hopper_accumulate``)
    at ``centers``, through its own `StagingRing` with copy timing on:
    (accumulators, where the pass's time went)."""
    import torch
    from repro_torch.core import StagingRing, ooc_accumulate
    from repro_torch.data import batched
    ring = StagingRing(device, timing=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = ooc_accumulate(batched(store.iter_chunks(), store.chunk_rows),
                         centers, m, backend="hopper_accumulate", ring=ring,
                         device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return out, {"wall_s": wall, "batches": ring.batches,
                 "host_batch_iter_s": ring.iter_s,
                 "host_read_stage_s": ring.host_s, "slot_wait_s": ring.wait_s,
                 "h2d_s": ring.h2d_seconds(), "h2d_bytes": ring.h2d_bytes}


def fit_iters(fit) -> tuple:
    """(combiner sweeps summed over shards, reducer sweeps) of a fit."""
    return (sum(fit.diagnostics.combiner_iters), fit.diagnostics.reducer_iters)


def hold_fit(a, b, scale, what) -> dict:
    """The main path's bars for two fits, each (centers, global q, sweep
    counts): centers within 1e-3 of the data's RMS, q within 1e-4
    relative, combiner and reducer sweep counts within ±2 (summation
    order differs, and ε bounds only ΔV²)."""
    (va, qa, ia), (vb, qb, ib) = a, b
    rec = {"center_err_rel_rms": float((va.cpu() - vb.cpu()).abs().max())
           / scale, "q_rel": abs(qa - qb) / abs(qb), "iters": [ia, ib]}
    if rec["center_err_rel_rms"] > 1e-3 or rec["q_rel"] > 1e-4 or any(
            abs(u - v) > 2 for u, v in zip(ia, ib)):
        raise AssertionError(f"{what}: {rec}")
    return rec


def run_store_path(run: Run, held: dict, store_dir: Path, device) -> dict:
    """Phase 5 for one dataset: the array the main path fit, ingested into
    an on-disk `ChunkStore` under ``store_dir``; `bigfcm_fit_store` on
    backend ``hopper`` with launch counts zeroed just before it and read just
    after, and its peak device memory; the store fits from the main
    path's injected draws through ``hopper`` and ``torch``, held against
    the in-memory fit and each other; where a pass's time goes; one pass
    against one K1 launch over the whole array; K1 at the batch shape
    (and the padded tail batch) against its plain version, timed; and at
    ``kdd99_like`` `store_extras`.  Returns K1's kernel entry at the
    batch shape."""
    import numpy as np
    import torch
    from repro_torch.core import bigfcm_fit_store
    from repro_torch.data import ChunkStore, batched
    from repro_torch.engine import get_backend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, launch_plan,
                                                reset_counts)

    from repro_torch import obs
    x_np, cfg = held["x"], held["cfg"]
    n, d = x_np.shape
    rows = STORE_CHUNK_ROWS
    batch_bytes = 4 * rows * (d + 1)
    free = shutil.disk_usage(store_dir).free
    if free < x_np.nbytes + (256 << 20):
        raise AssertionError(f"{run.name}: {free} bytes free under "
                             f"{store_dir}, the store needs {x_np.nbytes}")
    t0 = time.perf_counter()
    store = ChunkStore.ingest(x_np, chunk_rows=rows,
                              cache_dir=str(store_dir / run.name))
    setup_s = time.perf_counter() - t0
    per_pass = -(-n // rows)
    if store.n_rows != n or store.n_chunks != per_pass:
        raise AssertionError(f"{run.name}: store {store!r}")

    # -- the store path, the main path's config, launch counts (and the
    #    obs registry) zeroed just before it and peak device memory
    #    measured over it
    obs.reset_all()
    reset_counts()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = bigfcm_fit_store(store, cfg, device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"store path {run.name}: a kernel was not "
                             f"launched: {launches}")
    check_paths(run.name, fcm_sweep_cuda, fcm_accumulate_cuda)
    k1_batch = fcm_accumulate_cuda.shapes[EXPECTED_PATH[run.name], rows,
                                          run.c]
    if k1_batch == 0 or k1_batch % per_pass:
        raise AssertionError(f"store path {run.name}: {k1_batch} K1 launches "
                             f"at {rows} rows, {per_pass} batches a pass")
    if res.centers.shape != (run.c, d) or not bool(
            torch.isfinite(res.centers).all()):
        raise AssertionError(f"store path {run.name}: bad centers")
    if peak > PEAK_BATCHES * batch_bytes:
        raise AssertionError(f"store path {run.name}: peak device memory "
                             f"{peak} B > {PEAK_BATCHES} batches "
                             f"({PEAK_BATCHES * batch_bytes} B)")
    diag = res.diagnostics
    record = {"phase": "store_path", "run": run.name, "n": n, "d": d,
              "c": run.c, "m": run.m, "chunk_rows": rows,
              "chunks": store.n_chunks, "batches_per_pass": per_pass,
              "store_bytes": store.nbytes, "setup_s": setup_s,
              "wall_s": wall, "flag": diag.flag,
              "passes": k1_batch // per_pass,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "launches": launches,
              "launches_by_shape": {
                  "fcm_sweep": shape_counts(fcm_sweep_cuda),
                  "fcm_accumulate": shape_counts(fcm_accumulate_cuda)},
              "peak_device_bytes": peak, "batch_bytes": batch_bytes,
              "peak_bound_bytes": PEAK_BATCHES * batch_bytes}
    if run.name == "kdd99_like":
        record["obs"] = store_obs(store, cfg, k1_batch // per_pass, per_pass)

    # -- the store fit from the main path's injected draws, through
    #    hopper and torch
    inject = dataclasses.replace(cfg, use_driver=False)
    fits = {name: bigfcm_fit_store(
                store, dataclasses.replace(inject, backend=name),
                sample_idx=held["sample_idx"], seed_idx=held["seed_idx"],
                device=device) for name in ("hopper", "torch")}

    # -- where a pass's time goes: two passes at the fitted centers (the
    #    second timed), a pinned copy's rate, K1 at the batch shape
    one, _ = timed_store_pass(store, res.centers, run.m, device)
    again, split = timed_store_pass(store, res.centers, run.m, device)
    if not all(torch.equal(a, b) for a, b in zip(one, again)):
        raise AssertionError(f"{run.name}: two store passes differ")
    rate = pinned_h2d_bytes_per_s(rows, d + 1, device)
    xb = torch.from_numpy(np.array(store.chunk(0))).to(device)
    wb = torch.ones((rows,), dtype=torch.float32, device=device)
    for tail in batched(store.iter_chunks(), rows):
        pass
    tx, tw = (torch.from_numpy(np.array(a)).to(device) for a in tail)
    k1_ms = time_loop_ms(lambda: fcm_accumulate_cuda(xb, wb, res.centers,
                                                     run.m), 20)
    split.update({"pinned_h2d_bytes_per_s": rate,
                  "h2d_bound_s": split["h2d_bytes"] / rate,
                  "k1_card_s": k1_ms * per_pass / 1e3})
    record["per_pass"] = split

    # -- the gates that need the whole array on the card
    xd = torch.from_numpy(x_np).to(device)
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    scale = float(torch.sqrt(torch.mean(xd * xd)))
    acc = get_backend("hopper_accumulate").accumulate
    qs = {k: float(acc(xd, ones, f.centers, run.m)[2])
          for k, f in fits.items()}
    ours = {k: (f.centers, qs[k], fit_iters(f)) for k, f in fits.items()}
    record["vs_memory"] = hold_fit(
        ours["hopper"], (held["centers"]["hopper"], held["q"]["hopper"],
                         held["iters"]["hopper"]), scale,
        f"store vs in-memory fit at {run.name}")
    record["vs_torch"] = hold_fit(ours["hopper"], ours["torch"], scale,
                                  f"store fit hopper vs torch at {run.name}")
    # what the fleet phase holds its objective against
    held["store_q"], held["scale"] = qs["hopper"], scale
    # One pass sums 11 or 5 launches' accumulators where one launch sums
    # its CTAs' partials: f32 summation order, 1e-5 of each output's scale
    # (v_num's: max w_i times the data's RMS).
    whole = fcm_accumulate_cuda(xd, ones, res.centers, run.m)
    w_max = float(whole[1].max())
    record["pass_vs_one_launch"] = max_err(
        one, whole, 1e-5, (1e-5 * w_max * scale, 1e-5 * w_max, 0.0),
        f"one store pass vs one K1 launch at {run.name}")
    err = 0.0
    for label, (bx, bw) in (("batch", (xb, wb)), ("tail", (tx, tw))):
        err = max(err, max_err(
            fcm_accumulate_cuda(bx, bw, res.centers, run.m),
            fcm_accumulate_ref(bx, bw, res.centers, run.m), RTOL, ACC_ATOL,
            f"K1 at the {label} batch of {run.name}"))
    plain_ms = time_ms(lambda: fcm_accumulate_ref(xb, wb, res.centers,
                                                  run.m), 3)
    per_call = time_ms(lambda: fcm_accumulate_cuda(xb, wb, res.centers,
                                                   run.m), 20)
    del tx, tw, whole
    if run.name == "kdd99_like":
        record.update(store_extras(run, store, x_np, xd, held, qs["hopper"],
                                   fits["hopper"].centers, scale, device))
    emit(record)
    b_ms, b_by = bound(rows, d, run.c)
    return {"name": "fcm_accumulate", "run": f"{run.name}/store_batch",
            "launches": k1_batch, "max_abs_err": err, "ms": k1_ms,
            "ms_per_call": per_call, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "shape": [rows, d, run.c],
            "path": launch_plan(device, rows, d, run.c).path}


def store_obs(store, cfg, passes, per_pass) -> dict:
    """The obs record of one store fit (the registry reset just before
    it): its phase breakdown and counters, ``data.cache.chunk_reads``
    held to what the fit reads — the chunks the driver's sample touches
    (`ChunkStore.take`) and each pass's batches."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.bigfcm import _draws
    _, sample_idx, _ = _draws(cfg, store.n_rows, None, None)
    sample_chunks = np.unique(np.searchsorted(
        store.offsets, sample_idx, side="right") - 1).size
    counters = obs.metrics_snapshot()["counters"]
    want = sample_chunks + passes * per_pass
    if counters.get("data.cache.chunk_reads") != want:
        raise AssertionError(f"store fit: {counters} for {sample_chunks} "
                             f"sample chunks + {passes} passes x "
                             f"{per_pass} batches")
    return {"phase_breakdown": obs.phase_breakdown(), "counters": counters,
            "sample_chunk_reads": int(sample_chunks), "passes": passes,
            "batches_per_pass": per_pass}


def soft_exact_gap(u, x, v, m, chunk=1 << 18) -> float:
    """max |u − u_exact|: ``u`` (N, C) memberships of ``x`` against ``v``,
    the exact ones in float64 with the direct ‖x − v‖², a chunk of rows
    at a time."""
    import torch
    worst = 0.0
    v64 = v.double()
    for s in range(0, x.shape[0], chunk):
        d2 = ((x[s:s + chunk, None, :].double() - v64[None]) ** 2).sum(-1)
        lg = d2.clamp_min(1e-12).log()
        r = torch.exp(-(lg - lg.min(-1, keepdim=True).values) / (m - 1.0))
        exact = r / r.sum(-1, keepdim=True)
        worst = max(worst, float((u[s:s + chunk].to(x.device).double()
                                  - exact).abs().max()))
    return worst


def hold_wfcmpb_store(run: Run, store, centers, cfg, scale, device) -> dict:
    """`wfcmpb_store` over shard 0 of a 4-shard plan (its chunks are the
    blocks), from ``centers``.  Through ``hopper`` it must equal the
    in-memory `wfcmpb` of the same rows with one block per chunk (the same
    blocks, the tail padded alike: equal sweeps, centers within 1e-6 of
    the data's RMS, q within 1e-5).  Against the ``torch`` backend it is
    held to the main path's bars only where the ``torch`` progression is
    fixed by its data at f32 precision — its centers move by at most 1e-4
    of the RMS when the records are scaled by 1 + 2⁻²² (`check_driver`'s
    rule); otherwise the gap is printed, not held."""
    import numpy as np
    import torch
    from repro_torch.core import wfcmpb, wfcmpb_batches, wfcmpb_store
    from repro_torch.data import plan_partitions, shard_batches
    rows = store.chunk_rows
    plan = plan_partitions(store, STORE_SHARDS)
    kw = dict(m=run.m, eps=cfg.combiner_eps, max_iter=cfg.max_iter,
              device=device)
    fits = {name: wfcmpb_store(store, centers, backend=name, plan=plan,
                               shard=0, **kw) for name in ("hopper", "torch")}
    nudge = float(1 + 2.0 ** -22)
    fits["torch_nudged"] = wfcmpb_batches(
        lambda: ((bx * nudge, bw)
                 for bx, bw in shard_batches(store, plan, 0, rows)),
        centers, backend="torch", **kw)
    x0 = torch.cat([torch.from_numpy(np.array(store.chunk(i))).to(device)
                    for i in plan.chunks_of(0)])
    mem = wfcmpb(x0, centers, block_size=rows, backend="hopper", **kw)
    del x0

    def gap(a, b):
        return float((a.centers - b.centers).abs().max()) / scale

    def q_rel(a, b):
        return abs(float(a.objective) - float(b.objective)) / abs(
            float(b.objective))

    hop, tor = fits["hopper"], fits["torch"]
    blocks = len(plan.chunks_of(0))
    rec = {"blocks": blocks,
           "vs_memory": {"center_err_rel_rms": gap(hop, mem),
                         "q_rel": q_rel(hop, mem),
                         "iters": [hop.n_iter, mem.n_iter]},
           "vs_torch": {"center_err_rel_rms": gap(hop, tor),
                        "q_rel": q_rel(hop, tor),
                        "iters": [hop.n_iter, tor.n_iter],
                        "torch_nudged_rel_rms": gap(fits["torch_nudged"],
                                                    tor)}}
    rec["vs_torch"]["held"] = rec["vs_torch"]["torch_nudged_rel_rms"] <= 1e-4
    vm, vt = rec["vs_memory"], rec["vs_torch"]
    if (hop.n_iter != mem.n_iter or vm["center_err_rel_rms"] > 1e-6
            or vm["q_rel"] > 1e-5 or not bool(torch.isfinite(
                hop.centers).all())):
        raise AssertionError(f"wfcmpb_store vs in-memory wfcmpb: {rec}")
    if vt["held"] and (vt["center_err_rel_rms"] > 1e-3 or vt["q_rel"] > 1e-4
                       or abs(hop.n_iter - tor.n_iter) > 2 * blocks):
        raise AssertionError(f"wfcmpb_store hopper vs torch: {rec}")
    return rec


def store_extras(run: Run, store, x_np, xd, held, q_one, centers, scale,
                 device) -> dict:
    """``kdd99_like`` only: the multi-shard store fit (global q within
    tests/test_plane.py's 5 % of the one-shard fit's ``q_one``, its
    returned objective the global one), `hold_wfcmpb_store`, the MR-FKM
    baseline over the store against the in-memory
    baseline from the same seeds (equal jobs, both converged, centers
    within 1e-4 of the data's RMS), and `assign_store` against scoring
    the whole array at once (hard labels equal but for ties within f32
    rounding; soft memberships no farther from the exact float64 ones
    than twice the whole-array scoring's distance, plus 1e-6)."""
    import numpy as np
    import torch
    from repro_torch.baselines import mr_fuzzy_kmeans, mr_fuzzy_kmeans_store
    from repro_torch.core import bigfcm_fit_store
    from repro_torch.engine import get_backend
    from repro_torch.serve import assign_store, make_assigner
    cfg = dataclasses.replace(held["cfg"], use_driver=False)
    ones = torch.ones((xd.shape[0],), dtype=torch.float32, device=device)
    out = {}

    t0 = time.perf_counter()
    multi = bigfcm_fit_store(store, cfg, n_shards=STORE_SHARDS,
                             sample_idx=held["sample_idx"],
                             seed_idx=held["seed_idx"], device=device)
    wall = time.perf_counter() - t0
    q = float(get_backend("hopper_accumulate").accumulate(
        xd, ones, multi.centers, run.m)[2])
    rec = out["multi_shard"] = {
        "shards": STORE_SHARDS, "wall_s": wall,
        "combiner_iters": list(multi.diagnostics.combiner_iters),
        "reducer_iters": multi.diagnostics.reducer_iters, "q": q,
        "objective": float(multi.objective),
        "q_rel_vs_one_shard": abs(q - q_one) / q_one}
    if rec["q_rel_vs_one_shard"] > 0.05 or abs(rec["objective"] - q) > \
            1e-4 * q:
        raise AssertionError(f"multi-shard store fit: {rec}")

    out["wfcmpb_store_shard0"] = hold_wfcmpb_store(run, store, centers,
                                                   cfg, scale, device)

    v0 = x_np[held["sample_idx"][held["seed_idx"]]]
    kw = dict(m=run.m, eps=run.eps, max_iter=cfg.max_iter, backend="hopper",
              device=device)
    ooc, jobs_ooc, t_ooc = mr_fuzzy_kmeans_store(store, v0, **kw)
    mem, jobs_mem, t_mem = mr_fuzzy_kmeans(xd, v0, **kw)
    rec = out["mr_fkm"] = {
        "jobs": [jobs_ooc, jobs_mem], "elapsed_s": [t_ooc, t_mem],
        "center_err_rel_rms": float((ooc.centers - mem.centers).abs().max())
        / scale}
    if jobs_ooc != jobs_mem or jobs_ooc >= cfg.max_iter or \
            rec["center_err_rel_rms"] > 1e-4:
        raise AssertionError(f"mr_fuzzy_kmeans_store vs in memory: {rec}")

    rec = out["assign_store"] = {}
    for soft in (False, True):
        t0 = time.perf_counter()
        got = torch.from_numpy(np.concatenate(list(assign_store(
            store, centers, m=run.m, soft=soft, backend="hopper",
            device=device))))
        rec["soft_s" if soft else "hard_s"] = time.perf_counter() - t0
        want = make_assigner(centers, m=run.m, soft=soft, backend="hopper",
                             device=device)(xd).cpu()
        if soft:
            # Chunk and whole-array GEMMs round the d² expansion's cross
            # term apart (its f32 cancellation; the data lie far from the
            # origin), so both are held to the exact memberships.
            rec["soft_max_abs_err"] = float((got - want).abs().max())
            rec["soft_vs_exact"] = [soft_exact_gap(got, xd, centers, run.m),
                                    soft_exact_gap(want, xd, centers, run.m)]
            if rec["soft_vs_exact"][0] > 2 * rec["soft_vs_exact"][1] + 1e-6:
                raise AssertionError(f"soft assign_store: {rec}")
            continue
        rec["hard_ties_differing"] = label_ties(got.numpy(), want.numpy(),
                                                xd, centers)
    return out


# The fleet phase: benchmarks/t15_fleet.py's protocol (H simulated hosts,
# each fitting its shards of one on-disk store, exchanging summary frames
# and merging them identically, no reducer) at the HIGGS-like store of the
# store phase, on the main path's config (C = 2, m = 2, hopper).
FLEET_RUN = "higgs_like"
FLEET_HOSTS, FLEET_SHARDS = 4, 2        # hosts x shards per host: 8 shards
# per-shard pin budget: two 1,048,576 x 28 chunks, so every shard's chunks
# load on the prefetch thread while the previous shard fits
FLEET_PREFETCH_BYTES = 2 * STORE_CHUNK_ROWS * 28 * 4
FLEET_STRAGGLER_FACTOR = 2.0            # tests/test_fleet.py's straggler
FLEET_DELAY_S = 4000.0                  # a delayed host outsleeps the script


def fleet_frames(transport, live) -> dict:
    """The summary frames the ``live`` hosts posted at epoch 0."""
    return transport.gather(0, live[0], live, "sum", 1.0)


def fleet_shard_seconds() -> dict:
    """Each host's per-shard fit seconds, from the ring's
    ``fleet.shard_fit`` spans: {host: {shard: seconds}}."""
    from repro_torch import obs
    out = {}
    for ev in obs.ring_events():
        if ev.get("kind") == "span" and ev["name"] == "fleet.shard_fit":
            out.setdefault(str(ev["host"]), {})[str(ev["shard"])] = \
                ev["dur_s"]
    return out


def fleet_p50_ms() -> dict:
    """p50 (ms) of the fleet's spans, from the ring's events."""
    from repro_torch import obs
    return {r["phase"]: r["p50_ms"]
            for r in obs.phase_breakdown(obs.ring_events())
            if r["phase"] in ("fleet.local_fit", "fleet.exchange",
                              "fleet.objective", "fleet.shard_fit")}


def hold_fleet_result(res, live, epoch, n, what) -> None:
    import numpy as np
    if res.live != live or res.epoch != epoch or res.n_rows != n or not (
            np.isfinite(res.centers).all() and math.isfinite(res.objective)):
        raise AssertionError(f"{what}: live {res.live}, epoch {res.epoch}, "
                             f"rows {res.n_rows}, objective {res.objective}")


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def sweep_expansion_atol(x, w, v, m) -> tuple:
    """`expansion_atol` carried through K2's normalization v_new = v_num /
    w_i: |v_num/w − (v_num + a)/(w + b)| ≤ (a + |v_num/w|·b) / (w − b)."""
    from repro_torch.kernels.fcm_update import fcm_accumulate_ref
    t_vn, t_w, t_q = expansion_atol(x, w, v, m)
    vn, wi, _ = fcm_accumulate_ref(x, w, v, m)
    v_new = vn / wi.clamp_min(1e-12)[:, None]
    lo = (wi - t_w).clamp_min(1e-12)[:, None]
    return (t_vn + v_new.abs() * t_w[:, None]) / lo, t_w, t_q


def run_fleet_path(run: Run, held: dict, kdd: dict, store_dir: Path,
                   entries: list, device) -> list:
    """The fleet phase over ``run``'s store (phase 5's, still on disk):

    (a) `fleet_fit`, FLEET_HOSTS threads x FLEET_SHARDS shards on the
        card, f32 wire, launch counts and the obs registry zeroed just
        before it: no host lost, K1 launches at the batch shape equal to
        the obs plane's ``engine.sweep`` spans, K2 launches at the merge
        shape equal to the hosts' pairwise merge recomputed over the
        gathered frames, every launch on the plan's path; held against
        the same fleet on the ``torch`` backend (centers 1e-3 of the RMS,
        q 1e-4) and against the 1-shard store fit's global q (1e-5);
    (b) the same fleet with the bf16 wire: every frame element within
        ``BF16_REL_BOUND`` of (a)'s, the objective within 1e-3 of (a)'s;
    (c) a straggler: 3 hosts x 2 shards, host 1 delayed, evicted and its
        shards replanned onto the survivors;
    (d) kill one host: `spawn_fleet` with 3 processes on the card over
        the store's directory, host 1 stopped once hosts 0 and 2 have
        posted their epoch-0 summaries; the survivors agree bit for bit
        with each other and with a threaded fleet born at 2 hosts;
    (e) `mr_kmeans` on the KDD99-like array from its main path's seeds.

    Seeds are `driver_seeds` at the main path's injected draws.  Returns
    the kernel entries of shapes no earlier entry has; the fleet's
    launches at an earlier entry's shape are added to that entry."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.baselines import mr_kmeans
    from repro_torch.core import driver_seeds
    from repro_torch.data import ChunkStore, plan_partitions, replan
    from repro_torch.engine import (MergePlan, Summary, concat,
                                    merge_summaries)
    from repro_torch.fleet import (BF16_REL_BOUND, FleetConfig,
                                   MailboxTransport, collect_results,
                                   decode_summary, fleet_fit, spawn_fleet,
                                   watch_fleet)
    from repro_torch.fleet.proc import MAIL_DIR
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda, reset_counts)

    cfg = held["cfg"]
    store_path = store_dir / run.name
    store = ChunkStore.open(str(store_path))
    n, d, rows = store.n_rows, store.dim, store.chunk_rows
    path = EXPECTED_PATH[run.name]
    v_init = driver_seeds(store, cfg, sample_idx=held["sample_idx"],
                          seed_idx=held["seed_idx"], device=device)
    # The main path drew from default_rng(seed) as `driver_seeds` does, so
    # a host given only the config (a spawned one) derives these seeds.
    if not np.array_equal(driver_seeds(store, cfg, device=device), v_init):
        raise AssertionError("fleet: default seeds differ from the main "
                             "path's injected draws")
    fleet = FleetConfig(n_hosts=FLEET_HOSTS, shards_per_host=FLEET_SHARDS,
                        prefetch_bytes=FLEET_PREFETCH_BYTES)
    rec = {"phase": "fleet", "run": run.name, "n": n, "d": d, "c": run.c,
           "m": run.m, "chunks": store.n_chunks, "chunk_rows": rows,
           "backend": cfg.backend, "reduced": []}

    # -- (a): the main path of this phase, counts and obs zeroed before it
    obs.reset_all()
    obs.set_ring_size(1 << 16)
    reset_counts()
    tr = MailboxTransport()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = fleet_fit(store, cfg, fleet, transport=tr, v_init=v_init,
                    device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    k1 = dict(fcm_accumulate_cuda.shapes)
    k2 = dict(fcm_sweep_cuda.shapes)
    by_shape = {"fcm_sweep": k2, "fcm_accumulate": k1}
    sweeps = obs.metrics_snapshot()["histograms"]["span.engine.sweep"][
        "count"]
    counters = obs.metrics_snapshot()["counters"]
    shard_s, p50 = fleet_shard_seconds(), fleet_p50_ms()
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    hold_fleet_result(res, tuple(range(FLEET_HOSTS)), 0, n, "fleet (a)")
    check_paths(run.name, fcm_sweep_cuda, fcm_accumulate_cuda)
    batch_key = (path, rows, run.c)
    if set(k1) != {batch_key} or k1[batch_key] != sweeps:
        raise AssertionError(f"fleet (a): K1 launches {k1}, {sweeps} "
                             "engine.sweep spans")
    frames = fleet_frames(tr, res.live)
    gathered = concat([decode_summary(frames[h])[0] for h in sorted(frames)])
    gathered = Summary(gathered.centers.to(device),
                       gathered.masses.to(device))
    with uncounted():
        again = merge_summaries(gathered, MergePlan(
            "pairwise", m=cfg.m, eps=cfg.reducer_eps,
            max_iter=cfg.max_iter), backend=cfg.backend)
    if not np.array_equal(again.summary.centers.cpu().numpy(), res.centers):
        raise AssertionError("fleet (a): the merge recomputed over the "
                             "gathered frames differs from the fleet's")
    merge_key = (path, 2 * run.c, run.c)
    slots = gathered.centers.shape[0]
    want_k2 = FLEET_HOSTS * (again.n_iter + slots - 1)
    if set(k2) != {merge_key} or k2[merge_key] != want_k2:
        raise AssertionError(f"fleet (a): K2 launches {k2}, expected "
                             f"{want_k2} at {merge_key}")
    rec["a_threads"] = {"hosts": FLEET_HOSTS, "shards_per_host": FLEET_SHARDS,
                "wall_s": wall, "objective": res.objective,
                "shard_seconds": shard_s, "p50_ms": p50,
                "merge_sweeps_per_host": again.n_iter + slots - 1,
                "exchange_bytes": sum(map(len, frames.values())),
                "obs_exchange_bytes": counters.get(
                    "fleet.exchange.bytes{wire=f32}"),
                "prefetch_bytes": counters.get("fleet.prefetch.bytes", 0),
                "peak_device_bytes": peak,
                "launches": {"fcm_sweep": fcm_sweep_cuda.launches,
                             "fcm_accumulate": fcm_accumulate_cuda.launches},
                "launches_by_shape": {
                    "fcm_sweep": shape_counts(fcm_sweep_cuda),
                    "fcm_accumulate": shape_counts(fcm_accumulate_cuda)}}
    if not rec["a_threads"]["prefetch_bytes"]:
        raise AssertionError("fleet (a): no shard was prefetched")

    # the same fleet on the torch backend, and the 1-shard store fit
    twin = fleet_fit(store, dataclasses.replace(cfg, backend="torch"), fleet,
                     v_init=v_init, device=device)
    hold_fleet_result(twin, res.live, 0, n, "fleet (a) on torch")
    rec["a_threads"]["vs_torch"] = {
        "center_err_rel_rms": float(np.abs(res.centers - twin.centers).max())
        / held["scale"], "q_rel": rel(res.objective, twin.objective)}
    rec["a_threads"]["vs_store_fit"] = {"store_q": held["store_q"],
                                "q_rel": rel(res.objective, held["store_q"])}
    if rec["a_threads"]["vs_torch"]["center_err_rel_rms"] > 1e-3 or \
            rec["a_threads"]["vs_torch"]["q_rel"] > 1e-4 or \
            rec["a_threads"]["vs_store_fit"]["q_rel"] > 1e-5:
        raise AssertionError(f"fleet (a): {rec['a_threads']}")

    # -- (b): the bf16 wire
    tr_b = MailboxTransport()
    t0 = time.perf_counter()
    res_b = fleet_fit(store, cfg, dataclasses.replace(fleet, wire="bf16"),
                      transport=tr_b, v_init=v_init, device=device)
    wall_b = time.perf_counter() - t0
    hold_fleet_result(res_b, res.live, 0, n, "fleet (b)")
    frames_b = fleet_frames(tr_b, res_b.live)
    worst = 0.0
    for h in sorted(frames):
        exact, _ = decode_summary(frames[h])
        quant, _ = decode_summary(frames_b[h])
        for e, q in zip(exact, quant):
            gap = (q - e).abs()
            if bool((gap > BF16_REL_BOUND * e.abs()).any()):
                raise AssertionError(f"fleet (b): host {h}'s bf16 frame "
                                     "is off its f32 frame past the bound")
            worst = max(worst, float((gap / e.abs().clamp_min(1e-30))
                                     .max()))
    rec["b_bf16"] = {"wall_s": wall_b, "objective": res_b.objective,
                "q_rel_vs_a": rel(res_b.objective, res.objective),
                "exchange_bytes": sum(map(len, frames_b.values())),
                "frame_rel_err_max": worst,
                "center_err_rel_rms": float(np.abs(
                    res_b.centers - res.centers).max()) / held["scale"]}
    if rec["b_bf16"]["q_rel_vs_a"] > 1e-3:
        raise AssertionError(f"fleet (b): {rec['b_bf16']}")

    # -- (c): a straggler evicted, its shards replanned onto the others
    fleet_c = FleetConfig(n_hosts=3, shards_per_host=FLEET_SHARDS,
                          prefetch_bytes=FLEET_PREFETCH_BYTES,
                          debug_delay_s={1: FLEET_DELAY_S},
                          straggler_factor=FLEET_STRAGGLER_FACTOR,
                          straggler_min_s=0.4)
    _, moved = replan(store, plan_partitions(store, 3 * FLEET_SHARDS),
                      2 * FLEET_SHARDS)
    obs.reset_all()
    t0 = time.perf_counter()
    res_c = fleet_fit(store, cfg, fleet_c, v_init=v_init, device=device)
    wall_c = time.perf_counter() - t0
    detected = obs.counter("fleet.straggler.detected").value
    obs.reset_all()
    hold_fleet_result(res_c, (0, 2), 1, n, "fleet (c)")
    rec["c_straggler"] = {"wall_s": wall_c, "objective": res_c.objective,
                "q_rel_vs_a": rel(res_c.objective, res.objective),
                "moved_chunks": res_c.moved_chunks, "replan_moved": moved,
                "straggler_detected": detected,
                "shard_seconds": res_c.shard_seconds}
    if res_c.moved_chunks != moved or moved == 0 or detected != 1 or \
            rec["c_straggler"]["q_rel_vs_a"] > 1e-5:
        raise AssertionError(f"fleet (c): {rec['c_straggler']}")

    # -- (d): kill one host of a 3-process fleet; against a threaded fleet
    #    born at 2 hosts (both derive their seeds from the config)
    fleet_kw = dict(shards_per_host=FLEET_SHARDS,
                    prefetch_bytes=FLEET_PREFETCH_BYTES,
                    debug_delay_s={1: FLEET_DELAY_S}, gather_timeout_s=600.0)
    born2 = fleet_fit(store, cfg, FleetConfig(
        n_hosts=2, shards_per_host=FLEET_SHARDS,
        prefetch_bytes=FLEET_PREFETCH_BYTES), device=device)
    fleet_dir = store_dir / "fleet_kill"
    mail = fleet_dir / MAIL_DIR
    t0 = time.perf_counter()
    procs = spawn_fleet(3, str(store_path), str(fleet_dir),
                        dataclasses.asdict(cfg), fleet_kw,
                        device=str(device))
    try:
        deadline = time.monotonic() + 600
        while not all((mail / f"e0000.sum.h{h:04d}.bin").exists()
                      for h in (0, 2)):
            if time.monotonic() > deadline or not (
                    procs[0].is_alive() and procs[2].is_alive()):
                raise AssertionError(
                    "fleet (d): hosts 0 and 2 never posted (exit codes "
                    f"{[p.exitcode for p in procs.values()]})")
            time.sleep(0.1)
        posted_s = time.perf_counter() - t0
        procs[1].terminate()
        watch_fleet(procs, str(fleet_dir), timeout_s=600)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
            p.join(timeout=60)
    wall_d = time.perf_counter() - t0
    codes = {h: p.exitcode for h, p in procs.items()}
    results = collect_results(str(fleet_dir), 3)
    if codes[0] != 0 or codes[2] != 0 or sorted(results) != [0, 2]:
        raise AssertionError(f"fleet (d): exit codes {codes}, results from "
                             f"{sorted(results)}")
    r0, r2 = results[0], results[2]
    rec["d_kill"] = {"wall_s": wall_d, "posted_s": posted_s, "exit_codes": codes,
                "objective": float(r0["objective"]),
                "moved_chunks": int(r0["moved_chunks"]),
                "obs_moved": [float(r0["obs_moved"]), float(r2["obs_moved"])],
                "born2_objective": born2.objective,
                "center_err_vs_born2": float(np.abs(
                    r0["centers"] - born2.centers).max()),
                "q_rel_vs_born2": rel(float(r0["objective"]),
                                      born2.objective),
                "bit_equal_born2": bool(
                    np.array_equal(r0["centers"], born2.centers)
                    and float(r0["objective"]) == born2.objective)}
    if not (list(r0["live"]) == list(r2["live"]) == [0, 2]
            and int(r0["epoch"]) == 1 and int(r0["n_rows"]) == n
            and int(r0["moved_chunks"]) == moved
            and rec["d_kill"]["obs_moved"] == [moved, moved]
            and np.array_equal(r0["centers"], r2["centers"])
            and float(r0["objective"]) == float(r2["objective"])
            and rec["d_kill"]["center_err_vs_born2"] <= 1e-5
            and rec["d_kill"]["q_rel_vs_born2"] < 1e-5
            and rec["d_kill"]["bit_equal_born2"]):
        raise AssertionError(f"fleet (d): {rec['d_kill']}")

    # -- (e): Mahout-KM on the KDD99-like array from its main path's seeds
    xk = torch.from_numpy(kdd["x"]).to(device)
    seeds = kdd["x"][kdd["sample_idx"]][kdd["seed_idx"]]
    v_k, counts, inertia, n_jobs, elapsed = mr_kmeans(xk, seeds,
                                                      device=device)
    exact = 0.0
    vk64 = v_k.double()
    for i in range(0, xk.shape[0], 1 << 16):
        xb = xk[i:i + (1 << 16)].double()
        exact += float(((xb[:, None] - vk64[None]) ** 2).sum(-1)
                       .min(-1).values.sum())
    rec["e_kmeans"] = {"n": int(xk.shape[0]), "c": int(v_k.shape[0]),
                "n_jobs": n_jobs, "elapsed_s": elapsed,
                "inertia": float(inertia), "inertia_float64": exact,
                "inertia_rel": rel(float(inertia), exact),
                "counts_sum": float(counts.sum())}
    if rec["e_kmeans"]["counts_sum"] != xk.shape[0] or rec["e_kmeans"]["inertia_rel"] > 1e-4:
        raise AssertionError(f"fleet (e): {rec['e_kmeans']}")
    del xk

    # -- K1 at the batch shape and K2 at the merge shape against their
    #    plain versions, on the fleet's own inputs: the store's first
    #    batch at the fleet's centers, the first pair a host merges
    centers = torch.from_numpy(res.centers).to(device)
    xb = torch.from_numpy(np.array(store.chunk(0))).to(device)
    pts = gathered.centers[:2].reshape(-1, d).contiguous()
    wts = gathered.masses[:2].reshape(-1).contiguous()
    heavier = bool(gathered.masses[0].sum() >= gathered.masses[1].sum())
    v_pair = gathered.centers[0 if heavier else 1].contiguous()
    cases = {"fleet_batch": (xb, torch.ones((rows,), dtype=torch.float32,
                                            device=device), centers, 0.0),
             "fleet_merge": (pts, wts, v_pair,
                             sweep_expansion_atol(pts, wts, v_pair, run.m))}
    new = []
    with uncounted():
        got = shape_entries(run.name, cases, by_shape, d, run.m, device,
                            20, full=None)
    for e in got:
        twin = next((o for o in entries if o["name"] == e["name"]
                     and o["shape"] == e["shape"]), None)
        if twin is None:
            new.append(e)
            continue
        twin["fleet_launches"] = e["launches"]
        twin["launches"] += e["launches"]
        twin["max_abs_err"] = max(twin["max_abs_err"], e["max_abs_err"])
    rec["kernel_holds"] = [{k: e[k] for k in (
        "name", "run", "shape", "launches", "max_abs_err", "ms", "plain_ms")}
        for e in got]
    obs.reset_all()
    emit(rec)
    return new


# The stream phase.  Micro-batches of 262,144 rows (43 MB at d = 41);
# drift streams at HIGGS width with C = 8, m = 2.
STREAM_ROWS = 1 << 18
DRIFT_D, DRIFT_C = 28, 8
STREAM_CKPT_STEP = 10        # kdd99_stream: checkpoint round trip here


@dataclasses.dataclass(frozen=True)
class DriftRun:
    name: str
    n_chunks: int
    drift_at: int
    shift: float
    drift_clusters: tuple     # () = every component moves
    cfg: tuple                # StreamConfig overrides, as (key, value)s


# (a) tests/test_stream.py:35-57's acceptance stream and config (window 3,
# decay 0.8, driver sample 384); (b) its birth/death stream and config
# (:60-89).  A record's residual is about d (unit spread), and the birth
# rule's outlier bar 8·d: the test's moved records (shift 12 at d = 6)
# sit at 12² + 6 ≈ 3.1 × 8·6; at d = 28 the same ratio takes a shift of
# 26.  There the starving center's death is a knife edge (PERF.md): it
# dies a step late in one f32 arithmetic and migrates onto the split-off
# component, tripping the shift test.  At 30 (3.9 × the bar) every
# arithmetic, float64 included, retires it at the first step it may.
DRIFT_RUNS = (
    DriftRun("drift_global", 12, 6, 10.0, (),
             (("window", 3), ("decay", 0.8), ("driver_sample", 384))),
    DriftRun("drift_split", 10, 4, 30.0, (0,),
             (("window", 3), ("decay", 0.6), ("driver_sample", 384),
              ("death_mass_floor", 0.25), ("reseed_cooldown", 2))))
# (c) tests/test_event_time.py:18-24's config; two 262,144-row chunks
# per 10-unit bucket, skew 5 below the lateness 20.
EVENT_CFG = (("window", 8), ("decay", 0.9), ("driver_sample", 256),
             ("event_time", True), ("slot_span", 10.0),
             ("allowed_lateness", 20.0))
EVENT_SKEW = 5.0


class DriverPin:
    """Wraps `repro_torch.stream.streaming.run_driver`: in ``record`` mode
    the race runs and its flag is kept; in ``replay`` mode (the twins,
    the restored model) the branch the race kept runs alone, from the
    same sample and seeds — the race is decided by the wall clock, so
    without it a twin could keep the other branch's centers."""

    def __init__(self):
        from repro_torch.stream import streaming
        self.module, self.real = streaming, streaming.run_driver
        self.mode, self.flag, self.races = "record", True, 0
        streaming.run_driver = self

    def __call__(self, x_sample, cfg, *, seed_idx, device):
        from repro_torch.core import fcm, wfcmpb
        if self.mode == "record":
            out = self.real(x_sample, cfg, seed_idx=seed_idx, device=device)
            self.flag, self.races = bool(out[1]), self.races + 1
            return out
        seeds = x_sample[torch_index(seed_idx, x_sample.device)]
        kw = dict(m=cfg.m, eps=cfg.driver_eps, max_iter=cfg.max_iter,
                  backend=cfg.backend, device=device)
        res = (fcm(x_sample, seeds, **kw) if self.flag else
               wfcmpb(x_sample, seeds, block_size=cfg.block_size, **kw))
        return res.centers, self.flag, 0.0, 0.0

    def close(self):
        self.module.run_driver = self.real


def torch_index(idx, device):
    import numpy as np
    import torch
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


@contextlib.contextmanager
def float64():
    """torch's default float type set to float64 inside the block: the
    port's plain path (`repro_torch.device.real_dtype`) computes in it."""
    import torch
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


class uncounted:
    """Launches inside the block leave every wrapper's counts as they
    were, and `repro_torch.obs` records nothing there (checks beside the
    main path are not the main path)."""

    def __enter__(self):
        from repro_torch import obs
        from repro_torch.kernels.fcm_update import WRAPPERS
        self.saved = [(fn, fn.launches, fn.shapes.copy()) for fn in WRAPPERS]
        self.obs_on = obs.enabled()
        obs.set_enabled(False)

    def __exit__(self, *exc):
        from repro_torch import obs
        for fn, launches, shapes in self.saved:
            fn.launches, fn.shapes = launches, shapes
        obs.set_enabled(self.obs_on)


class ObsCalls:
    """Counts the calls the port's modules make into `repro_torch.obs`
    (its package-level ``span``, ``counter``, ``gauge``, ``histogram``
    and ``event``, through which every instrumented module goes) while
    obs is enabled, inside the block."""

    NAMES = ("span", "counter", "gauge", "histogram", "event")

    def __enter__(self):
        from repro_torch import obs
        self.calls, self.saved = 0, {n: getattr(obs, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            setattr(obs, name, self._counted(fn))
        return self

    def _counted(self, fn):
        from repro_torch import obs

        def counted(*args, **kw):
            if obs.enabled():
                self.calls += 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        from repro_torch import obs
        for name, fn in self.saved.items():
            setattr(obs, name, fn)


OBS_BUDGET = 0.05    # the reference's ingest overhead budget (test_obs.py)


def obs_call_costs(n: int = 20_000, reps: int = 9) -> dict:
    """Seconds per call of one `obs.span` (enter and exit) and of one
    ``obs.counter(name).add``, each the minimum over ``reps`` runs of
    ``n`` calls (the host's clock; the minimum is robust to a loaded
    host where an on-vs-off race of whole ingests is not)."""
    from repro_torch import obs

    def span():
        with obs.span("chip_smoke.bench"):
            pass

    def add():
        obs.counter("chip_smoke.bench").add(1)
    out = {}
    for name, fn in (("span", span), ("counter_add", add)):
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n)
        out[name] = best
    return out


class StreamRun:
    """Drives one `StreamingBigFCM` on the card: times each ingest (host
    clock between `torch.cuda.synchronize()` calls) split into the drift
    probe, the combiner, the window merge and the driver, and — when
    ``twin`` — holds every ingest against twins started from the model's
    pre-ingest state (`hold_step`)."""

    STAGES = {"_probe": "probe_s", "_combine": "combiner_s",
              "_window_merge": "merge_s", "_driver_seed": "driver_s"}

    def __init__(self, name, model, pin, *, twin, scale, ckpt_dir=None):
        self.name, self.model, self.pin = name, model, pin
        self.twin, self.scale, self.ckpt_dir = twin, scale, ckpt_dir
        self.steps, self.not_fixed, self.ckpt = [], [], None
        self._ingest = model.ingest
        model.ingest = self.ingest
        for meth, key in self.STAGES.items():
            setattr(model, meth, self._timed(key, getattr(model, meth)))

    def _timed(self, key, fn):
        import torch

        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.cur[key] += time.perf_counter() - t0
            if key == "merge_s":
                self.merge_io = (args, out[0])
            return out
        return call

    def _fork(self, pre):
        """A ``torch``-backend model with the main one's config and its
        pre-ingest state, in `real_dtype`."""
        from repro_torch.stream import StreamingBigFCM
        cfg = dataclasses.replace(self.model.cfg, backend="torch")
        twin = StreamingBigFCM(cfg, device=self.model.device)
        if pre is not None:
            twin.load_state_arrays(pre)
        return twin

    def ingest(self, x, w=None, *, ts=None):
        import torch
        model = self.model
        pre = None if model.state is None else model.state_dict()
        step = 0 if pre is None else int(pre["step"])
        restored = None
        if self.ckpt_dir is not None and step == STREAM_CKPT_STEP:
            from repro_torch.ft import CheckpointManager
            from repro_torch.stream import StreamingBigFCM
            ckpt = CheckpointManager(str(self.ckpt_dir), async_save=False)
            model.save(ckpt)
            restored = StreamingBigFCM.restore(
                ckpt, model.cfg, int(pre["centers"].shape[1]),
                device=model.device)
        self.cur = dict.fromkeys(self.STAGES.values(), 0.0)
        self.pin.mode = "record"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = self._ingest(x, w, ts=ts)
        torch.cuda.synchronize()
        rec = {"step": rep.step, "wall_s": time.perf_counter() - t0,
               **self.cur, "combiner_iters": int(rep.combiner_iters[0]),
               "drifted": rep.drifted, "reason": rep.reason,
               "born": rep.born, "died": rep.died,
               "n_centers": rep.n_centers,
               "objective_post": rep.objective_post}
        self.pin.mode = "replay"
        with uncounted():
            if self.twin:
                rec["held"] = self.hold_step(pre, x, w, ts, rep)
            if restored is not None:
                self.ckpt = hold_restored(restored, model, x, w, ts, rep)
        self.steps.append(rec)
        return rep

    def hold_step(self, pre, x, w, ts, rep) -> dict:
        """The step against two ``torch``-backend twins from the same
        pre-ingest state, fed the same batch (and, on a re-seed, the same
        draws and driver branch): one in float32, one in float64 (the
        exact answer, to within the step's conditioning).

        Each quantity must meet its bar against the float32 twin (the
        same decisions — drifted, reason, born, died, n_centers —;
        merged centers within 1e-3 of the data's RMS, as sets;
        objective_post within 1e-4 relative; combiner sweeps ±2), or lie
        no farther from the float64 twin than that bar or twice the
        float32 twin's own distance (decisions: equal to the float64
        twin's), so that it is as near the exact answer as the plain
        version.

        Centers and objective that miss both are released only where the
        window merge is shown not fixed at f32 against float64
        (`merge_conditioning`): the model's window (its combiner's
        output) lies as near the float64 twin's as the float32 twin's
        does, and the model's merge of that window lies no farther from
        its float64 merge than the bar or twice as far as the plain f32
        merges of the same window do.  Such a step is printed and
        counted; any other miss raises."""
        twin = self._fork(pre)
        tmerge = capture(twin, "_window_merge")
        trep = twin.ingest(x, w, ts=ts)
        with float64():
            exact = self._fork(pre)
            emerge = capture(exact, "_window_merge")
            erep = exact.ingest(x, w, ts=ts)
        h = (rep, self.model.state.centers)
        t = (trep, twin.state.centers)
        e = (erep, exact.state.centers)
        got = {"vs_torch": step_gap(h, t, self.scale),
               "vs_float64": step_gap(h, e, self.scale),
               "torch_vs_float64": step_gap(t, e, self.scale)}
        missed = missed_bars(got)
        if missed:
            cond = self.merge_conditioning(self.merge_io, tmerge[0],
                                           emerge[0])
            got.update({"missed": sorted(missed), "merge_conditioning": cond})
            if missed - {"centers", "objective"} or not cond["not_fixed"]:
                raise AssertionError(f"{self.name} step {rep.step}: hopper "
                                     f"vs torch and float64: {got}")
            self.not_fixed.append(rep.step)
        return got

    def merge_conditioning(self, hop, tor, ex) -> dict:
        """Is the step's window merge fixed at f32?  ``hop``, ``tor``,
        ``ex``: each run's last (window, merged centers).  The model's
        window is merged again through the model's backend (bit-identical
        to its merge), through ``torch`` in float32 plainly and
        translated by its mean (two f32 computations of one problem), and
        in float64; every f32 result's distance from the float64 merge."""
        import torch
        from repro_torch.engine import Summary, merge_summaries
        (wh, mh), (wt, _), (we, me) = hop, tor, ex
        plan = self.model.cfg.window_plan()

        def merge(c, w, backend, shift=None):
            res = merge_summaries(Summary(c if shift is None else c - shift,
                                          w), plan, backend=backend)
            v = res.summary.centers
            return (v if shift is None else v + shift), res.n_iter
        wc, ww = wh
        mu = wc[ww > 0].mean(0)
        again, n_h = merge(wc, ww, self.model.backend)
        p1, n_p1 = merge(wc, ww, "torch")
        p2, n_p2 = merge(wc, ww, "torch", mu)
        with float64():
            e64, n_e = merge(wc.double(), ww.double(), "torch")
        rec = {"merge_again_bit_identical": bool(torch.equal(again, mh)),
               "merge_sweeps": {"model": n_h, "torch": n_p1,
                                "torch_translated": n_p2, "float64": n_e},
               "window_vs_float64": window_gap(wh, we, self.scale),
               "torch_window_vs_float64": window_gap(wt, we, self.scale),
               "merge_vs_float64_merge": center_gap(mh, e64, self.scale),
               "torch_merge_vs_float64_merge": center_gap(p1, e64,
                                                          self.scale),
               "torch_translated_merge_vs_float64_merge": center_gap(
                   p2, e64, self.scale),
               "float64_merge_vs_float64_twin": center_gap(e64, me,
                                                           self.scale)}
        spread = max(rec["torch_merge_vs_float64_merge"],
                     rec["torch_translated_merge_vs_float64_merge"])
        rec["not_fixed"] = (rec["merge_again_bit_identical"]
                            and rec["window_vs_float64"] <= max(
                                1e-5, 2 * rec["torch_window_vs_float64"])
                            and rec["merge_vs_float64_merge"] <= max(
                                STEP_BARS["centers"], 2 * spread))
        return rec

    def close(self):
        self.model.ingest = self._ingest
        for meth in self.STAGES:
            delattr(self.model, meth)


def capture(model, meth) -> list:
    """Keeps the last (arguments, first output) of ``model.meth`` in the
    returned list's one slot."""
    box, fn = [None], getattr(model, meth)

    def call(*args):
        out = fn(*args)
        box[0] = (args, out[0])
        return out
    setattr(model, meth, call)
    return box


def window_gap(a, b, scale) -> float:
    """How far two windows ((W, C, d) centers, (W, C) masses) lie apart:
    the larger of the live rows' center gap over ``scale`` and the
    masses' gap over the largest mass."""
    (ca, wa), (cb, wb) = a, b
    if ca.shape != cb.shape:
        return math.inf
    live = (wa > 0) | (wb > 0)
    dc = (ca.double() - cb.double()).abs().amax(-1)[live].max()
    dw = (wa.double() - wb.double()).abs().max() / wb.double().abs().max()
    return max(float(dc) / scale, float(dw))


# `StreamRun.hold_step`'s bars (decisions: equal).
STEP_BARS = {"centers": 1e-3, "objective": 1e-4, "sweeps": 2}


def within_bar(k, v) -> bool:
    return v if k == "decisions" else v <= STEP_BARS[k]


def missed_bars(got) -> set:
    """The quantities of a step that meet their bar neither against the
    float32 twin nor, as near the exact answer as it, against the
    float64 one."""
    vt, vf, tf = (got[k] for k in ("vs_torch", "vs_float64",
                                   "torch_vs_float64"))
    missed = set()
    for k in vt:
        if within_bar(k, vt[k]):
            continue
        if k == "decisions" and vf[k] or k != "decisions" and (
                vf[k] <= max(STEP_BARS[k], 2 * tf[k])):
            continue
        missed.add(k)
    return missed


def center_gap(a, b, scale) -> float:
    """How far two center sets lie apart, over ``scale``: the largest
    max-norm distance from a center of either set to the nearest center
    of the other (inf when their counts differ).  Birth and death leave
    the order of co-located centers to rounding, so order is not held."""
    if a.shape != b.shape:
        return math.inf
    d = (a.double()[:, None] - b.double()[None]).abs().amax(-1)
    return max(float(d.min(1).values.max()),
               float(d.min(0).values.max())) / scale


def step_gap(a, b, scale) -> dict:
    """How far one ingest lies from another, each as (report, centers):
    equal decisions, center gap (`center_gap`), objective_post's relative
    gap, combiner sweeps apart."""
    (ra, va), (rb, vb) = a, b
    fields = ("drifted", "reason", "born", "died", "n_centers")
    return {"decisions": all(getattr(ra, f) == getattr(rb, f)
                             for f in fields),
            "centers": center_gap(va, vb, scale),
            "objective": abs(ra.objective_post - rb.objective_post)
            / abs(rb.objective_post),
            "sweeps": abs(int(ra.combiner_iters[0])
                          - int(rb.combiner_iters[0]))}


def hold_restored(restored, model, x, w, ts, rep) -> dict:
    """The model restored from its own mid-stream checkpoint ingests the
    same batch: report and state bit-identical to the live model's."""
    import numpy as np
    import torch
    again = restored.ingest(x, w, ts=ts)
    for f in rep._fields:
        a, b = getattr(again, f), getattr(rep, f)
        if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b or (a != a and b != b)):
            raise AssertionError(f"restored stream: report {f} {a} != {b}")
    for f, a in restored.state._asdict().items():
        if not torch.equal(a.cpu(), getattr(model.state, f).cpu()):
            raise AssertionError(f"restored stream: state {f} differs")
    return {"step": rep.step, "bit_identical": True}


def stream_launches(name, run_name):
    """The main path's launch record of a stream run: per wrapper, total
    and per shape, every launch on the plan's path."""
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_sweep_cuda)
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"{name}: a kernel was not launched: "
                             f"{launches}")
    check_paths(run_name, fcm_sweep_cuda, fcm_accumulate_cuda)
    by_shape = {"fcm_sweep": dict(fcm_sweep_cuda.shapes),
                "fcm_accumulate": dict(fcm_accumulate_cuda.shapes)}
    return launches, by_shape, {
        "fcm_sweep": shape_counts(fcm_sweep_cuda),
        "fcm_accumulate": shape_counts(fcm_accumulate_cuda)}


def expansion_atol(x, w, v, m) -> tuple:
    """Per-entry atols of K1's (v_num, w_i, q) at records ``x`` (masses
    ``w``) that lie on or between centers ``v``.  The kernel forms d² =
    ‖x‖² + ‖v‖² − 2x·v, each entry within δ = 2·γ_{d+2}·(‖x‖² + ‖v‖²)
    of the exact d² (`q_rounding_bound`); where δ is not small beside
    d², the memberships are rounding's.  In float64, each u_ik^m is
    bounded over d²_ik ± δ with the other centers' d² moved the other
    way (Δ_ik), and the atols are Σ_k w_k·(Δ_ik + RTOL·u_ik^m)·|x_k|,
    Σ_k w_k·Δ_ik and Σ_k w_k·Σ_i (Δ_ik·(d²_ik + δ_ik) + u_ik^m·δ_ik)."""
    import torch
    x, w, v = x.double(), w.double(), v.double()
    gamma = (x.shape[1] + 2) * 2.0 ** -24
    d2 = ((x[:, None] - v[None]) ** 2).sum(-1).clamp_min(1e-12)
    delta = 2 * gamma * ((x * x).sum(1)[:, None] + (v * v).sum(1)[None])
    eye = torch.eye(v.shape[0], dtype=torch.bool, device=x.device)

    def um(own, others):
        """u_ik^m with d²_ik = own and every other center's = others."""
        e = (own.log()[:, :, None] - others.log()[:, None, :]) / (m - 1.0)
        lse = e.masked_fill(eye, -math.inf).logsumexp(-1)
        return torch.sigmoid(-lse) ** m
    u = um(d2, d2)
    lo, hi = (d2 - delta).clamp_min(1e-12), d2 + delta
    dev = torch.maximum(um(lo, hi) - u, u - um(hi, lo)) * w[:, None]
    terms = dev + RTOL * u * w[:, None]
    return tuple(a.float() for a in (
        terms.T @ x.abs(), dev.sum(0),
        (dev * (d2 + delta) + u * w[:, None] * delta).sum()))


def stream_cases(name, x_rows, model, by_shape):
    """The kernels' inputs at every (N, C) a stream run launched them at.
    C centers are the first C of the final ones, topped up with records
    where the run had more.  ``slot``, K1 at the final C points: the pair
    the windowed merge launches — the heaviest window slot's centers and
    masses against the merged centers.  Its points lie on or between
    centers, where the kernel's d² expansion leaves memberships to
    rounding, so its atols are `expansion_atol`'s; there the kernel is
    also held to them against a float64 accumulate, and both versions'
    distance from it printed.  ``batch C=c``, the first STREAM_ROWS
    records at unit weights; any other (N, C) as the first N records."""
    import torch
    from repro_torch.engine.backend import fcm_accumulate
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref)
    v_fin, m = model.state.centers, model.cfg.m
    slot = int(torch.argmax(model.state.win_weights.sum(1)))
    cases = {}
    for n, c in sorted({k[1:] for shapes in by_shape.values()
                        for k in shapes}):
        v = torch.cat([v_fin, x_rows[:c]])[:c].contiguous()
        if n == c == v_fin.shape[0]:
            pts = model.state.win_centers[slot].contiguous()
            masses = model.state.win_weights[slot].contiguous()
            tol = expansion_atol(pts, masses, v, m)
            with float64():
                exact = [a.float() for a in fcm_accumulate(
                    pts.double(), masses.double(), v.double(), m)]
            with uncounted():
                got = fcm_accumulate_cuda(pts, masses, v, m)
            plain = fcm_accumulate_ref(pts, masses, v, m)
            atols = tuple(ACC_ATOL + e for e in tol)
            emit({"phase": "stream", "run": name, "slot_case": {
                "shape": list(pts.shape) + [c],
                "atol_max": [float(a.max()) for a in atols],
                "kernel_vs_float64": max_err(
                    got, exact, RTOL, atols, f"{name} slot K1 vs float64"),
                "plain_vs_float64": [float((a - b).abs().max())
                                     for a, b in zip(plain, exact)],
                "kernel_vs_plain": [float((a - b).abs().max())
                                    for a, b in zip(got, plain)]}})
            cases["slot"] = (pts, masses, v, tol)
            continue
        xs = x_rows[:n]
        w = torch.ones((n,), dtype=torch.float32, device=xs.device)
        label = f"batch C={c}" if n == STREAM_ROWS else f"n={n} C={c}"
        cases[label] = (xs, w, v,
                        0.0 if n == STREAM_ROWS else q_rounding_bound(xs, w, v))
    return cases


def run_kdd99_stream(x_np, seed, device, ckpt_dir, pin):
    """``kdd99_stream``: the KDD99-like array replayed through
    `assign_stream(model, stream_loader(replay_source(x, 262144),
    262144))` on backend ``hopper``, C = 23, m = 1.2 (the paper's), the
    `StreamConfig` defaults otherwise; launch counts zeroed just before
    the loop and read just after.  Every ingest is step-locked against a
    ``torch`` twin, the model is checkpointed and restored at step
    STREAM_CKPT_STEP, and the last batch's labels are held against
    `make_assigner` of the final centers.  Returns the kernel entries."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.data import replay_source, stream_loader
    from repro_torch.kernels.fcm_update import reset_counts
    from repro_torch.serve import assign_stream, make_assigner
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    n, d = x_np.shape
    cfg = StreamConfig(n_clusters=23, m=1.2, seed=seed, backend="hopper")
    model = StreamingBigFCM(cfg, device=device)
    scale = float(np.sqrt(np.mean(np.square(x_np[:STREAM_ROWS],
                                            dtype=np.float64))))
    run = StreamRun("kdd99_stream", model, pin, twin=True, scale=scale,
                    ckpt_dir=ckpt_dir)
    obs.reset_all()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ObsCalls() as calls:
        for labels, rep in assign_stream(model, stream_loader(
                replay_source(x_np, STREAM_ROWS), STREAM_ROWS,
                device=device)):
            pass
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, by_shape, printed = stream_launches("kdd99_stream",
                                                  "kdd99_stream")
    run.close()
    last = n - (n - 1) // STREAM_ROWS * STREAM_ROWS
    x_last = torch.from_numpy(x_np[n - last:]).to(device)
    want = make_assigner(model.state.centers, m=cfg.m, backend="hopper",
                         device=device)(x_last).cpu().numpy()
    ties = label_ties(labels, want, x_last, model.state.centers)
    if run.ckpt is None or len(run.steps) != -(-n // STREAM_ROWS):
        raise AssertionError(f"kdd99_stream: {len(run.steps)} ingests, "
                             f"checkpoint {run.ckpt}")
    record = stream_record("kdd99_stream", run, cfg, n, d, loop_s, launches,
                           printed)
    record.update({"last_batch_rows": last, "assign_ties_differing": ties,
                   "checkpoint": run.ckpt,
                   "obs": stream_obs(run, n, calls.calls)})
    emit(record)
    xd = torch.from_numpy(x_np[:STREAM_ROWS]).to(device)
    return shape_entries("kdd99_stream",
                         stream_cases("kdd99_stream", xd, model, by_shape),
                         by_shape, d, cfg.m, device, 20, full=None)


def stream_obs(run, n, calls) -> dict:
    """The obs record of ``kdd99_stream``: its phase breakdown, the
    counters held against what the run did (``stream.records`` against
    the array's rows, births, deaths and re-seeds against the ingest
    reports, ``serve.records`` against the labels), and obs's cost share
    of a steady ingest: ``calls`` (every obs call of the run, `ObsCalls`)
    per ingest times the dearer of one span and one counter add
    (`obs_call_costs`), over the median ingest wall past the first;
    held to OBS_BUDGET."""
    from repro_torch import obs
    snap = obs.metrics_snapshot()
    counters = snap["counters"]
    steps = run.steps
    want = {"stream.records": n, "serve.records": n,
            "stream.births": sum(s["born"] for s in steps),
            "stream.deaths": sum(s["died"] for s in steps),
            "stream.reseeds": sum(s["drifted"] for s in steps)}
    got = {k: counters.get(k, 0.0) for k in want}
    if got != want:
        raise AssertionError(f"kdd99_stream obs counters {got}, the run "
                             f"did {want}")
    spans = {k: h["count"] for k, h in snap["histograms"].items()
             if k.startswith("span.")}
    if spans.get("span.stream.ingest") != len(steps):
        raise AssertionError(f"kdd99_stream: {spans} for {len(steps)} "
                             "ingests")
    breakdown = obs.phase_breakdown()
    costs = obs_call_costs()
    walls = sorted(s["wall_s"] for s in steps[1:])
    steady = walls[len(walls) // 2]
    per_ingest = calls / len(steps)
    share = per_ingest * max(costs.values()) / steady
    if share > OBS_BUDGET:
        raise AssertionError(f"obs costs {share:.2%} of a steady ingest")
    obs.reset_all()
    return {"phase_breakdown": breakdown, "counters": counters,
            "gauges": snap["gauges"], "spans": spans, "calls": calls,
            "calls_per_ingest": per_ingest, "call_cost_s": costs,
            "steady_ingest_wall_s": steady, "cost_share": share,
            "budget": OBS_BUDGET}


def label_ties(got, want, x, centers) -> int:
    """Rows whose hard labels differ must be ties within f32 rounding;
    returns their count."""
    import numpy as np
    bad = np.flatnonzero(got != want)
    if bad.size:
        xs = x[torch_index(bad, x.device)]
        d2 = ((xs[:, None, :] - centers[None]) ** 2).sum(-1).cpu().numpy()
        rows = np.arange(bad.size)
        ga, wa = d2[rows, got[bad]], d2[rows, want[bad]]
        if np.any(np.abs(ga - wa) > 1e-6 * np.maximum(ga, wa)):
            raise AssertionError(f"{bad.size} labels differ beyond a tie")
    return int(bad.size)


def stream_record(name, run, cfg, n, d, loop_s, launches, printed) -> dict:
    """A stream run's phase record: sizes, ingest walls and their split,
    launches, and the step-lock results."""
    steps = run.steps
    tot = {k: sum(s[k] for s in steps) for k in
           ("wall_s", "probe_s", "combiner_s", "merge_s", "driver_s")}
    return {"phase": "stream", "run": name, "n": n, "d": d,
            "c": cfg.n_clusters, "m": cfg.m, "window": cfg.window,
            "batch_rows": STREAM_ROWS, "ingests": len(steps),
            "loop_s": loop_s, "ingest_totals_s": tot,
            "combiner_sweeps": sum(s["combiner_iters"] for s in steps),
            "launches": launches, "launches_by_shape": printed,
            "driver_races": run.pin.races,
            "not_fixed_at_f32_steps": run.not_fixed, "steps": steps}


def drift_chunks(run: DriftRun, seed):
    from repro_torch.data import make_moving_blobs
    return [x for x, _ in make_moving_blobs(
        run.n_chunks, STREAM_ROWS, DRIFT_D, DRIFT_C, drift_at=run.drift_at,
        shift=run.shift, seed=seed,
        drift_clusters=run.drift_clusters or None)]


def run_drift_stream(run: DriftRun, chunks, seed, device, pin):
    """(a) global drift or (b) a component splitting off, at d = 28,
    C = 8, m = 2, every ingest held against its twins
    (`StreamRun.hold_step`); (a) re-seeds exactly once, within the
    cooldown of the drift, and ends within 5 % of a fresh `bigfcm_fit`
    of its last window; (b) births one center and never re-seeds —
    unless a step up to the re-seed was shown not fixed at f32 against
    float64 — and its deaths are printed (the reference's death
    count is not a stable oracle).  Returns the kernel entries."""
    import numpy as np
    import torch
    from repro_torch.core import BigFCMConfig, bigfcm_fit
    from repro_torch.core.metrics import fuzzy_objective
    from repro_torch.kernels.fcm_update import reset_counts
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    cfg = StreamConfig(n_clusters=DRIFT_C, m=2.0, seed=seed, backend="hopper",
                       **dict(run.cfg))
    model = StreamingBigFCM(cfg, device=device)
    scale = float(np.sqrt(np.mean(np.square(chunks[0], dtype=np.float64))))
    srun = StreamRun(run.name, model, pin, twin=True, scale=scale)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = model.run(chunks)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, by_shape, printed = stream_launches(run.name, run.name)
    srun.close()
    st = model.state
    record = stream_record(run.name, srun, cfg, len(chunks) * STREAM_ROWS,
                           DRIFT_D, loop_s, launches, printed)
    record.update({"reseeds": int(st.reseeds), "births": int(st.births),
                   "deaths": int(st.deaths),
                   "reseed_steps": [i for i, r in enumerate(reps)
                                    if r.reseeded]})
    if run.drift_clusters:
        # A re-seed is held to 0 unless a step up to it was shown not
        # fixed at f32 against float64: then which attractor
        # the merge reached there (the old center starving, or migrating
        # onto the split-off component and tripping the shift test) is
        # rounding's choice, as the reference's death count is.
        first = (record["reseed_steps"] or [math.inf])[0] + 1
        loose = any(s <= first for s in srun.not_fixed)
        record["reseeds_held"] = not loose
        if int(st.births) != 1 or int(st.reseeds) != 0 and not loose:
            raise AssertionError(f"{run.name}: {record}")
    else:
        lo, hi = run.drift_at, run.drift_at + cfg.reseed_cooldown
        if int(st.reseeds) != 1 or not lo <= record["reseed_steps"][0] <= hi:
            raise AssertionError(f"{run.name}: {record}")
        x_win = torch.from_numpy(np.concatenate(
            chunks[-cfg.window:])).to(device)
        batch = bigfcm_fit(x_win, BigFCMConfig(
            n_clusters=DRIFT_C, sample_size=cfg.driver_sample, seed=1,
            backend="hopper"), device=device)
        q_stream = float(fuzzy_objective(x_win, st.centers, cfg.m))
        q_batch = float(fuzzy_objective(x_win, batch.centers, cfg.m))
        record["q_last_window"] = {"stream": q_stream, "batch": q_batch}
        if q_stream > 1.05 * q_batch:
            raise AssertionError(f"{run.name}: {record['q_last_window']}")
        del x_win
    emit(record)
    xd = torch.from_numpy(chunks[-1]).to(device)
    return shape_entries(run.name,
                         stream_cases(run.name, xd, model, by_shape),
                         by_shape, DRIFT_D, cfg.m, device, 20, full=None)


def run_event_stream(chunks, seed, device, pin):
    """(c) the stationary prefix of (a), stamped (`stamp_source`, two
    chunks per bucket) and fed in order and through
    `out_of_order_source` with a skew below the allowed lateness: no
    record dropped, the watermark monotone, each run's objective on the
    prefix within 5 % of the other's.  Returns the kernel entries."""
    import numpy as np
    import torch
    from repro_torch.core.metrics import fuzzy_objective
    from repro_torch.data import out_of_order_source, stamp_source
    from repro_torch.kernels.fcm_update import reset_counts
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    cfg = StreamConfig(n_clusters=DRIFT_C, m=2.0, seed=seed,
                       backend="hopper", **dict(EVENT_CFG))
    dt = cfg.slot_span / 2 / STREAM_ROWS
    record, q, entries = {"phase": "stream", "run": "drift_event"}, {}, []
    for order in ("in_order", "out_of_order"):
        src = stamp_source(iter(chunks), dt=dt)
        if order == "out_of_order":
            src = out_of_order_source(src, skew=EVENT_SKEW, seed=seed)
        model = StreamingBigFCM(cfg, device=device)
        srun = StreamRun("drift_event", model, pin, twin=False, scale=1.0)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = model.run(src)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches, by_shape, printed = stream_launches(
            f"drift_event/{order}", "drift_event")
        srun.close()
        wms = [r.watermark for r in reps]
        rec = stream_record(f"drift_event/{order}", srun, cfg,
                            len(chunks) * STREAM_ROWS, DRIFT_D, loop_s,
                            launches, printed)
        rec.pop("phase")
        rec.update({"late_dropped": int(model.state.late_dropped),
                    "watermark_monotone": all(
                        b >= a for a, b in zip(wms, wms[1:]))})
        record[order] = rec
        if rec["late_dropped"] or not rec["watermark_monotone"]:
            raise AssertionError(f"drift_event {order}: {rec}")
        xd = torch.from_numpy(np.concatenate(chunks)).to(device)
        q[order] = float(fuzzy_objective(xd, model.state.centers, cfg.m))
        del xd
        if order == "out_of_order":
            xb = torch.from_numpy(chunks[0]).to(device)
            entries = shape_entries(
                "drift_event",
                stream_cases("drift_event", xb, model, by_shape), by_shape,
                DRIFT_D, cfg.m, device, 20, full=None)
    record["q"] = q
    if not (q["out_of_order"] <= 1.05 * q["in_order"]
            and q["in_order"] <= 1.05 * q["out_of_order"]):
        raise AssertionError(f"drift_event: {record}")
    emit(record)
    return entries


def run_stream_path(kdd_x, seed, device, ckpt_dir) -> list:
    """The stream phase (module note, phase 6).  Returns kernel entries."""
    pin = DriverPin()
    try:
        entries = run_kdd99_stream(kdd_x, seed, device, ckpt_dir, pin)
        import torch
        torch.cuda.empty_cache()
        emit(run_live_serve(kdd_x, seed, device))
        torch.cuda.empty_cache()
        for run in DRIFT_RUNS:
            chunks = drift_chunks(run, seed)
            entries += run_drift_stream(run, chunks, seed, device, pin)
            if not run.drift_clusters:
                prefix = chunks[:run.drift_at]
            torch.cuda.empty_cache()
        entries += run_event_stream(prefix, seed, device, pin)
    finally:
        pin.close()
    return entries


# The calibrate phase: the perf plane on the card (module note, phase
# 2d).  Probe ladders big enough to reach an H100's roofs.
CALIB_STREAM_FLOATS = (1 << 24, 1 << 26)
CALIB_MATMUL_NS = (4096, 8192)
HOPPER_BACKENDS = ("hopper", "hopper_accumulate")


def calibrate_buckets() -> dict:
    """The (n, C, d) shapes whose buckets the main path resolves: the
    default bucket and each run's driver sample (router_fit's Parker–Hall
    sample is every row), single-model; the tenant cohorts' packed
    (T, N, C, d), tenant-stacked."""
    from repro_torch.core.sampling import parker_hall_sample_size
    from repro_torch.perf.calibrate import DEFAULT_SHAPE
    rc = router_config(0)
    router_n = min(ROUTER_N, parker_hall_sample_size(rc.n_clusters, rc.r,
                                                     rc.alpha))
    shapes = {"default": (DEFAULT_SHAPE, None)}
    for run in RUNS:
        shapes[f"{run.name} driver"] = ((min(SAMPLE_SIZE, run.n), run.c,
                                         run.d), None)
    shapes["router_fit driver"] = ((router_n, ROUTER_C, ROUTER_D), None)
    for run in TENANT_RUNS:
        shapes[run.name] = ((run.rows[1] - 1, TENANT_C, TENANT_D),
                            run.tenants)
    return shapes


def hold_tuned(cfg, shape, tenants, device) -> float:
    """Every plan of the search's grid at its tuned shape, launched and
    held against the plain version (rows in 1 GB chunks) at the sweep
    tolerances, whether it was timed or won or not; the chosen one rerun
    bit for bit."""
    import torch
    from repro_torch.kernels import fcm_update as fu
    from repro_torch.kernels.fcm_update import PlanChoice
    from repro_torch.perf import autotune
    tshape = tuple(cfg["tuned_shape"])
    x, w, v = autotune._tune_data(tshape, device, seed=1)
    if tenants is None:
        launch, plain = fu._launch, plain_in_rows(fu.fcm_accumulate_ref, True)
    else:
        launch = fu._launch_batched
        plain = plain_in_rows(fu.fcm_accumulate_batched_ref, True)
    want = plain(x, w, v, 2.0)
    err = 0.0
    for choice in autotune.choice_grid(cfg["plan"]["path"]):
        what = f"plan {choice} at {tshape}"
        got = launch(x, w, v, 2.0, True, choice)[0]
        err = max(err, max_err(got, want, RTOL, SWEEP_ATOL, what))
    choice = PlanChoice(**cfg["choice"])
    got = launch(x, w, v, 2.0, True, choice)[0]
    if not all(torch.equal(a, b) for a, b in zip(
            got, launch(x, w, v, 2.0, True, choice)[0])):
        raise AssertionError(f"tuned plan {choice}: two launches differ")
    del x, w, v, got, want
    torch.cuda.empty_cache()
    return err


def run_calibrate(device) -> dict:
    """Phase 2d: the perf plane on the card, in the calibration sandbox
    (``REPRO_CALIB_DIR``): the probed peaks beside the datasheet's; at
    each bucket of `calibrate_buckets` the backend race ("auto"'s
    winner, a kernel backend, each backend's µs and parity) and the
    launch-plan search (the untuned plan's card and synchronized-launch
    times, the chosen plan against it, every plan of the grid held
    against the plain version).
    The main path runs after it, on the chosen plans."""
    import os
    from repro_torch.perf import autotune, calibrate
    t0 = time.perf_counter()
    peaks = calibrate.cached_peaks(device=device,
                                   stream_floats=CALIB_STREAM_FLOATS,
                                   matmul_ns=CALIB_MATMUL_NS, iters=5)
    rec = {"phase": "calibrate", "dir": os.environ.get(calibrate.ENV_DIR),
           "peaks": peaks,
           "datasheet": {"stream_bytes_per_s": PEAK_BYTES_PER_S,
                         "matmul_f32_flops_per_s": PEAK_F32_FLOP_PER_S},
           "probed_over_datasheet": {
               "bytes": peaks["stream_bytes_per_s"] / PEAK_BYTES_PER_S,
               "f32": peaks["matmul_f32_flops_per_s"]
               / PEAK_F32_FLOP_PER_S},
           "probe_s": time.perf_counter() - t0, "races": {}, "tuned": {}}
    for label, (shape, tenants) in calibrate_buckets().items():
        if tenants is None:
            winner = calibrate.calibrated_backend_name(shape, device=device)
            key = calibrate.bucket_key(calibrate.shape_bucket(*shape))
            entry = calibrate.load_calibration(device=device)["winners"][key]
            # On the card "auto" must land on a hand-written kernel that
            # agrees with the oracle, at every bucket.
            if entry["errors"] or winner not in HOPPER_BACKENDS or not all(
                    entry["parity"][k] for k in HOPPER_BACKENDS + ("torch",)):
                raise AssertionError(f"race at {label}: {entry}")
            rec["races"][label] = {"shape": list(shape), "bucket": key,
                                   "winner": winner, **entry}
        t1 = time.perf_counter()
        cfg = autotune.tune_sweep_blocks(shape, tenants=tenants,
                                         device=device)
        rec["tuned"][label] = {
            "shape": list(shape), "tenants": tenants,
            "key": autotune.tile_key(shape, tenants), **cfg,
            "search_s": time.perf_counter() - t1,
            "max_abs_err": hold_tuned(cfg, shape, tenants, device)}
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def roofline_record(n, c, d, x, w, v, m, device) -> dict:
    """`kernel_roofline` of ``hopper`` at a run's full shape on its own
    records (the probed peaks of the calibrate phase), with the analytic
    model held to `bound`: `sweep_bytes` is the same count of bytes;
    `sweep_flops` adds 2·N·d + 2·C·d + 14·N·C (norms, d² assembly,
    membership, reductions) to the bound's 4·N·C·d contractions."""
    from repro_torch.perf import calibrate, roofline
    row = roofline.kernel_roofline(
        "hopper", (n, c, d), peaks=calibrate.cached_peaks(device=device),
        m=m, iters=5, device=device, data=(x, w, v))
    model_bytes = roofline.sweep_bytes(n, c, d)
    if model_bytes != bound_bytes(n, d, c):
        raise AssertionError(f"sweep_bytes {model_bytes} != bound's "
                             f"{bound_bytes(n, d, c)}")
    flops = roofline.sweep_flops(n, c, d)
    return {**row, "sweep_bytes": model_bytes,
            "bound_bytes": bound_bytes(n, d, c), "sweep_flops": flops,
            "bound_flops": 4 * n * c * d,
            "flops_over_bound": flops / (4 * n * c * d),
            "flops_difference": "2Nd + 2Cd + 14NC: norms, d² assembly, "
                                "membership and reductions, which the "
                                "bound leaves out"}


# The serve phase: benchmarks/t14_serve.py's traffic (its request pool,
# :59-67: 40 distinct sizes, lognormal over 16-1024 rows; 1200 requests;
# 4096-row batches on a 64-base bucket ladder) at the KDD99-like fit's
# width (C = 23, d = 41, m = 1.2), its rows drawn from that array.
SERVE_SIZES, SERVE_REQS, SERVE_PER_REQ = 40, 1200, 240
SERVE_CLIENTS = (1, 4, 16)
SERVE_MAX_BATCH, SERVE_BASE = 4096, 64
SHED_QUEUE_ROWS, SHED_BURST, SHED_ROWS, SHED_CLIENTS = 4096, 8, 256, 32


def serve_pool(x_np, k, seed):
    """t14_serve.py's `_request_pool` sizes (k requests over 40 distinct
    row counts in [16, 1024], lognormal-ish), rows taken from ``x_np`` at
    random offsets."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = np.unique(np.clip(np.round(np.exp(rng.uniform(
        np.log(16), np.log(1024), SERVE_SIZES))), 16, 1024).astype(int))
    picks = rng.choice(sizes, size=k)
    starts = rng.integers(0, x_np.shape[0] - 1024, size=k)
    return [np.ascontiguousarray(x_np[s:s + int(n)])
            for s, n in zip(starts, picks)]


def quantiles_ms(values) -> dict:
    import numpy as np
    v = np.asarray(values, np.float64) * 1e3
    return {"n": int(v.size), "p50_ms": float(np.percentile(v, 50)),
            "p99_ms": float(np.percentile(v, 99))}


def span_buckets(name) -> dict:
    """p50/p99 of the ring's ``name`` spans per ``bucket`` field."""
    from repro_torch import obs
    by = collections.defaultdict(list)
    for ev in obs.ring_events():
        if ev.get("kind") == "span" and ev.get("name") == name:
            by[int(ev.get("bucket", ev.get("rows", 0)))].append(ev["dur_s"])
    return {str(b): quantiles_ms(v) for b, v in sorted(by.items())}


def replica_buckets(name) -> dict:
    from repro_torch import obs
    by = collections.defaultdict(set)
    for ev in obs.ring_events():
        if ev.get("kind") == "span" and ev.get("name") == name:
            by[ev.get("replica")].add(int(ev.get("bucket", ev["rows"])))
    return by


def closed_loop(svc, reqs, clients, score=None):
    """``clients`` threads each submitting and waiting for their slice of
    ``reqs`` in turn; returns (wall s, {index: result}, per-request e2e
    seconds, errors)."""
    import threading
    score = score or (lambda i: svc.score(reqs[i], timeout=300))
    results, e2e, errors = {}, {}, []

    def client(k):
        for i in range(k, len(reqs), clients):
            t0 = time.perf_counter()
            try:
                results[i] = score(i)
            except Exception as e:      # counted and raised below
                errors.append(e)
            e2e[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, results, list(e2e.values()), errors


def run_serve(x_np, centers, m, seed, device) -> dict:
    """Phase 5b: `ScoringService` over `Scorer` replicas on the card,
    at the KDD99-like fit's centers: closed-loop runs at 1, 4 and 16
    clients with 1 then 2 replicas (p50/p99 of ``span.serve.assign`` per
    bucket, of ``serve.request`` and of the clients' own submit-to-result
    times; records/s; each replica's shape count equal to the buckets it
    used), the ``coalesce=False`` ablation (240 requests at 16 clients),
    and the shed policy under bursts; every response held against
    `make_assigner` at its version (`label_ties`)."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.serve import (CenterSnapshot, Rejected, Scorer,
                                   ScoringService, ServiceConfig,
                                   make_assigner)
    reqs = serve_pool(x_np, SERVE_REQS, seed + 14)
    ref = make_assigner(centers, m=m, backend="hopper", device=device)
    cdev = torch.as_tensor(centers, device=device)
    want = [ref(r).cpu().numpy() for r in reqs]

    def fresh(n_rep, **kw):
        cfg = dict(max_batch_rows=SERVE_MAX_BATCH, bucket_base=SERVE_BASE)
        cfg.update(kw)
        return ScoringService(
            [Scorer(CenterSnapshot(0, centers), m=m, backend="hopper",
                    replica=f"r{i}", device=device) for i in range(n_rep)],
            ServiceConfig(**cfg))

    def hold(results, idx, what):
        ties = 0
        for i in idx:
            res = results[i]
            if res.version != 0:
                raise AssertionError(f"{what}: version {res.version}")
            ties += label_ties(res.assignments, want[i],
                               torch.from_numpy(reqs[i]).to(device), cdev)
        return ties

    obs.set_ring_size(1 << 16)
    rec = {"phase": "serve", "run": "kdd99_like", "c": int(centers.shape[0]),
           "d": int(centers.shape[1]), "m": m, "requests": SERVE_REQS,
           "sizes": sorted({int(r.shape[0]) for r in reqs}),
           "max_batch_rows": SERVE_MAX_BATCH, "bucket_base": SERVE_BASE,
           "runs": []}
    with fresh(1) as warm:                 # every bucket once
        for b in warm.buckets:
            warm.score(np.asarray(x_np[:b]), timeout=300)
    for n_rep in (1, 2):
        for clients in SERVE_CLIENTS:
            svc = fresh(n_rep)
            obs.reset_all()
            wall, results, e2e, errors = closed_loop(svc, reqs, clients)
            svc.close()
            if errors or len(results) != len(reqs):
                raise AssertionError(f"serve: {errors[:3]}")
            snap = obs.metrics_snapshot()
            req_h = snap["histograms"]["serve.request"]
            used = replica_buckets("serve.assign")
            counts = svc.compile_counts()
            if any(counts[r] != len(used.get(r, ())) for r in counts):
                raise AssertionError(f"serve: shapes {counts} for buckets "
                                     f"{dict(used)}")
            rows = sum(int(r.shape[0]) for r in reqs)
            rec["runs"].append({
                "replicas": n_rep, "clients": clients, "wall_s": wall,
                "records_per_s": rows / wall,
                "requests_per_s": len(reqs) / wall,
                "assign_by_bucket": span_buckets("serve.assign"),
                "serve_request": {"p50_ms": req_h["p50"] * 1e3,
                                  "p99_ms": req_h["p99"] * 1e3,
                                  "count": req_h["count"]},
                "client_e2e": quantiles_ms(e2e),
                "dispatches": int(sum(
                    v for k, v in snap["counters"].items()
                    if k.startswith("serve.batches"))),
                "shape_counts": counts,
                "buckets_used": {k: sorted(v) for k, v in used.items()},
                "ties_differing": hold(results, range(len(reqs)),
                                       f"{n_rep} replicas, {clients} "
                                       "clients")})
    # -- the coalesce=False ablation: one request, one dispatch
    svc = fresh(1, coalesce=False)
    obs.reset_all()
    sub = list(range(SERVE_PER_REQ))
    wall, results, e2e, errors = closed_loop(
        svc, reqs[:SERVE_PER_REQ], SERVE_CLIENTS[-1])
    svc.close()
    if errors:
        raise AssertionError(f"serve ablation: {errors[:3]}")
    rows = sum(int(reqs[i].shape[0]) for i in sub)
    rec["per_request"] = {
        "requests": SERVE_PER_REQ, "clients": SERVE_CLIENTS[-1],
        "wall_s": wall, "records_per_s": rows / wall,
        "assign_by_rows": span_buckets("serve.assign"),
        "client_e2e": quantiles_ms(e2e),
        "shape_counts": svc.compile_counts(),
        "ties_differing": hold(results, sub, "coalesce=False")}
    same = [r for r in rec["runs"] if r["replicas"] == 1
            and r["clients"] == SERVE_CLIENTS[-1]][0]
    rec["coalesced_over_per_request"] = (same["records_per_s"]
                                         / rec["per_request"]["records_per_s"])
    # -- the shed policy: bursts of 8 x 256 rows from 32 clients against
    #    a 4096-row queue; every rejection typed, the queue bounded
    svc = fresh(1, queue_rows=SHED_QUEUE_ROWS, policy="shed")
    obs.reset_all()
    burst = np.ascontiguousarray(x_np[:SHED_ROWS])
    outcomes = collections.Counter()

    def burst_client(i):
        futs = []
        for _ in range(SHED_BURST):
            try:
                futs.append(svc.submit(burst))
            except Rejected as e:
                if e.limit_rows != SHED_QUEUE_ROWS:
                    raise
                outcomes["shed"] += 1
        for f in futs:
            f.result(300)
            outcomes["served"] += 1
        return len(futs)

    wall, _, _, errors = closed_loop(svc, list(range(SHED_CLIENTS * 4)),
                                     SHED_CLIENTS, score=burst_client)
    svc.close()
    if errors:
        raise AssertionError(f"shed: untyped failures {errors[:3]}")
    q_max = obs.gauge("serve.queue_rows").max
    if q_max > SHED_QUEUE_ROWS or obs.counter("serve.shed").value != \
            outcomes["shed"]:
        raise AssertionError(f"shed: queue rows reached {q_max}, "
                             f"{dict(outcomes)}")
    rec["shed"] = {"queue_rows": SHED_QUEUE_ROWS, "burst": SHED_BURST,
                   "rows": SHED_ROWS, "clients": SHED_CLIENTS,
                   "submitted": SHED_CLIENTS * 4 * SHED_BURST,
                   **dict(outcomes), "queue_rows_max": q_max,
                   "wall_s": wall,
                   "assign_by_bucket": span_buckets("serve.assign")}
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    return rec


def run_live_serve(x_np, seed, device) -> dict:
    """The live path of the stream phase: a fresh ``kdd99_stream`` model
    (`StreamConfig` as `run_kdd99_stream`'s) wired through
    ``add_snapshot_listener(publisher.publish)`` to a `SnapshotPublisher`
    whose replicas serve a `ScoringService` (two replicas).  Each batch
    is submitted in 4096-row requests, then the next batch is ingested
    while they are scored (a publish mid-traffic); every response's
    version must be a published one and its labels that version's
    `make_assigner` labels, up to ties."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.data import replay_source
    from repro_torch.serve import (CenterSnapshot, Scorer, ScoringService,
                                   ServiceConfig, SnapshotPublisher,
                                   make_assigner)
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    n, d = x_np.shape
    cfg = StreamConfig(n_clusters=23, m=1.2, seed=seed, backend="hopper")
    model = StreamingBigFCM(cfg, device=device)
    svc = ScoringService(
        [Scorer(CenterSnapshot(-1, np.zeros((1, d), np.float32)), m=cfg.m,
                backend="hopper", replica=f"live{i}", device=device)
         for i in range(2)],
        ServiceConfig(max_batch_rows=SERVE_MAX_BATCH, bucket_base=SERVE_BASE))
    published = {}
    model.add_snapshot_listener(
        lambda v, c, w: published.__setitem__(int(v), c.copy()))
    pub = SnapshotPublisher(svc.scorers)
    model.add_snapshot_listener(pub.publish)
    obs.reset_all()
    obs.set_ring_size(1 << 16)
    pending, versions, ties, rows = [], collections.Counter(), 0, 0
    t0 = time.perf_counter()

    def drain(batch):
        nonlocal ties, rows
        for x, fut in batch:
            res = fut.result(300)
            if res.version not in published:
                raise AssertionError(f"live: version {res.version} was "
                                     "never published")
            versions[res.version] += 1
            c = torch.as_tensor(published[res.version], device=device)
            want = make_assigner(c, m=cfg.m, backend="hopper",
                                 device=device)(x).cpu().numpy()
            ties += label_ties(res.assignments, want,
                               torch.from_numpy(x).to(device), c)
            rows += x.shape[0]

    for chunk in replay_source(x_np, STREAM_ROWS):
        model.ingest(chunk)                # publishes while `pending` runs
        drain(pending)
        pending = [(r, svc.submit(r)) for r in
                   (np.ascontiguousarray(chunk[i:i + SERVE_MAX_BATCH])
                    for i in range(0, chunk.shape[0], SERVE_MAX_BATCH))]
    drain(pending)
    wall = time.perf_counter() - t0
    svc.close()
    steps = int(model.state.step)
    if rows != n or len(published) != steps:
        raise AssertionError(f"live: {rows} rows scored, {len(published)} "
                             f"versions for {steps} ingests")
    rec = {"phase": "stream", "run": "kdd99_live", "ingests": steps,
           "rows_scored": rows, "wall_s": wall,
           "versions_answered": len(versions),
           "responses_on_older_version": sum(
               v for k, v in versions.items() if k < max(versions)),
           "ties_differing": ties,
           "assign_by_bucket": span_buckets("serve.assign"),
           "snapshots": obs.counter("serve.snapshots").value}
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    return rec


# The tenant service: benchmarks/t16_tenant.py's widths over
# tenants_65k's fitted fleet; requests of 8-64 rows from 4096 random
# tenants, one firehose tenant sending half of all rows.
TENANT_SVC_TENANTS, TENANT_SVC_ROWS, TENANT_SVC_CAP = 4096, (8, 65), 512
TENANT_SVC_CLIENTS, TENANT_FIREHOSE_ROWS = 16, 64


class FirehoseCounter:
    """Wraps a `TenantScorer`'s ``score`` to count, per dispatch, the
    real rows (phantom padding rows are exact zeros) and the firehose
    tenant's."""

    def __init__(self, scorer, fire_row):
        self.fire_row, self.shares = fire_row, []
        inner = scorer.score

        def score(x, tidx, snap=None):
            import numpy as np
            real = np.asarray(x).any(1)
            self.shares.append((int(real.sum()),
                                int((real & (np.asarray(tidx)
                                             == fire_row)).sum())))
            return inner(x, tidx, snap)
        scorer.score = score


def run_tenant_service(ts, refit, seed, device) -> dict:
    """`TenantScoringService` over the fitted fleet (version 1) with a
    swap to the refit fleet (version 2) when half the requests are
    answered: each response's version must be its tenant's in one of the
    two fleets and its labels that fleet's, up to ties; p50/p99 of
    ``span.tenant.assign`` per bucket, and the firehose tenant's rows
    per dispatch (capped at ``max_group_rows``)."""
    import threading
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.serve import (ServiceConfig, TenantScorer,
                                   TenantScoringService, tenant_snapshot)
    rng = np.random.default_rng(seed + 16)
    fleets = {1: ts._replace(versions=np.full(ts.n_tenants, 1, np.int64)),
              2: refit._replace(versions=np.full(ts.n_tenants, 2, np.int64))}
    snaps = {v: tenant_snapshot(f, device) for v, f in fleets.items()}
    quiet = rng.choice(np.arange(1, ts.n_tenants), TENANT_SVC_TENANTS,
                       replace=False)
    fire = int(rng.integers(1, ts.n_tenants))
    reqs = [(int(t), int(rng.integers(*TENANT_SVC_ROWS))) for t in quiet]
    quiet_rows = sum(k for _, k in reqs)
    reqs += [(fire, TENANT_FIREHOSE_ROWS)] * (quiet_rows
                                              // TENANT_FIREHOSE_ROWS)
    order = rng.permutation(len(reqs))
    reqs = [reqs[i] for i in order]
    xs = [(rng.normal(size=(k, TENANT_D)) + 4.0 * (t % 5)).astype(np.float32)
          for t, k in reqs]
    tidx = np.concatenate([np.full(k, t) for t, k in reqs])
    x_all = torch.from_numpy(np.concatenate(xs)).to(device)
    want = {v: TenantScorer(s, device=device).score(x_all, tidx).cpu().numpy()
            for v, s in snaps.items()}
    offs = np.concatenate([[0], np.cumsum([k for _, k in reqs])])
    scorer = TenantScorer(snaps[1], device=device)
    counter = FirehoseCounter(scorer, fire)
    svc = TenantScoringService(scorer, ServiceConfig(
        max_batch_rows=SERVE_MAX_BATCH, bucket_base=SERVE_BASE,
        max_group_rows=TENANT_SVC_CAP))
    obs.reset_all()
    obs.set_ring_size(1 << 16)
    answered, half = [0], threading.Event()

    def score(i):
        res = svc.score(str(fleets[1].ids[reqs[i][0]]), xs[i], timeout=300)
        answered[0] += 1
        if answered[0] >= len(reqs) // 2:
            half.set()
        return res

    def swapper():
        half.wait(300)
        svc.swap(snaps[2])

    th = threading.Thread(target=swapper)
    th.start()
    wall, results, e2e, errors = closed_loop(svc, reqs, TENANT_SVC_CLIENTS,
                                             score=score)
    th.join()
    svc.close()
    if errors or len(results) != len(reqs):
        raise AssertionError(f"tenant service: {errors[:3]}")
    versions, ties = collections.Counter(), 0
    for i, res in results.items():
        if res.version not in want:
            raise AssertionError(f"tenant service: version {res.version}")
        versions[res.version] += 1
        sl = slice(offs[i], offs[i + 1])
        got, exp = res.assignments, want[res.version][sl]
        bad = np.flatnonzero(got != exp)
        if bad.size:
            c = fleets[res.version].centers[reqs[i][0]]
            d2 = ((xs[i][bad, None, :] - c[None]) ** 2).sum(-1)
            r = np.arange(bad.size)
            ga, wa = d2[r, got[bad]], d2[r, exp[bad]]
            if np.any(np.abs(ga - wa) > 1e-6 * np.maximum(ga, wa)):
                raise AssertionError("tenant service: labels differ beyond "
                                     "a tie")
            ties += int(bad.size)
    shares = [(r, f) for r, f in counter.shares if r]
    fire_rows = [f for _, f in shares]
    if max(fire_rows) > TENANT_SVC_CAP or versions[2] == 0:
        raise AssertionError(f"tenant service: firehose rows {max(fire_rows)}"
                             f" in a dispatch, versions {dict(versions)}")
    frac = [f / r for r, f in shares]
    rec = {"tenants": ts.n_tenants, "quiet_tenants": TENANT_SVC_TENANTS,
           "requests": len(reqs), "rows": int(offs[-1]),
           "firehose_rows": int(sum(k for t, k in reqs if t == fire)),
           "max_group_rows": TENANT_SVC_CAP, "clients": TENANT_SVC_CLIENTS,
           "wall_s": wall, "records_per_s": int(offs[-1]) / wall,
           "responses_by_version": dict(versions),
           "labels_differing_between_fleets": int(
               (want[1] != want[2]).sum()),
           "ties_differing": ties, "dispatches": len(shares),
           "firehose_share_per_dispatch": {
               "min": float(min(frac)), "p50": float(np.median(frac)),
               "max": float(max(frac)), "max_rows": int(max(fire_rows))},
           "assign_by_bucket": span_buckets("tenant.assign"),
           "client_e2e": quantiles_ms(e2e),
           "shape_count": scorer.traces}
    obs.reset_all()
    obs.set_ring_size(obs.trace._ring_size())
    return rec


def bound_batched(t: int, n: int, d: int, c: int):
    """(ms, what sets it) for one tenant-stacked sweep: the (T, N, d)
    block, its (T, N) weights, V and m read once, the outputs written
    once, against 4·T·N·C·d f32 flops."""
    nbytes = 4 * (t * n * (d + 1) + 2 * t * c * d + t * c + 2 * t)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * t * n * c * d / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_line(per_run) -> list:
    """One entry per kernel: its launches summed over the main-path
    runs, its worst error, and the numbers (and source file) of the shape
    with the most work (the largest bound) on top; every (run, shape)'s
    numbers, path and source under ``runs``."""
    entries = {}
    for e in per_run:
        name = e["name"] + ("_ctiled" if e["path"] == "ctiled" else "")
        entries.setdefault(name, []).append(e)
    out = []
    for name, runs in entries.items():
        top = max(runs, key=lambda e: e["bound_ms"])
        for e in runs:
            e["source"] = f"{CSRC}/{PATH_SOURCE[e['name'], e['path']]}.cu"
        out.append({
            "name": name, "route": "cuda", "source": top["source"],
            "replaces": REPLACES[top["name"]],
            "launches": sum(e["launches"] for e in runs),
            "max_abs_err": max(e["max_abs_err"] for e in runs),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"), "at": top["run"],
            "runs": {e["run"]: {k: e[k] for k in (
                "launches", "max_abs_err", "ms", "ms_per_call", "plain_ms",
                "bound_ms", "bound_by", "bound_share", "shape", "path",
                "source", "dsplits", "launch_ms", "member_library_ms",
                "contraction_library_ms", "fleet_launches") if k in e}
                for e in runs}})
    return out


def build_all() -> dict:
    """Build every kernel source at once (one ``nvcc`` each, in
    parallel), timed; returns each one's ptxas register/smem lines."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = dict(zip(SOURCES, pool.map(
            lambda name: build.compile_source(name, verbose=True), SOURCES)))
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "ptxas": {name: [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "smem" in ln]
                      for name, log in logs.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    device = torch.device("cuda", 0)
    emit({"phase": "device", "nvidia_smi": nvidia_smi(),
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    stores = ROOT / "build"
    stores.mkdir(exist_ok=True)
    # The calibration sandbox: no earlier run's winners or tuned plans
    # change a plan here.
    calib_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_calib_",
                                      dir=stores))
    os.environ["REPRO_CALIB_DIR"] = str(calib_dir)
    try:
        return run_all(args, device)
    finally:
        shutil.rmtree(calib_dir, ignore_errors=True)


def run_all(args, device) -> int:
    """Phases 1 (the build) to 7, in the calibration sandbox."""
    import torch
    emit(build_all())

    emit(check_kernels(device))
    emit(check_tenant_kernels(device))
    emit(check_ctiled_kernels(device))
    torch.cuda.empty_cache()
    emit(run_calibrate(device))
    torch.cuda.empty_cache()

    entries, held = [], {}
    for run in RUNS:
        got, held[run.name] = run_main_path(run, run.n, args.seed, device,
                                            reps=20)
        entries += got
        torch.cuda.empty_cache()
    entries += run_router_fit(args.seed, device, reps=20)
    for run in TENANT_RUNS:
        entries.append(run_tenant_path(run, args.seed, device, reps=20))
        torch.cuda.empty_cache()
    stores = ROOT / "build"
    store_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_stores_",
                                      dir=stores))
    kdd_x = held["kdd99_like"]["x"]
    kdd_centers = held["kdd99_like"]["centers"]["hopper"].numpy()
    kdd_m = held["kdd99_like"]["cfg"].m
    try:
        for run in RUNS:
            run_held = held.pop(run.name)
            entries.append(run_store_path(run, run_held, store_dir, device))
            torch.cuda.empty_cache()
            if run.name == FLEET_RUN:
                entries += run_fleet_path(run, run_held, held["kdd99_like"],
                                          store_dir, entries, device)
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    emit(run_serve(kdd_x, kdd_centers, kdd_m, args.seed, device))
    torch.cuda.empty_cache()
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_", dir=stores))
    try:
        entries += run_stream_path(kdd_x, args.seed, device, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    emit({"kernels": kernel_line(entries),
          "library_note": "no single PyTorch call computes the FCM sweep, "
                          "single-model or tenant-stacked"})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
