#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BigFCM (`src/repro_torch`) on one NVIDIA
card and check it.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

Phases, each printed as JSON lines; any failure raises and exits non-zero:

1. device  — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the ``nvcc`` build of every kernel from the
   checkout's sources, timed.
2. kernels — the Hopper FCM kernel against its plain PyTorch version on
   the card: every shape of tests/test_kernels.py for m in
   {1.05, 1.2, 2.0, 3.0} at that file's tolerances, chunk additivity,
   and bitwise determinism of two launches.  Then the inputs the driver
   race gives it at each run's d, C and m: the 3184-row sample, WFCMPB's
   last 2048-row block with zero-weight phantom rows, and WFCMPB's first
   2·C-point merge, whose running half has zero mass.
3. main path — `bigfcm_fit` on backend "auto" at the paper's dataset
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
4. the kernels line, the ``nvidia-smi`` line, and the final
   ``{"ok": true, ...}`` line.

Bounds use an H100 SXM's published peaks at 700 W: 3.35 TB/s of device
memory and 67 TFLOP/s of f32 outside the tensor cores.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
SOURCE = "src/repro_torch/kernels/csrc/fcm_accumulate.cu"
REPLACES = {"fcm_sweep": "src/repro/kernels/fcm_update.py:152",
            "fcm_accumulate": "src/repro/kernels/fcm_update.py:40"}

# tests/test_kernels.py: SHAPES (sweep atol 3e-5) and OFF_LANE_SHAPES
# (atol 3e-4); the raw accumulators at atol 3e-3; rtol 3e-4 throughout.
SHAPES = [(64, 2, 2), (100, 130, 7), (257, 4, 3), (1000, 18, 10),
          (2048, 28, 50), (31, 41, 23), (512, 8, 129)]
OFF_LANE_SHAPES = [(300, 130, 131), (200, 129, 140), (96, 257, 129),
                   (513, 131, 200)]
M_SWEEP = (1.05, 1.2, 2.0, 3.0)
RTOL, SWEEP_ATOL, OFF_LANE_ATOL, ACC_ATOL = 3e-4, 3e-5, 3e-4, 3e-3
SAMPLE_SIZE, BLOCK_SIZE = 3184, 2048    # the driver's λ; WFCMPB's block


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
    two warm-up calls."""
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


def bound(n: int, d: int, c: int):
    """(ms, what sets it): each input read once, each output written
    once, against 4·N·C·d f32 flops (the two contractions)."""
    nbytes = 4 * (n * (d + 1) + c * d + c * d + c + 1)
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


def run_main_path(run: Run, n: int, seed: int, device, reps: int):
    """Phase 3 for one dataset: the main path with counted launches, the
    hopper-vs-torch comparison at full size, and the per-kernel checks
    and times.  Returns (phase record, kernel entries)."""
    import numpy as np
    import torch
    from repro_torch.core import BigFCMConfig, bigfcm_fit
    from repro_torch.data import synth
    from repro_torch.device import synchronize
    from repro_torch.engine import get_backend, resolve_backend
    from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                                fcm_accumulate_ref,
                                                fcm_sweep_cuda, fcm_sweep_ref)

    t0 = time.perf_counter()
    x_np, _ = getattr(synth, run.maker)(n, seed=seed)
    x = torch.from_numpy(x_np).to(device)
    del x_np
    n, d = x.shape
    if d != run.d:
        raise AssertionError(f"{run.maker} gave d={d}, expected {run.d}")
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    cfg = BigFCMConfig(n_clusters=run.c, m=run.m, combiner_eps=run.eps,
                       reducer_eps=run.eps, max_iter=1000,
                       sample_size=min(SAMPLE_SIZE, n),
                       block_size=BLOCK_SIZE, seed=seed)
    backend = resolve_backend(cfg.backend, device=device).name
    if device.type == "cuda" and backend != "hopper":
        raise AssertionError(f"'auto' resolved to {backend!r} on the card")

    # -- the main path, with launch counts zeroed just before it
    fcm_sweep_cuda.launches = fcm_accumulate_cuda.launches = 0
    synchronize(device)
    t0 = time.perf_counter()
    res = bigfcm_fit(x, cfg, device=device)
    _, _, q = get_backend("hopper_accumulate").accumulate(
        x, ones, res.centers, run.m)
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"fcm_sweep": fcm_sweep_cuda.launches,
                "fcm_accumulate": fcm_accumulate_cuda.launches}
    if device.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if res.centers.shape != (run.c, d) or not (
            bool(torch.isfinite(res.centers).all()) and math.isfinite(float(q))):
        raise AssertionError("main path gave non-finite or mis-shaped output")
    diag = res.diagnostics
    record = {"phase": "main_path", "run": run.name, "n": n, "d": d,
              "c": run.c, "m": run.m, "eps": run.eps, "backend": backend,
              "setup_s": setup_s, "wall_s": wall, "flag": diag.flag,
              "t_fcm_driver_s": diag.t_fcm_driver,
              "t_wfcmpb_driver_s": diag.t_wfcmpb_driver,
              "combiner_iters": list(diag.combiner_iters),
              "reducer_iters": diag.reducer_iters, "global_q": float(q),
              "launches": launches}

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

    # -- each kernel entry vs its plain version at this shape, and timed
    v = res.centers
    b_ms, b_by = bound(n, d, run.c)
    entries = []
    for kname, kern, plain, atol in (
            ("fcm_sweep", fcm_sweep_cuda, fcm_sweep_ref, SWEEP_ATOL),
            ("fcm_accumulate", fcm_accumulate_cuda, fcm_accumulate_ref,
             ACC_ATOL)):
        got = kern(x, ones, v, run.m)
        if not all(torch.equal(a, b) for a, b in zip(
                got, kern(x, ones, v, run.m))):
            raise AssertionError(f"{kname}: two launches differ at {run.name}")
        want = plain(x, ones, v, run.m)
        err = max_err(got, want, RTOL, atol, f"{kname} at {run.name}")
        del want
        ms = time_ms(lambda: kern(x, ones, v, run.m), reps)
        plain_ms = time_ms(lambda: plain(x, ones, v, run.m), 3)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        entries.append({
            "name": f"{kname}@{run.name}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [n, d, run.c], "m": run.m})
    return entries


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
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    emit({"phase": "device", "nvidia_smi": nvidia_smi(),
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    log = build.compile_source("fcm_accumulate", verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "smem" in ln]})

    emit(check_kernels(device))

    entries = []
    for run in RUNS:
        entries += run_main_path(run, run.n, args.seed, device, reps=20)
        torch.cuda.empty_cache()

    emit({"kernels": entries,
          "library_note": "no single PyTorch call computes the FCM sweep"})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
