#!/usr/bin/env python3
"""Where a single-device BigFCM fit of the port spends its time on the card.

Runs `repro_torch.core.bigfcm_fit` on backend "auto" at the sizes of
`chip_smoke.py`'s runs, once with a host clock only and once under
`torch.profiler`, and prints one JSON line per run:

- ``wall_s`` — the unprofiled fit, host clock, card synchronized;
- ``driver_s`` — the driver race (warm-up and timed runs of FCM and of
  WFCMPB on the sample, from the fit's own diagnostics);
- ``device_busy_s`` / ``idle_share`` — the union of the device's kernel
  and copy intervals in the profiled fit, against that fit's wall time
  (the profiler adds host overhead, so the profiled wall is reported too);
- ``kernels`` — device time and count by kernel name.

    python3 scripts/profile_torch_fit.py [--runs higgs_like,kdd99_like] [--seed 0]

Needs one NVIDIA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _busy_seconds(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total * 1e-6          # profiler times are microseconds


def profile_run(run, seed: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import BigFCMConfig, bigfcm_fit
    from repro_torch.data import synth

    x_np, _ = getattr(synth, run.maker)(run.n, seed=seed)
    x = torch.from_numpy(x_np).cuda()
    del x_np
    cfg = BigFCMConfig(n_clusters=run.c, m=run.m, combiner_eps=run.eps,
                       reducer_eps=run.eps, max_iter=1000,
                       sample_size=min(3184, run.n), seed=seed)

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bigfcm_fit(x, cfg, device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    fit()                                   # builds and loads the kernel
    res, wall = fit()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = fit()
    intervals, by_name = [], defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            intervals.append((ev.time_range.start, ev.time_range.end))
            by_name[ev.name][0] += ev.time_range.elapsed_us() * 1e-3
            by_name[ev.name][1] += 1
    busy = _busy_seconds(intervals)
    d = res.diagnostics
    return {
        "run": run.name, "n": run.n, "c": run.c, "wall_s": wall,
        "driver_s": 2 * (d.t_fcm_driver + d.t_wfcmpb_driver),
        "flag": d.flag, "combiner_iters": list(d.combiner_iters),
        "reducer_iters": d.reducer_iters, "wall_profiled_s": wall_prof,
        "device_events": len(intervals), "device_busy_s": busy,
        "idle_share": (1.0 - busy / wall_prof) if intervals else None,
        "kernels": {k: {"ms": v[0], "count": v[1]} for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])[:8]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="higgs_like,kdd99_like")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_fit: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import RUNS, nvidia_smi
    print(nvidia_smi(), flush=True)
    wanted = args.runs.split(",")
    for run in RUNS:
        if run.name in wanted:
            print(json.dumps(profile_run(run, args.seed)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
