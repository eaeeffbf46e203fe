#!/usr/bin/env python3
"""Time the port's FCM sweep kernels at every shape the four runs of
chip_smoke.py launch them at, for one checkout of `repro_torch`, on one
NVIDIA card:

    python3 scripts/compare_kernels.py [--src DIR] [--label NAME]

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
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import fcm_update as F
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def emit(kernel, run, shape, ms, per_call):
        print(json.dumps({"label": args.label, "kernel": kernel, "run": run,
                          "shape": shape, "ms": ms, "ms_per_call": per_call}),
              flush=True)

    for kernel, run, n, d, c, m in SINGLE:
        x = torch.randn((n, d), generator=g, device=dev)
        w = torch.rand((n,), generator=g, device=dev) + 0.5
        v = torch.randn((c, d), generator=g, device=dev)
        fn = getattr(F, kernel + "_cuda")
        emit(kernel, run, [n, d, c],
             *timed(lambda: fn(x, w, v, m), 20 if n > 1 << 20 else 500))
        del x, w
        torch.cuda.empty_cache()
    for run, t, n in BATCHED:
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
