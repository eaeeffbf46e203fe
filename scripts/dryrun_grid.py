#!/usr/bin/env python3
"""Run the port's dry run over the whole grid — 10 archs × 4 shapes ×
{16×16, 2×16×16} × {"tp", "fsdp"}, 160 cells — in parallel processes,
then print one line a cell.

Each process is ``python -m repro_torch.launch.dryrun --arch A --shape
all --multi-pod both --profile P`` on one torch thread (fake tensors:
nothing runs on a card), writing its records into ``--out-dir``; the
summary is printed as a Markdown table and written to
``<out-dir>/summary.md`` (``python -m benchmarks.roofline_table --dir
<out-dir>`` renders the records too).

  PYTHONPATH=src python scripts/dryrun_grid.py --out-dir results/dryrun_torch
  PYTHONPATH=src python scripts/dryrun_grid.py --device cpu --jobs 4
  PYTHONPATH=src python scripts/dryrun_grid.py --profile fsdp   # 80 cells

Exits 1 when a cell is an "error" (the table names it and its reason).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def run_one(arch: str, profile: str, out_dir: str, device: str) -> tuple:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "all", "--multi-pod", "both", "--profile", profile,
         "--device", device, "--out-dir", out_dir],
        env=env, cwd=ROOT, capture_output=True, text=True)
    return arch, profile, res.returncode, time.perf_counter() - t0


def line(r: dict) -> str:
    head = f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['profile']} |"
    if r["status"] == "skipped":
        return head + " skipped |" + " — |" * 10
    if r["status"] != "ok":
        peak = r.get("peak_bytes_per_rank")
        return (head + f" error: {r['error'][:90]} |"
                + (f" {r['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f} |"
                   f" {peak / 1e9:.3f} |" if peak else " — | — |")
                + " — |" * 8)
    ro, mem = r["roofline"], r["memory_analysis"]
    coll = ", ".join(f"{k} {v / 1e9:.4g}" for k, v in
                     ro["coll_breakdown"].items() if v)
    return (head + f" ok | {mem['argument_size_in_bytes'] / 1e9:.3f} |"
            f" {r['peak_bytes_per_rank'] / 1e9:.3f} |"
            f" {ro['flops_per_dev']:.4g} | {coll or '—'} |"
            f" {ro['t_compute_s']:.4g} | {ro['t_memory_s']:.4g} |"
            f" {ro['t_collective_s']:.4g} | {ro['bottleneck']} |"
            f" {ro['mfu_bound']:.4g} | {r['t_lower_s']:.1f} |"
            f" {r['compiled_cost']['flops']:.4g} |")


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile", default="both",
                    choices=["tp", "fsdp", "both"])
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    profiles = ("tp", "fsdp") if args.profile == "both" else (args.profile,)
    tasks = [(arch, profile) for profile in profiles for arch in ARCHS]
    # the largest configs first, so that the pool ends together
    tasks.sort(key=lambda t: t[0] not in ("kimi-k2-1t-a32b", "zamba2-7b",
                                          "pixtral-12b", "stablelm-12b"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda t: run_one(*t, args.out_dir,
                                               args.device), tasks))
    recs = []
    for path in sorted(glob.glob(os.path.join(args.out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"],
                             r["profile"]))
    out = ["| arch | shape | mesh | profile | status | argument GB/rank |"
           " peak GB/rank | FLOPs/rank | collective GB/rank by kind |"
           " t_compute s | t_memory s | t_collective s | bottleneck |"
           " mfu_bound | trace s | counted FLOPs/rank |", "|" + "---|" * 16]
    out += [line(r) for r in recs]
    counts = {s: sum(r["status"] == s for r in recs)
              for s in ("ok", "skipped", "error")}
    out.append("")
    out.append(f"{len(recs)} records: {counts}; wall "
               f"{time.perf_counter() - t0:.1f} s over {args.jobs} "
               f"processes; per process (arch, profile, exit, s): {done}")
    text = "\n".join(out)
    print(text)
    with open(os.path.join(args.out_dir, "summary.md"), "w") as f:
        f.write(text + "\n")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
