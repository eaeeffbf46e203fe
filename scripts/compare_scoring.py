#!/usr/bin/env python3
"""Time the port's scoring with d² in float32 and in float64 on one
NVIDIA card, at the KDD99-like sizes chip_smoke.py scores at:

    python3 scripts/compare_scoring.py [--seed S] [--turns T]

`hard_assign` / `soft_assign` form d² in float64 on a CUDA device
(`repro_torch.engine.backend._scoring_dtype`); the float32 leg patches
that choice back to the working type, which is the arithmetic scoring
used before.  The legs run in turns (f32, f64, f64, f32, ...) in one
process on the same inputs:

  * ``assign_store``: `assign_store` over a `ChunkStore` of the
    KDD99-like array (4,898,431 × 41 in 1,048,576-row chunks, C = 23,
    m = 1.2; backend ``hopper``), hard and soft, the host clock around
    the whole pass (chunk reads and copies included);
  * ``stream_labels``: the labels `assign_stream` computes per ingest —
    `StreamingBigFCM.assign`'s `hard_assign` — over the array's 19
    device-resident 262,144-row batches, the host clock around all 19
    and one synchronize.

Centers: the mixture's 23 component means.  Also prints how many of the
4,898,431 hard labels the two legs disagree on, and how many of those
differ by more than a tie.  Prints one JSON line per (leg, turn), a summary line, then the
card's ``nvidia-smi`` name and power limit.  The store lives under
``build/compare_scoring_*/`` and is deleted at the end.  Exits 1 without
a card.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N, D, C, M = 4_898_431, 41, 23, 1.2
STORE_ROWS, STREAM_ROWS = 1 << 20, 1 << 18


def centers_of(x, classes):
    """The mixture's component means: what a fit of this array reaches,
    23 distinct centers."""
    import torch
    lab = torch.as_tensor(classes, device=x.device, dtype=torch.long)
    sums = torch.zeros((C, D), dtype=torch.float64, device=x.device)
    sums.index_add_(0, lab, x.double())
    counts = torch.bincount(lab, minlength=C).clamp(min=1)
    return (sums / counts[:, None]).float()


def beyond_ties(a, b, x, centers) -> int:
    """Rows whose two labels differ by more than a tie: their exact
    (float64, direct) squared distances more than 1e-6 apart, relative —
    chip_smoke.py's `label_ties` rule."""
    import numpy as np
    import torch
    bad = np.flatnonzero(a != b)
    if not bad.size:
        return 0
    xs = x[torch.as_tensor(bad, device=x.device)].double()
    d2 = ((xs[:, None, :] - centers.double()[None]) ** 2).sum(-1)
    d2 = d2.cpu().numpy()
    rows = np.arange(bad.size)
    da, db = d2[rows, a[bad]], d2[rows, b[bad]]
    return int(np.sum(np.abs(da - db) > 1e-6 * np.maximum(da, db)))


def run_leg(dtype, store, batches, centers, device):
    import numpy as np
    import torch
    from repro_torch.engine import backend as eb
    from repro_torch.serve import assign_store
    saved = eb._scoring_dtype
    if dtype == "f32":
        eb._scoring_dtype = lambda x: eb.real_dtype()
    try:
        out = {"leg": dtype}
        for soft in (False, True):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            got = [a for a in assign_store(store, centers, m=M, soft=soft,
                                           backend="hopper", device=device)]
            out["store_soft_s" if soft else "store_hard_s"] = \
                time.perf_counter() - t0
            if not soft:
                labels = np.concatenate(got)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for b in batches:
            eb.hard_assign(b, centers)
        torch.cuda.synchronize(device)
        out["stream_labels_s"] = time.perf_counter() - t0
    finally:
        eb._scoring_dtype = saved
    return out, labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_scoring.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data import ChunkStore
    from repro_torch.data.synth import make_kdd_like
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    x_np, classes = make_kdd_like(N, seed=args.seed)
    x_np = np.ascontiguousarray(x_np, np.float32)
    x = torch.from_numpy(x_np).to(device)
    centers = centers_of(x, classes)
    batches = list(torch.split(x, STREAM_ROWS))
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="compare_scoring_",
                                dir=ROOT / "build"))
    try:
        store = ChunkStore.ingest(x_np, chunk_rows=STORE_ROWS,
                                  cache_dir=str(tmp / "store"))
        run_leg("f64", store, batches, centers, device)      # warm-up
        rows, labels = [], {}     # each leg's hard labels, last turn
        for turn in range(args.turns):
            for dtype in (("f32", "f64") if turn % 2 == 0
                          else ("f64", "f32")):
                rec, labels[dtype] = run_leg(dtype, store, batches, centers,
                                             device)
                rec["turn"] = turn
                rows.append(rec)
                print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = labels["f32"], labels["f64"]
    summary = {"rows": N, "labels_differing": int((a != b).sum()),
               "beyond_a_tie": beyond_ties(a, b, x, centers)}
    for key in ("store_hard_s", "store_soft_s", "stream_labels_s"):
        for dtype in ("f32", "f64"):
            vals = sorted(r[key] for r in rows if r["leg"] == dtype)
            summary[f"{key}_{dtype}"] = [vals[0], vals[-1]]
    print(json.dumps({"summary": summary}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
