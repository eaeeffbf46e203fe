#!/usr/bin/env python3
"""The stream phase's two questions of conditioning, on one NVIDIA card:

    python3 scripts/stream_witness.py [--kdd-branch fcm|wfcmpb]
                                      [--split-shifts S ...] [--seed N]

``--kdd-branch`` runs chip_smoke.py's ``kdd99_stream`` (every ingest held
against its float32 and float64 ``torch`` twins, `StreamRun.hold_step`)
with the first ingest's driver race forced to that branch, instead of
the wall clock's choice.  ``--split-shifts`` runs ``drift_split`` free
(no twins) at each shift through ``hopper``, ``torch`` in float32 and
``torch`` in float64, the driver race forced to its FCM branch, and
prints each run's re-seeds, births, deaths and the steps they fell on.
JSON lines, then the card's ``nvidia-smi`` name and power limit.  Exits
1 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def forced_pin(flag: bool):
    """A `chip_smoke.DriverPin` whose race keeps ``flag``'s branch (True:
    FCM, False: WFCMPB) from the same sample and seeds."""
    import chip_smoke as cs

    class Forced(cs.DriverPin):
        def __call__(self, x_sample, cfg, *, seed_idx, device):
            if self.mode != "record":
                return super().__call__(x_sample, cfg, seed_idx=seed_idx,
                                        device=device)
            self.flag, self.races, self.mode = flag, self.races + 1, "replay"
            try:
                return super().__call__(x_sample, cfg, seed_idx=seed_idx,
                                        device=device)
            finally:
                self.mode = "record"
    return Forced()


def free_split(run, chunks, seed, backend, exact) -> dict:
    """One free ``drift_split`` run: its structural events."""
    import chip_smoke as cs
    from repro_torch.stream import StreamConfig, StreamingBigFCM
    cfg = StreamConfig(n_clusters=cs.DRIFT_C, m=2.0, seed=seed,
                       backend=backend, **dict(run.cfg))
    with cs.float64() if exact else contextlib.nullcontext():
        model = StreamingBigFCM(cfg, device="cuda")
        reps = model.run(chunks)
    st = model.state
    return {"reseeds": int(st.reseeds), "births": int(st.births),
            "deaths": int(st.deaths),
            "events": [[r.step, r.reason, r.born, r.died, r.n_centers]
                       for r in reps if r.reason or r.born or r.died]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kdd-branch", choices=("fcm", "wfcmpb"))
    ap.add_argument("--split-shifts", type=float, nargs="*", default=())
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("stream_witness: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    cs.emit(cs.build_all())
    if args.kdd_branch:
        from repro_torch.data import synth
        x, _ = synth.make_kdd_like(4_898_431, seed=args.seed)
        (ROOT / "build").mkdir(exist_ok=True)
        ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_",
                                     dir=ROOT / "build"))
        pin = forced_pin(args.kdd_branch == "fcm")
        try:
            cs.run_kdd99_stream(x, args.seed, device, ckpt, pin)
        finally:
            pin.close()
            shutil.rmtree(ckpt, ignore_errors=True)
        del x
        torch.cuda.empty_cache()
    pin = forced_pin(True)
    try:
        for shift in args.split_shifts:
            run = dataclasses.replace(cs.DRIFT_RUNS[1], shift=shift)
            chunks = cs.drift_chunks(run, args.seed)
            out = {"run": "drift_split", "shift": shift}
            for name, backend, exact in (("hopper", "auto", False),
                                         ("torch_f32", "torch", False),
                                         ("torch_f64", "torch", True)):
                out[name] = free_split(run, chunks, args.seed, backend,
                                       exact)
            print(json.dumps(out), flush=True)
    finally:
        pin.close()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
