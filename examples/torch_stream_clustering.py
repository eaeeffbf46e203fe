"""Streaming BigFCM on the PyTorch/CUDA port, with drift-triggered
re-seeding — and an out-of-order event-time feed.

Part 1 — a synthetic moving-cluster stream (`make_moving_blobs`):
mid-stream, every mixture component's mean jumps.  `StreamingBigFCM`
ingests the stream through the socket simulator, notices the regime
change on the first post-drift batch (the stale centers' objective
spikes), re-runs the paper's driver race to re-seed, zeroes its window,
and keeps serving — `serve.assign_stream` scores each chunk against the
freshest windowed centers while learning.  The run checkpoints
continuously and restores from disk to show a restart resumes the
stream.

Part 2 — the same records delivered OUT OF ORDER within a bounded skew
(`out_of_order_source`): with ``event_time=True`` summaries are routed
to window slots by event-time bucket, late summaries merge into their
slot through the engine accumulate entry, and a watermark trailing the
max event time by ``allowed_lateness`` bounds the disorder — nothing is
dropped and the model matches the in-order fit.

On a card the engine's "auto" backend runs the hand-written CUDA
kernels; the line "kernel launches" counts them by wrapper and plan path
(none on the CPU, where each wrapper takes its plain PyTorch version).

    PYTHONPATH=src python examples/torch_stream_clustering.py
    PYTHONPATH=src python examples/torch_stream_clustering.py --device cpu
"""
import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch.core.metrics import clustering_accuracy, fuzzy_objective
from repro_torch.data import (make_blobs, make_moving_blobs,
                              out_of_order_source, replay_source,
                              socket_sim_source)
from repro_torch.ft import CheckpointManager
from repro_torch.kernels.fcm_update import launches_by_path
from repro_torch.serve import assign_stream
from repro_torch.stream import StreamConfig, StreamingBigFCM

C, D, CHUNK, N_CHUNKS, DRIFT_AT = 5, 12, 4000, 12, 6


def objective(x, centers, m) -> float:
    return float(fuzzy_objective(
        torch.as_tensor(x, dtype=centers.dtype, device=centers.device),
        centers, m))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    # The engine config axis: ``backend`` picks the sweep implementation
    # ("auto" = the hand-written kernels on a card) and ``merge_plan`` the
    # window topology ("windowed" = the whole window collapses in ONE
    # WFCM accumulating raw per-slot sums in-kernel).
    cfg = StreamConfig(n_clusters=C, window=4, decay=0.9, max_iter=300,
                       driver_sample=512, backend="auto",
                       merge_plan="windowed", seed=0)
    model = StreamingBigFCM(cfg, device=dev)
    print(f"engine: backend={model.backend.name}  "
          f"window merge plan={cfg.merge_plan}")
    ckpt = CheckpointManager(tempfile.mkdtemp(prefix="repro_stream_ckpt_"))

    truth = {}   # chunk index -> labels (kept aside; never seen by the model)

    def chunks():
        gen = make_moving_blobs(N_CHUNKS, CHUNK, D, C, drift_at=DRIFT_AT,
                                shift=10.0, seed=4)
        for t, (x, y) in enumerate(gen):
            truth[t] = y
            yield x

    print(f"{N_CHUNKS} chunks x {CHUNK} records, means jump at chunk "
          f"{DRIFT_AT} -- watch q_pre\n")
    for t, (labels, rep) in enumerate(
            assign_stream(model, socket_sim_source(chunks(), rate_hz=50.0))):
        acc = clustering_accuracy(truth[t], labels, C)
        tag = (f"  << DRIFT ({rep.reason}) -> driver re-seed"
               if rep.drifted else "")
        print(f"chunk {rep.step:2d}: q_pre {rep.objective_pre:8.2f}  "
              f"q_post {rep.objective_post:7.2f}  shift {rep.shift:6.3f}  "
              f"acc {acc:.3f}{tag}")
        model.save(ckpt)

    ckpt.wait()
    print(f"\nre-seeds: {int(model.state.reseeds)}  window mass: "
          f"{float(torch.sum(model.state.win_weights)):.0f}"
          f"  checkpoints: {ckpt.all_steps()[-3:]}")

    # restart path: a fresh process restores the live stream state
    restored = StreamingBigFCM.restore(ckpt, cfg, D, device=dev)
    assert torch.allclose(restored.state.centers, model.state.centers,
                          atol=1e-6)
    x_next, y_next = next(make_moving_blobs(1, CHUNK, D, C, drift_at=0,
                                            shift=10.0, seed=4))
    rep = restored.ingest(x_next)
    print(f"restored model ingested one more post-drift chunk: "
          f"q_pre {rep.objective_pre:.2f} (no drift flag: {not rep.drifted})")
    print("OK -- restart resumes the stream from the checkpoint.")

    # -----------------------------------------------------------------
    # Part 2: event-time ingest of an out-of-order feed.  The same
    # records, once in event order and once shuffled within a bounded
    # skew smaller than the allowed lateness: zero drops, same model.
    print("\n-- part 2: out-of-order event-time feed --")
    x_e, _ = make_blobs(8000, D, C, seed=11)
    ts = np.arange(x_e.shape[0], dtype=np.float64) * 0.01  # 80 time units
    ecfg = StreamConfig(n_clusters=C, window=8, decay=0.9, max_iter=300,
                        driver_sample=512, event_time=True, slot_span=10.0,
                        allowed_lateness=30.0, seed=0)
    in_order = StreamingBigFCM(ecfg, device=dev)
    in_order.run(replay_source(x_e, 800, timestamps=ts))

    shuffled = StreamingBigFCM(ecfg, device=dev)
    reps = shuffled.run(out_of_order_source(
        replay_source(x_e, 800, timestamps=ts), skew=8.0, seed=3))
    print(f"watermark ended at {reps[-1].watermark:.1f}  "
          f"late-dropped: {int(shuffled.state.late_dropped)} records "
          f"(skew 8 < allowed lateness {ecfg.allowed_lateness:.0f})")
    q_in = objective(x_e, in_order.state.centers, ecfg.m)
    q_ooo = objective(x_e, shuffled.state.centers, ecfg.m)
    print(f"objective in-order {q_in:.1f} vs out-of-order {q_ooo:.1f} "
          f"(ratio {q_ooo / q_in:.4f})")
    print("kernel launches:", json.dumps(launches_by_path()))
    assert int(shuffled.state.late_dropped) == 0
    assert q_ooo <= 1.05 * q_in and q_in <= 1.05 * q_ooo
    print("OK -- bounded-skew disorder is absorbed by the event-time "
          "window.")


if __name__ == "__main__":
    main()
