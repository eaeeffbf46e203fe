"""Quickstart on the PyTorch/CUDA port: BigFCM (the paper's Algorithm 3)
end to end in about a minute.

Generates a Gaussian-mixture dataset, clusters it with BigFCM on the
host's mesh (the Hadoop driver/map/combine/reduce pipeline; one card is
a one-rank mesh), and checks the recovered centers against ground truth
and against single-machine FCM.  On a card the engine's "auto" backend
runs the hand-written CUDA kernels; the line "kernel launches" counts
them by wrapper and plan path (none on the CPU, where each wrapper takes
its plain PyTorch version).

    PYTHONPATH=src python examples/torch_quickstart.py                # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --tiny
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.bigfcm import BigFCMConfig, bigfcm_fit
from repro_torch.core.fcm import fcm
from repro_torch.core.metrics import assign, match_centers, silhouette_width
from repro_torch.data.synth import make_blobs
from repro_torch.device import synchronize
from repro_torch.kernels.fcm_update import launches_by_path
from repro_torch.launch.mesh import make_host_mesh, mesh_shape


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized: 20,000 records")
    args = ap.parse_args()
    dev = torch.device(args.device)

    C, D = 6, 18
    N = 20_000 if args.tiny else 200_000
    x, labels = make_blobs(N, D, C, spread=0.6, sep=6.0, seed=0)
    true_centers = np.stack([x[labels == c].mean(0) for c in range(C)])
    print(f"dataset: {N:,} records × {D} features, {C} true clusters")

    mesh = make_host_mesh(device_type=dev.type)
    print(f"mesh: {mesh_shape(mesh)} over "
          f"{torch.distributed.get_world_size()} rank(s) on {dev}")

    cfg = BigFCMConfig(n_clusters=C, m=2.0, driver_eps=5e-11,
                       combiner_eps=1e-8, reducer_eps=5e-11)
    xt = torch.as_tensor(x, device=dev)
    t0 = time.perf_counter()
    res = bigfcm_fit(xt, cfg, mesh=mesh, device=dev)
    synchronize(dev)
    t_big = time.perf_counter() - t0
    d = res.diagnostics
    print(f"\nBigFCM: {t_big:.2f}s  (driver raced FCM {d.t_fcm_driver:.3f}s "
          f"vs WFCMPB {d.t_wfcmpb_driver:.3f}s -> flag={d.flag}, "
          f"sample lambda={d.sample_size})")
    print("combiner local iterations per shard: "
          f"{np.asarray(d.combiner_iters).ravel().tolist()}")

    centers = res.centers.cpu().numpy()
    err = match_centers(centers, true_centers)
    print(f"center recovery error (mean matched distance): {err:.4f}")

    # reference: single-machine FCM on the full data, same seeds
    t0 = time.perf_counter()
    seeds = torch.as_tensor(true_centers + np.random.default_rng(1).normal(
        0, 2.0, true_centers.shape).astype(np.float32), device=dev)
    ref = fcm(xt, seeds, m=2.0, eps=5e-11, max_iter=1000, device=dev)
    synchronize(dev)
    t_ref = time.perf_counter() - t0
    ref_err = match_centers(ref.centers.cpu().numpy(), true_centers)
    print(f"single-machine FCM: {t_ref:.2f}s, center error {ref_err:.4f}")

    sw = silhouette_width(x, assign(xt, res.centers, device=dev))
    print(f"silhouette width (4k subsample): {sw:.4f}")
    print("kernel launches:", json.dumps(launches_by_path()))
    assert err < 0.1, "BigFCM failed to recover ground-truth centers"
    print("\nOK -- BigFCM recovered the mixture centers; "
          f"distributed/single-machine center error {err:.4f}/{ref_err:.4f}")


if __name__ == "__main__":
    main()
