"""Streaming clustering service on the PyTorch/CUDA port: BigFCM over a
sharded, prefetching data pipeline with checkpoint/restart and straggler
monitoring — the paper's deployment story (multi-gigabyte HDFS scan) as
a long-running service.

Data arrives in chunks (the HDFS-split analogue), each macro-batch is
clustered starting from the previous centers (warm start = the paper's
distributed-cache mechanism applied over *time* as well as space), and
the running (centers, weights) pair is itself WFCM-merged — the same
weighted-combine math that merges combiner outputs merges epochs.  Then
the chunk cache's out-of-core refit, the obs report, the serving plane
(a learner and two scorer replicas under client load) and the tenant
plane (1000 small models fit in one launch, checkpointed and served).

On a card the engine's "auto" backend runs the hand-written CUDA
kernels (the tenant fit their tenant-stacked launch); the line "kernel
launches" counts them by wrapper and plan path (none on the CPU, where
each wrapper takes its plain PyTorch version).

    PYTHONPATH=src python examples/torch_cluster_service.py
    PYTHONPATH=src python examples/torch_cluster_service.py --device cpu --tiny
"""
import argparse
import collections
import dataclasses
import json
import tempfile
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bigfcm_fit_store
from repro_torch.core.bigfcm import BigFCMConfig, bigfcm_fit
from repro_torch.core.metrics import assign, clustering_accuracy, \
    match_centers
from repro_torch.data.loader import ShardedLoader, normalize
from repro_torch.data.synth import make_kdd_like
from repro_torch.engine import MergePlan, Summary, merge_summaries
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.elastic import StragglerMonitor
from repro_torch.kernels.fcm_update import launches_by_path
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import (CenterSnapshot, Scorer, ScoringService,
                               ServiceConfig, SnapshotPublisher,
                               TenantScorer, TenantScoringService,
                               assign_store)
from repro_torch.stream import StreamConfig, StreamingBigFCM
from repro_torch.tenant import (TenantFitConfig, fit_tenants, load_tenants,
                                save_tenants)

C = 23                    # KDD99-like: 23 classes, 41 features


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized: a tenth of the records and tenants")
    args = ap.parse_args()
    dev = torch.device(args.device)
    scale = 10 if args.tiny else 1
    chunk, batch_rows, n_chunks = 40_000 // scale, 120_000 // scale, 6
    n_tenants = 1000 // scale
    picks = (3, 17, 401, 910) if scale == 1 else (3, 17, 40, 91)

    mesh = make_host_mesh(device_type=dev.type)
    ckpt = CheckpointManager(tempfile.mkdtemp(prefix="repro_fcm_ckpt_"))
    monitor = StragglerMonitor(on_straggler=lambda dt, ew: print(
        f"  [straggler] step {dt:.2f}s vs EWMA {ew:.2f}s"))

    # one big dataset, streamed in HDFS-split-sized chunks
    x_all, _ = make_kdd_like(chunk * n_chunks, seed=7)
    stream = (x_all[i * chunk:(i + 1) * chunk] for i in range(n_chunks))
    loader = ShardedLoader(stream, batch_rows, mesh=mesh,
                           transform=normalize)

    cfg = BigFCMConfig(n_clusters=C, m=1.2, combiner_eps=1e-7,
                       reducer_eps=5e-11, max_iter=300)

    epoch_plan = MergePlan("flat", m=cfg.m, eps=cfg.reducer_eps,
                           max_iter=cfg.max_iter)
    centers, weights = None, None
    for i, (batch, w) in enumerate(loader):
        monitor.start()
        res = bigfcm_fit(batch, cfg, mesh=mesh, point_weights=w)
        if centers is None:
            centers, weights = res.centers, res.center_weights
        else:  # the same engine merge that combines combiners merges epochs
            merged = merge_summaries(
                [Summary(centers, weights),
                 Summary(res.centers, res.center_weights)],
                epoch_plan, init=centers)
            centers, weights = merged.summary.centers, merged.summary.masses
        monitor.stop()
        ckpt.save(i, {"centers": centers, "weights": weights})
        print(f"macro-batch {i}: objective {float(res.objective):.1f}, "
              f"combiner iters "
              f"{np.asarray(res.diagnostics.combiner_iters).ravel().tolist()}")

    ckpt.wait()
    print(f"\ncheckpoints kept: {ckpt.all_steps()} (atomic, keep-last-3)")

    # quality check on a fresh sample from the same mixture (same seed ⇒
    # same component centers, freshly drawn noise/labels)
    x, y = make_kdd_like(60_000 // scale, seed=7)
    x = normalize(x)
    acc = clustering_accuracy(y, assign(x, centers, device=dev), C)
    true_centers = np.stack([x[y == c].mean(0) for c in range(C)
                             if (y == c).any()])
    found = centers.cpu().numpy()
    err = match_centers(found[:len(true_centers)], true_centers)
    print(f"held-out confusion accuracy: {acc:.3f}  center error: {err:.4f}")

    # restart path: restore from latest checkpoint and keep serving
    restored = ckpt.restore({"centers": centers, "weights": weights})
    assert torch.allclose(restored["centers"], centers, atol=1e-6)
    print("OK -- restart restores the clustering state bit-exactly.")

    # The first pass parsed the stream ONCE into the loader's chunk cache
    # (the paper's node-local cache); nightly re-fits and archive scoring
    # read the cache, never the stream.  One out-of-core refit over the
    # whole history + chunk-by-chunk scoring of the archive:
    store = loader.store
    print(f"\nchunk cache after ingest: {store!r}")
    nightly = dataclasses.replace(cfg, use_driver=False, max_iter=60,
                                  combiner_eps=1e-6)
    refit = bigfcm_fit_store(store, nightly, n_shards=2, device=dev)
    labels = np.concatenate(list(assign_store(store, refit.centers,
                                              device=dev)))
    assert labels.shape[0] == store.n_rows
    counts = np.bincount(labels, minlength=C)
    print(f"out-of-core refit over {store.n_rows} cached rows "
          f"(objective {float(refit.objective):.1f}); archive scored "
          f"chunk-by-chunk, {int((counts > 0).sum())}/{C} clusters "
          "occupied.")

    # -----------------------------------------------------------------
    # Everything above was instrumented as it ran: each fit, chunk read,
    # checkpoint save, and per-chunk scoring call fed the
    # `repro_torch.obs` metrics/tracing plane (always on by default;
    # REPRO_OBS=0 turns every instrumentation call into a no-op).  The
    # report below is the per-phase breakdown — where the wall time went
    # (parse vs sweep vs merge vs checkpoint vs scoring), with p50/p99
    # per phase from log-bucket histograms, plus the cache counters.
    #
    # Set REPRO_OBS_DIR=/some/dir to ALSO flush these events to
    # <dir>/events.jsonl at exit, then render a finished run post-mortem:
    #     python -m repro_torch.obs.report --jsonl /some/dir/events.jsonl
    print("\n=== observability report (repro_torch.obs) ===")
    print(obs.render_report(top_events=3))
    p99 = obs.histogram("span.serve.assign").quantile(0.99)
    print(f"\nserve.assign p99 latency: {p99 * 1e3:.2f} ms "
          "(what the serving plane reads for its SLO)")

    # -----------------------------------------------------------------
    # Part 3 — the serving plane: one ONLINE learner, two read-only
    # scorer replicas following its snapshots, and a coalescing front-end
    # absorbing many concurrent clients.  The learner keeps ingesting
    # while clients score: every ingest publishes a fresh (version,
    # centers, weights) snapshot that hot-swaps into both replicas
    # WITHOUT dropping or blocking the in-flight requests — each response
    # still reports the single snapshot version it was scored against.
    print("\n=== serving plane: learner + 2 replicas + 8 clients ===")
    obs.reset_metrics()
    learner = StreamingBigFCM(StreamConfig(n_clusters=C, m=1.2, window=4,
                                           max_iter=60), device=dev)
    learner.ingest(normalize(x_all[:chunk]))          # seed centers
    replicas = [Scorer(CenterSnapshot(0, learner.state.centers), m=1.2,
                       replica=f"r{i}", device=dev) for i in range(2)]
    pub = SnapshotPublisher(replicas)
    learner.add_snapshot_listener(pub.publish)        # learn → swap

    svc = ScoringService(replicas, ServiceConfig(max_batch_rows=8192,
                                                 bucket_base=256))
    versions = []

    def client(i):
        rng = np.random.default_rng(300 + i)
        for _ in range(12):
            n = int(rng.integers(200, 3000))
            at = int(rng.integers(0, len(x_all) - n))
            res = svc.score(normalize(x_all[at:at + n]), timeout=60)
            versions.append(res.version)

    clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in clients:
        t.start()
    # the learner keeps learning DURING the client traffic: each ingest
    # publishes a snapshot that hot-swaps both replicas mid-flight
    for j in range(1, 4):
        learner.ingest(normalize(x_all[j * chunk:(j + 1) * chunk]))
    for t in clients:
        t.join()
    svc.close()

    snap = obs.metrics_snapshot()
    p99_srv = snap["histograms"]["span.serve.assign"]["p99"]
    served = {k: v for k, v in snap["counters"].items()
              if k.startswith("serve.served")}
    print(f"responses by snapshot version: "
          f"{dict(sorted(collections.Counter(versions).items()))}"
          f"  (learner published version {pub.latest().version} last)")
    print(f"served per replica: {served}")
    print(f"serve.assign p99 under 8-client load: {p99_srv * 1e3:.2f} ms "
          f"-- {len(versions)} responses, 0 dropped, hot-swapped "
          "mid-traffic")

    # -----------------------------------------------------------------
    # Part 4 — the tenant plane: the OTHER production shape.  Parts 1–3
    # fit one big model; "millions of users" deployments fit millions of
    # SMALL ones — a per-user/per-cohort model over a few dozen rows
    # each.  `fit_tenants` packs a whole cohort into one phantom-padded
    # (T, n, d) block and converges every tenant inside ONE launch per
    # sweep (per-tenant done-mask; on a card the hand-written
    # tenant-stacked kernel); `TenantScoringService` then routes requests
    # by tenant id and coalesces cross-tenant traffic back into single
    # gather-scored launches.  The stacked TenantSet checkpoints through
    # the same CheckpointManager as Part 1 — one manifest for any T.
    print(f"\n=== tenant plane: {n_tenants} per-cohort models, one "
          "launch ===")
    obs.reset_metrics()
    rng = np.random.default_rng(42)
    cohorts = {f"user{i}": (rng.normal(size=(int(rng.integers(8, 30)), 4))
                            + 3.0 * (i % 5)).astype(np.float32)
               for i in range(n_tenants)}
    ts = fit_tenants(cohorts, TenantFitConfig(n_clusters=3, seed=0,
                                              eps=1e-4, max_iter=50,
                                              row_base=16, backend="auto"),
                     device=dev)
    launches = obs.metrics_snapshot()["counters"]["tenant.fit.launches"]
    print(f"fit {ts.n_tenants} tenants "
          f"({sum(x.shape[0] for x in cohorts.values())} records) in "
          f"{int(launches)} device launch; median per-tenant iters "
          f"{int(np.median(ts.n_iter))}")

    # stacked checkpoint: ONE manifest holds the whole fleet; restore a
    # subset without touching the rest
    save_tenants(ckpt, step=100, ts=ts)
    two = load_tenants(ckpt, step=100,
                       tenants=[f"user{picks[1]}", f"user{picks[3]}"])
    assert np.array_equal(np.asarray(two.centers[0]), np.asarray(
        ts.centers[ts.index(f"user{picks[1]}")]))
    print(f"checkpointed all {ts.n_tenants}; restored subset {two.ids}")

    # tenant-routed scoring: requests name a tenant, the front-end
    # coalesces across tenants into one gather-scored launch per bucket
    tsvc = TenantScoringService(TenantScorer(ts, replica="t0", device=dev),
                                ServiceConfig(max_batch_rows=4096,
                                              bucket_base=64,
                                              max_group_rows=512))
    hits = []
    for i in picks:
        res = tsvc.score(f"user{i}", cohorts[f"user{i}"], timeout=60)
        hits.append((f"user{i}", int(res.assignments.shape[0]),
                     res.version))
    tsvc.close()
    print(f"routed scoring (tenant, rows, snapshot version): {hits}")
    print("kernel launches:", json.dumps(launches_by_path()))
    print(f"tenant plane: {n_tenants} models fit/served/checkpointed as "
          "one batch")


if __name__ == "__main__":
    main()
