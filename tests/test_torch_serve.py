"""The serving front end of `repro_torch` against `repro`: `Scorer`,
`SnapshotPublisher`, `ScoringService` and `TenantScoringService`, each
case of tests/test_serve.py and the service cases of tests/test_tenant.py
run on both packages side by side — the reference on backend ``jnp``,
the port on backend ``torch`` on the CPU — with the same seeded inputs.

Values are compared across the packages: hard labels equal, soft
memberships within 1e-6, per-tenant versions equal, shape counts equal
to the buckets used.  Where the reference holds a property rather than
a value (shed, deadline, failure propagation, close), the port is held
to the same typed outcome.  Threaded cases are held by counts and typed
outcomes: a gated scorer signals when its worker has taken a request,
so no case waits on the wall clock for a thread to get somewhere."""
import tempfile
import threading
import time

import numpy as np
import pytest

import repro.data as RD
import repro.ft as RF
import repro.obs as ref_obs
import repro.serve as RS
import repro.stream as RST
import repro.tenant as RT
import repro_torch.data as TD
import repro_torch.ft as TF
import repro_torch.obs as port_obs
import repro_torch.serve as TS
import repro_torch.stream as TST
import repro_torch.tenant as TT

D = 6
REF = dict(backend="jnp")
PORT = dict(backend="torch", device="cpu")
SIDES = {"ref": (RS, REF, ref_obs), "port": (TS, PORT, port_obs)}


@pytest.fixture(autouse=True)
def _fresh_obs():
    ref_obs.reset_all()
    port_obs.reset_all()
    yield
    ref_obs.reset_all()
    port_obs.reset_all()


def _centers(c=5, seed=0):
    return (np.random.default_rng(seed).normal(size=(c, D)) * 4.0
            ).astype(np.float32)


def _reqs(k, lo=1, hi=200, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(n), D)).astype(np.float32)
            for n in rng.integers(lo, hi, size=k)]


def _gated(base):
    """``base`` (a Scorer or TenantScorer class) whose ``score`` signals
    ``entered`` and then blocks on ``gate``: the queue backs up behind a
    request the worker holds, so batch composition is deterministic."""

    class Gated(base):
        def __init__(self, *a, **k):
            self.gate = threading.Event()
            self.entered = threading.Event()
            super().__init__(*a, **k)

        def score(self, *a, **k):
            self.entered.set()
            assert self.gate.wait(30), "gate never opened"
            return super().score(*a, **k)

    return Gated


def _poisoned(base):
    class Poison(base):
        def score(self, *a, **k):
            raise ValueError("poisoned scorer")

    return Poison


def _labels(pkg, kw, centers, x, soft=False):
    """Per-request scoring through `make_assigner` as host arrays."""
    out = pkg.make_assigner(centers, soft=soft, **kw)(x)
    return out.cpu().numpy() if hasattr(out, "cpu") else np.asarray(out)


# ------------------------------------------------------- bucket helpers --

def test_shape_bucket_ladder_matches_reference():
    for args, kw in (((4096,), dict(base=64)), ((100,), dict(base=64)),
                     ((32,), dict(base=64)), ((1000,), dict(base=16,
                                                            factor=3))):
        assert TD.shape_buckets(*args, **kw) == RD.shape_buckets(*args,
                                                                 **kw)
    for n in (1, 64, 65, 128):
        assert TD.bucket_for(n, (64, 128)) == RD.bucket_for(n, (64, 128))
    for pkg in (RD, TD):
        with pytest.raises(ValueError):
            pkg.bucket_for(129, (64, 128))


def test_pad_rows_phantom_matches_reference():
    x = np.random.default_rng(0).normal(size=(3, D)).astype(np.float32)
    np.testing.assert_array_equal(TD.pad_rows(x, 8), RD.pad_rows(x, 8))
    assert not TD.pad_rows(x, 8)[3:].any()
    for pkg in (RD, TD):
        with pytest.raises(ValueError):
            pkg.pad_rows(x, 2)


# ------------------------------------------------- coalescing exactness --

@pytest.mark.parametrize("soft", [False, True])
def test_coalesced_equals_per_request_and_reference(soft):
    """Coalesced, padded, bucketed scoring equals per-request scoring
    after unpadding (hard labels bit for bit, soft memberships to 1e-6),
    and the port's responses equal the reference's."""
    centers = _centers()
    reqs = _reqs(40)
    got = {}
    for side, (pkg, kw, _) in SIDES.items():
        svc = pkg.ScoringService(
            pkg.Scorer(pkg.CenterSnapshot(0, centers), soft=soft, **kw),
            pkg.ServiceConfig(max_batch_rows=512, bucket_base=32))
        with svc:
            futs = [svc.submit(r) for r in reqs]
            got[side] = [f.result(30) for f in futs]
        for r, res in zip(reqs, got[side]):
            ref = _labels(pkg, kw, centers, r, soft)
            if soft:
                np.testing.assert_allclose(res.assignments, ref, rtol=0,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(res.assignments, ref)
            assert res.version == 0 and res.replica == "r0"
    for a, b in zip(got["port"], got["ref"]):
        if soft:
            np.testing.assert_allclose(a.assignments, b.assignments,
                                       rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a.assignments, b.assignments)


def test_oversized_request_spans_buckets_one_version():
    centers = _centers()
    big = np.random.default_rng(3).normal(size=(1000, D)).astype(
        np.float32)
    got = {}
    for side, (pkg, kw, _) in SIDES.items():
        svc = pkg.ScoringService(
            pkg.Scorer(pkg.CenterSnapshot(7, centers), **kw),
            pkg.ServiceConfig(max_batch_rows=256, bucket_base=64))
        with svc:
            res = svc.score(big, timeout=30)
        assert res.assignments.shape == (1000,) and res.version == 7
        np.testing.assert_array_equal(res.assignments,
                                      _labels(pkg, kw, centers, big))
        got[side] = res.assignments
    np.testing.assert_array_equal(got["port"], got["ref"])


def test_queue_policy_preserves_fifo_ordering():
    reqs = _reqs(30, lo=1, hi=60)
    got = {}
    for side, (pkg, kw, _) in SIDES.items():
        order = []
        svc = pkg.ScoringService(
            pkg.Scorer(pkg.CenterSnapshot(0, _centers()), **kw),
            pkg.ServiceConfig(max_batch_rows=128, policy="queue"))
        with svc:
            futs = []
            for i, r in enumerate(reqs):
                f = svc.submit(r)
                f.add_done_callback(lambda _f, i=i: order.append(i))
                futs.append(f)
            got[side] = [f.result(30).assignments for f in futs]
        assert order == sorted(order), side
    for a, b in zip(got["port"], got["ref"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- overload --

def test_shed_policy_bounds_queue_and_rejects_typed():
    """The worker holds one 64-row request; 20 more of 64 rows meet a
    256-row queue: 4 are admitted, 16 shed with a typed `Rejected` on
    both packages, and the queue-rows gauge never passes 256."""
    outcome = {}
    for side, (pkg, kw, obs) in SIDES.items():
        scorer = _gated(pkg.Scorer)(pkg.CenterSnapshot(0, _centers()), **kw)
        svc = pkg.ScoringService(scorer, pkg.ServiceConfig(
            max_batch_rows=64, queue_rows=256, policy="shed"))
        x = np.zeros((64, D), np.float32)
        admitted = [svc.submit(x)]
        assert scorer.entered.wait(30)       # the worker holds request 0
        shed = 0
        for _ in range(20):
            try:
                admitted.append(svc.submit(x))
            except pkg.Rejected as e:
                shed += 1
                assert e.limit_rows == 256
                assert e.queued_rows + 64 > 256
        assert obs.gauge("serve.queue_rows").max <= 256
        assert obs.counter("serve.shed").value == shed
        scorer.gate.set()
        for f in admitted:
            assert f.result(30).assignments.shape == (64,)
        svc.close()
        snap = obs.metrics_snapshot()
        assert snap["counters"]["serve.served{replica=r0}"] == len(admitted)
        outcome[side] = (shed, len(admitted))
    assert outcome["port"] == outcome["ref"] == (16, 5)


def test_queue_policy_deadline_is_typed():
    for side, (pkg, kw, obs) in SIDES.items():
        scorer = _gated(pkg.Scorer)(pkg.CenterSnapshot(0, _centers()), **kw)
        svc = pkg.ScoringService(scorer, pkg.ServiceConfig(
            max_batch_rows=64, queue_rows=128, policy="queue",
            deadline_s=0.2))
        x = np.zeros((64, D), np.float32)
        f0 = svc.submit(x)
        assert scorer.entered.wait(30)
        f1, f2 = svc.submit(x), svc.submit(x)    # the queue is full
        t0 = time.monotonic()
        with pytest.raises(pkg.DeadlineExceeded):
            svc.submit(x)
        assert time.monotonic() - t0 >= 0.2 * 0.99   # it waited it out
        assert obs.counter("serve.deadline_expired").value == 1
        scorer.gate.set()
        for f in (f0, f1, f2):
            f.result(30)
        svc.close()


def test_scoring_failure_propagates_never_hangs():
    for side, (pkg, kw, _) in SIDES.items():
        scorer = _poisoned(pkg.Scorer)(pkg.CenterSnapshot(0, _centers()),
                                       **kw)
        svc = pkg.ScoringService(scorer, pkg.ServiceConfig(max_batch_rows=64))
        futs = [svc.submit(np.zeros((32, D), np.float32)) for _ in range(4)]
        for f in futs:
            with pytest.raises(ValueError, match="poisoned"):
                f.result(30)
        # the failure latches: the next submit into the dead service
        # raises, with the scoring error as its cause
        with pytest.raises(RuntimeError) as err:
            svc.submit(np.zeros((8, D), np.float32))
        assert isinstance(err.value.__cause__, ValueError), side
        svc.close()


def test_close_rejects_new_and_drains_or_fails_pending():
    for side, (pkg, kw, _) in SIDES.items():
        svc = pkg.ScoringService(
            pkg.Scorer(pkg.CenterSnapshot(0, _centers()), **kw),
            pkg.ServiceConfig())
        f = svc.submit(np.zeros((8, D), np.float32))
        svc.close()                          # drain=True serves it
        assert f.result(10).assignments.shape == (8,)
        with pytest.raises(pkg.ServiceClosed):
            svc.submit(np.zeros((8, D), np.float32))
        # drain=False fails what is queued with ServiceClosed
        scorer = _gated(pkg.Scorer)(pkg.CenterSnapshot(0, _centers()), **kw)
        svc = pkg.ScoringService(scorer, pkg.ServiceConfig())
        held = svc.submit(np.zeros((8, D), np.float32))
        assert scorer.entered.wait(30)
        queued = svc.submit(np.zeros((8, D), np.float32))
        closer = threading.Thread(target=svc.close, kwargs={"drain": False})
        closer.start()
        with pytest.raises(pkg.ServiceClosed):
            queued.result(30)
        scorer.gate.set()
        closer.join(30)
        assert not closer.is_alive()
        assert held.result(30).assignments.shape == (8,)


def test_submit_validates_shape_fast():
    for side, (pkg, kw, _) in SIDES.items():
        svc = pkg.ScoringService(
            pkg.Scorer(pkg.CenterSnapshot(0, _centers()), **kw),
            pkg.ServiceConfig())
        with svc:
            with pytest.raises(ValueError, match="dim"):
                svc.submit(np.zeros((4, D + 1), np.float32))
            with pytest.raises(ValueError):
                svc.submit(np.zeros((0, D), np.float32))
            assert svc.score(np.zeros((D,), np.float32),
                             timeout=30).assignments.shape == (1,)


def test_many_clients_stress_every_request_answered_once():
    """More client threads than cores against two replicas, the
    interpreter switching threads every microsecond: every request
    resolves exactly once with its own rows' labels, and the served and
    record counters add up to the traffic."""
    import sys
    centers = _centers()
    reqs = _reqs(400, lo=1, hi=90, seed=21)
    want = [_labels(TS, PORT, centers, r) for r in reqs]
    svc = TS.ScoringService(
        [TS.Scorer(TS.CenterSnapshot(0, centers), replica=f"r{i}", **PORT)
         for i in range(2)], TS.ServiceConfig(max_batch_rows=256))
    got, lock = {}, threading.Lock()

    def client(k):
        for i in range(k, len(reqs), 16):
            res = svc.score(reqs[i], timeout=60)
            with lock:
                assert i not in got
                got[i] = res

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == list(range(len(reqs)))
    for i, res in got.items():
        np.testing.assert_array_equal(res.assignments, want[i])
    snap = port_obs.metrics_snapshot()["counters"]
    assert sum(v for k, v in snap.items()
               if k.startswith("serve.served{")) == len(reqs)
    assert sum(v for k, v in snap.items() if k.startswith(
        "serve.records{")) == sum(len(r) for r in reqs)


# ------------------------------------------------------------- hot swap --

def test_hot_swap_mid_traffic_no_torn_reads():
    """Under concurrent swaps every response matches its version's
    labels — on the port and on the reference for that version — and
    after the last swap the next dispatch sees the new snapshot."""
    base = _centers(c=6, seed=3)
    versions = {v: np.roll(base, v, axis=0) for v in range(4)}
    reqs = _reqs(120, lo=4, hi=120, seed=5)
    svc = TS.ScoringService(
        [TS.Scorer(TS.CenterSnapshot(0, base), replica=f"r{i}", **PORT)
         for i in range(2)],
        TS.ServiceConfig(max_batch_rows=256, bucket_base=64))
    stop = threading.Event()

    def swapper():
        v = 0
        while not stop.is_set():
            v = (v + 1) % 4
            svc.swap(v, versions[v])
            time.sleep(0.002)

    t = threading.Thread(target=swapper)
    t.start()
    try:
        results = [f.result(30) for f in [svc.submit(r) for r in reqs]]
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    for r, res in zip(reqs, results):
        assert res.version in versions
        want = _labels(TS, PORT, versions[res.version], r)
        np.testing.assert_array_equal(res.assignments, want)
        np.testing.assert_array_equal(
            res.assignments, _labels(RS, REF, versions[res.version], r))
    svc.swap(99, versions[1])
    assert svc.score(reqs[0], timeout=30).version == 99
    svc.close()


def test_swap_handles_grown_and_shrunk_center_counts():
    x = np.random.default_rng(4).normal(size=(32, D)).astype(np.float32)
    got = {}
    for side, (pkg, kw, _) in SIDES.items():
        svc = pkg.ScoringService(
            pkg.Scorer(pkg.CenterSnapshot(0, _centers(c=4)), **kw),
            pkg.ServiceConfig(max_batch_rows=128))
        with svc:
            svc.swap(1, _centers(c=7, seed=9))       # grown
            grown = svc.score(x, 30).assignments
            svc.swap(2, _centers(c=3, seed=9))       # shrunk
            shrunk = svc.score(x, 30).assignments
        assert grown.max() <= 6 and shrunk.max() <= 2
        got[side] = (grown, shrunk)
    for a, b in zip(got["port"], got["ref"]):
        np.testing.assert_array_equal(a, b)


def test_scorer_takes_device_centers_as_the_reference_does():
    """The reference's replicas boot from the learner's device array; the
    port's take its tensor as it is (one that numpy cannot read, as a
    card's is not) and keep a copy the learner cannot change."""
    import jax.numpy as jnp
    import torch
    x = np.random.default_rng(5).normal(size=(64, D)).astype(np.float32)
    live = torch.tensor(_centers(), requires_grad=True)
    port = TS.Scorer(TS.CenterSnapshot(0, live), **PORT)
    ref = RS.Scorer(RS.CenterSnapshot(0, jnp.asarray(_centers())), **REF)
    with torch.no_grad():
        live.mul_(-1.0)
    got, version = port.assign(x)
    want, _ = ref.assign(x)
    assert version == 0
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert port.swap((1, live.detach(), None)) == 1
    np.testing.assert_array_equal(port.read().centers.numpy(),
                                  -_centers())


# ------------------------------------------------------ compile economy --

def test_assign_store_ragged_tail_scores_one_shape():
    x = np.random.default_rng(6).normal(size=(1000, D)).astype(np.float32)
    centers = _centers()
    store = TD.ChunkStore.ingest(x, chunk_rows=300)
    fn = TS.make_assigner(centers, **PORT)
    out = np.concatenate(list(TS.assign_store(store, centers, assigner=fn)))
    assert fn.traces == 1 and out.shape == (1000,)
    np.testing.assert_array_equal(out, _labels(TS, PORT, centers, x))
    ref_store = RD.ChunkStore.ingest(x, chunk_rows=300)
    ref_fn = RS.make_assigner(centers, **REF)
    want = np.concatenate(list(RS.assign_store(ref_store, centers,
                                               assigner=ref_fn)))
    np.testing.assert_array_equal(out, want)
    assert fn.traces == ref_fn.traces


def test_service_scores_one_shape_per_bucket():
    reqs = _reqs(60, lo=1, hi=250, seed=7)
    counts = {}
    for side, (pkg, kw, _) in SIDES.items():
        svc = pkg.ScoringService(
            pkg.Scorer(pkg.CenterSnapshot(0, _centers()), **kw),
            pkg.ServiceConfig(max_batch_rows=256, bucket_base=64))
        with svc:
            for r in reqs:
                svc.score(r, timeout=30)
            counts[side] = svc.compile_counts()["r0"]
            used = {RD.bucket_for(len(r), svc.buckets) for r in reqs}
        assert counts[side] == len(used) <= len(svc.buckets)
    assert counts["port"] == counts["ref"]


# ------------------------------------------------- snapshots/publishing --

def test_publisher_follows_stream_and_persists_manifest():
    """Learner → publisher → replicas + checkpoint: scorers follow each
    ingest's snapshot; a replica boots the latest version from the
    manifest (grown C safe) — and the reference's
    `snapshot_from_checkpoint` reads the port's checkpoints."""
    cfg = TST.StreamConfig(n_clusters=3, window=2, driver_sample=64,
                           max_iter=40, backend="torch", seed=0)
    model = TST.StreamingBigFCM(cfg, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = TF.CheckpointManager(tmp, async_save=False)
        pub = TS.SnapshotPublisher(ckpt=ckpt)
        model.add_snapshot_listener(pub.publish)
        rng = np.random.default_rng(2)
        rep = None
        for _ in range(3):
            rep = model.ingest(rng.normal(size=(256, D)).astype(np.float32))
        s = TS.Scorer(TS.CenterSnapshot(-1, np.zeros((1, D), np.float32)),
                      replica="late", **PORT)
        pub.attach(s)
        assert s.version == rep.step
        centers = model.state.centers.cpu().numpy()
        np.testing.assert_array_equal(pub.latest().centers, centers)
        boot = TS.snapshot_from_checkpoint(ckpt)
        assert boot.version == rep.step and boot.weights is not None
        np.testing.assert_array_equal(boot.centers, centers)
        ref_boot = RS.snapshot_from_checkpoint(
            RF.CheckpointManager(tmp, async_save=False))
        assert ref_boot.version == boot.version
        np.testing.assert_array_equal(ref_boot.centers, boot.centers)
        np.testing.assert_array_equal(ref_boot.weights, boot.weights)
        pub.publish(100, _centers(c=9, seed=4))
        assert TS.snapshot_from_checkpoint(ckpt).centers.shape == (9, D)
        assert s.version == 100


def test_reference_publisher_snapshot_boots_port_replica():
    """A reference learner's persisted snapshot boots a port replica."""
    cfg = RST.StreamConfig(n_clusters=3, window=2, driver_sample=64,
                           max_iter=40, backend="jnp", seed=0)
    model = RST.StreamingBigFCM(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        pub = RS.SnapshotPublisher(
            ckpt=RF.CheckpointManager(tmp, async_save=False))
        model.add_snapshot_listener(pub.publish)
        x = np.random.default_rng(2).normal(size=(256, D)).astype(
            np.float32)
        rep = model.ingest(x)
        boot = TS.snapshot_from_checkpoint(
            TF.CheckpointManager(tmp, async_save=False))
        assert boot.version == rep.step
        scorer = TS.Scorer(boot, **PORT)
        got, version = scorer.assign(x)
        want, ref_version = RS.Scorer(pub.latest(), **REF).assign(x)
        assert version == ref_version
        np.testing.assert_array_equal(got, np.asarray(want))


def test_restore_arrays_template_free():
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = TF.CheckpointManager(tmp, async_save=False)
        ckpt.save(5, {"centers": _centers(c=4), "extra": np.arange(3)})
        arrs = ckpt.restore_arrays()
        ref = RF.CheckpointManager(tmp, async_save=False).restore_arrays()
        assert set(arrs) == set(ref) == {"centers", "extra"}
        np.testing.assert_array_equal(arrs["centers"], ref["centers"])
        assert arrs["centers"].shape == (4, D)
        for pkg in (TF, RF):
            with pytest.raises(FileNotFoundError):
                pkg.CheckpointManager(tmp + "/empty").restore_arrays()


# ------------------------------------------------------------ obs labels --

def test_per_replica_labels_and_aggregate_histogram():
    reqs = _reqs(40, seed=11, hi=100)
    totals = {}
    for side, (pkg, kw, obs) in SIDES.items():
        svc = pkg.ScoringService(
            [pkg.Scorer(pkg.CenterSnapshot(0, _centers()), replica=f"r{i}",
                        **kw) for i in range(2)],
            pkg.ServiceConfig(max_batch_rows=128))
        with svc:
            futs = [svc.submit(r) for r in reqs]
            total = sum(f.result(30).assignments.shape[0] for f in futs)
        snap = obs.metrics_snapshot()
        agg = snap["histograms"]["span.serve.assign"]
        assert agg["count"] > 0 and np.isfinite(agg["p99"])
        per = [k for k in snap["histograms"]
               if k.startswith("span.serve.assign{replica=")]
        assert per
        assert sum(snap["histograms"][k]["count"] for k in per) \
            == agg["count"]
        rec = [v for k, v in snap["counters"].items()
               if k.startswith("serve.records{replica=")]
        assert sum(rec) == total
        assert snap["histograms"]["serve.request"]["count"] == len(futs)
        totals[side] = total
    assert totals["port"] == totals["ref"]


# ------------------------------------------------------- tenant serving --

TENANT_SIDES = {"ref": (RS, RT, ref_obs, {}),
                "port": (TS, TT, port_obs, dict(device="cpu"))}


def _tenant_arrays(t, seed=0, c=4, d=5):
    """tests/test_tenant.py's `_random_tenant_set` as plain arrays."""
    rng = np.random.default_rng(seed)
    return dict(ids=[f"u{i}" for i in range(t)],
                centers=rng.normal(size=(t, c, d)).astype(np.float32),
                weights=rng.uniform(1, 9, size=(t, c)).astype(np.float32),
                versions=rng.integers(0, 99, size=t),
                objective=rng.normal(size=t).astype(np.float32),
                n_iter=rng.integers(1, 50, size=t))


def _tenant_set(tpkg, arrays):
    return tpkg.tenant_set(**arrays)


def test_tenant_service_routes_and_reports_per_tenant_versions():
    arrays = _tenant_arrays(6, seed=8, d=3)
    arrays["versions"] = np.arange(10, 16)
    rng = np.random.default_rng(8)
    data = {t: rng.normal(size=(9, 3)).astype(np.float32) * 2.0
            for t in arrays["ids"]}
    got = {}
    for side, (spkg, tpkg, _, kw) in TENANT_SIDES.items():
        ts = _tenant_set(tpkg, arrays)
        scorer = spkg.TenantScorer(ts, replica="tA", **kw)
        with spkg.TenantScoringService(
                scorer, spkg.ServiceConfig(max_batch_rows=256)) as svc:
            futs = {t: svc.submit(t, data[t]) for t in data}
            got[side] = {}
            for i, (t, f) in enumerate(futs.items()):
                res = f.result(30)
                direct, version = scorer.assign(t, data[t])
                np.testing.assert_array_equal(res.assignments, direct)
                assert res.version == version == 10 + i
                got[side][t] = (res.assignments, res.version)
            with pytest.raises(KeyError):
                svc.submit("ghost", data["u0"][:2])
    for t in data:
        np.testing.assert_array_equal(got["port"][t][0], got["ref"][t][0])
        assert got["port"][t][1] == got["ref"][t][1]


def test_tenant_scorer_counts_one_shape_per_bucket():
    """One shape per (bucket, T, C): the port's `traces` equals the
    reference's compile count over the same traffic."""
    arrays = _tenant_arrays(5, seed=3, d=3)
    rng = np.random.default_rng(3)
    sizes = [1, 7, 60, 65, 200, 3, 129]
    counts = {}
    for side, (spkg, tpkg, _, kw) in TENANT_SIDES.items():
        scorer = spkg.TenantScorer(_tenant_set(tpkg, arrays), **kw)
        with spkg.TenantScoringService(scorer, spkg.ServiceConfig(
                max_batch_rows=256, bucket_base=64)) as svc:
            for i, n in enumerate(sizes):
                svc.score(f"u{i % 5}", rng.normal(size=(n, 3)), timeout=30)
            used = {RD.bucket_for(n, svc.buckets) for n in sizes}
        counts[side] = scorer.traces
        assert counts[side] == len(used)
    assert counts["port"] == counts["ref"]


def test_tenant_hot_swap_never_tears():
    """Under constant swapping each response is entirely of one fleet:
    its version is its tenant's in the first fleet or a later bump, and
    its labels are that fleet's (the centers never change, so the
    reference's labels hold for every version)."""
    arrays = _tenant_arrays(4, seed=9, d=3)
    ts0 = _tenant_set(TT, arrays)
    scorer = TS.TenantScorer(ts0, device="cpu")
    ref_scorer = RS.TenantScorer(_tenant_set(RT, arrays))
    stop = threading.Event()

    def swapper():
        v = 100
        while not stop.is_set():
            bumped = ts0._replace(versions=np.full(4, v, np.int64))
            scorer.swap(TS.tenant_snapshot(bumped, "cpu"))
            v += 1
            time.sleep(0.001)

    th = threading.Thread(target=swapper, daemon=True)
    th.start()
    try:
        with TS.TenantScoringService(scorer) as svc:
            rng = np.random.default_rng(0)
            for _ in range(30):
                x = rng.normal(size=(17, 3)).astype(np.float32)
                res = svc.score("u2", x, timeout=30)
                assert (res.version == int(ts0.versions[2])
                        or res.version >= 100)
                want, _ = ref_scorer.assign("u2", x)
                np.testing.assert_array_equal(res.assignments,
                                              np.asarray(want))
    finally:
        stop.set()
        th.join(30)
    assert not th.is_alive()


def _fairness_run(spkg, tpkg, kw, max_group_rows):
    """10 firehose requests (16 rows each, tenant 'hot') then one quiet
    4-row request, the first hot one held by the gated worker while the
    rest queue; returns how many hot responses resolved before the quiet
    one."""
    arrays = _tenant_arrays(2, seed=10, d=3)
    arrays["ids"] = ["hot", "quiet"]
    arrays["versions"] = np.zeros(2, np.int64)
    scorer = _gated(spkg.TenantScorer)(_tenant_set(tpkg, arrays), **kw)
    cfg = spkg.ServiceConfig(max_batch_rows=64, max_group_rows=max_group_rows)
    order = []
    with spkg.TenantScoringService(scorer, cfg) as svc:
        rng = np.random.default_rng(0)
        futs = [svc.submit("hot", rng.normal(size=(16, 3)))]
        futs[0].add_done_callback(lambda _f: order.append("hot"))
        assert scorer.entered.wait(30)   # the worker holds request 0
        for _ in range(9):
            f = svc.submit("hot", rng.normal(size=(16, 3)))
            f.add_done_callback(lambda _f: order.append("hot"))
            futs.append(f)
        fq = svc.submit("quiet", rng.normal(size=(4, 3)))
        fq.add_done_callback(lambda _f: order.append("quiet"))
        futs.append(fq)
        scorer.gate.set()
        for f in futs:
            f.result(30)
    return order.index("quiet")


def test_group_cap_prevents_starvation():
    """cap=16: dispatch 2 is [hot#1 (at cap), quiet], so the quiet
    tenant resolves third; uncapped FIFO runs drain the whole firehose
    first — the same on both packages."""
    for cap, want in ((16, 2), (None, 10)):
        got = {side: _fairness_run(spkg, tpkg, kw, cap)
               for side, (spkg, tpkg, _, kw) in TENANT_SIDES.items()}
        assert got == {"ref": want, "port": want}, cap


def test_group_cap_requires_positive():
    for pkg in (RS, TS):
        with pytest.raises(ValueError):
            pkg.ServiceConfig(max_group_rows=0)


@pytest.mark.parametrize("backend", [None, "auto"])
def test_scorers_resolve_auto_without_a_race(tmp_path, monkeypatch,
                                             backend):
    """Every backend scores with the same engine functions, so "auto" on
    the scoring path takes the device rule: no race is run, no
    calibration file is written, and the labels equal the ``torch``
    backend's."""
    from repro_torch.perf import calibrate
    monkeypatch.setenv(calibrate.ENV_DIR, str(tmp_path))
    calibrate.clear_memory_cache()

    def no_race(*a, **k):
        raise AssertionError("scoring ran the calibration race")
    monkeypatch.setattr(calibrate, "race_backends", no_race)
    v = _centers()
    x = _reqs(1, 300, 301)[0]
    scorer = TS.Scorer(TS.CenterSnapshot(1, v), backend=backend,
                       device="cpu")
    assigner = TS.make_assigner(v, backend=backend, device="cpu")
    want = TS.make_assigner(v, **PORT)(x).numpy()
    np.testing.assert_array_equal(scorer.assign(x)[0], want)
    np.testing.assert_array_equal(assigner(x).numpy(), want)
    assert not (tmp_path / calibrate.CALIB_NAME).exists()
    calibrate.clear_memory_cache()
