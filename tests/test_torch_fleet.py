"""`repro_torch.fleet` (with `repro_torch.ft.elastic`'s straggler half and
`repro_torch.baselines.mr_kmeans`) against `repro`'s.

Two kinds of case, on tests/test_fleet.py's store (`make_blobs(20000, 6,
5, seed=3)` in 1024-row chunks, written once by the reference and opened
by both packages):

* tests/test_fleet.py's own cases run on the port, at that file's bars
  (the port's seeds and its 1-shard store fit as the reference point);
* side by side: both packages on the same store from the reference's
  `driver_seeds` — the reference on backend ``jnp``, the port on
  ``torch`` with ``device="cpu"`` — held to centers 1e-5 and objective
  1e-5 relative; wire frames byte for byte both ways; plan
  fingerprints; one `DirTransport` directory read by both; obs counters
  and span counts.

The straggler cases do not race the host clock: the delayed host sleeps
an hour (its thread is abandoned once evicted), and `StragglerMonitor`
reads a scripted clock.  The kill-one-host case spawns CPU processes in
a subprocess with its own timeout."""
import json
import os
import subprocess
import sys
import threading
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.baselines as RB
import repro.core as RC
import repro.data as RD
import repro.fleet as RF
import repro.ft.elastic as RE
import repro_torch.baselines as TB
import repro_torch.core as TC
import repro_torch.data as TD
import repro_torch.fleet as TF
import repro_torch.ft.elastic as TE
from repro import obs as ref_obs
from repro.data.plane import plan_partitions as ref_plan_partitions
from repro.data.plane import replan as ref_replan
from repro_torch import obs
from repro_torch.core.outofcore import make_accumulator, ooc_accumulate
from repro_torch.engine import Summary
from repro_torch.kernels import fcm_update

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = dict(device="cpu")
CFG_KW = dict(n_clusters=5, use_driver=False, sample_size=512, seed=0)
CFG = TC.BigFCMConfig(backend="torch", **CFG_KW)
REF_CFG = RC.BigFCMConfig(backend="jnp", **CFG_KW)
DELAY_S = 3600.0          # a delayed host outsleeps the test session


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(reference store, port store, directory): one on-disk store."""
    x, _ = RD.make_blobs(20000, 6, 5, seed=3)
    d = str(tmp_path_factory.mktemp("fleet_store"))
    ref = RD.ChunkStore.ingest(x, chunk_rows=1024, cache_dir=d)
    return ref, TD.ChunkStore.open(d), d


@pytest.fixture(scope="module")
def store(stores):
    return stores[1]


@pytest.fixture(scope="module")
def reference(store):
    """The port's 1-shard store fit and its GLOBAL objective through the
    fleet's backend (tests/test_fleet.py's fixture, on the port)."""
    res = TC.bigfcm_fit_store(store, CFG, n_shards=1, **CPU)
    acc = make_accumulator("torch", CFG.m, **CPU)
    _, _, q = ooc_accumulate(TD.batched(store.iter_chunks(), 1024),
                             res.centers, CFG.m, acc=acc, **CPU)
    return res.centers.numpy(), float(q)


@pytest.fixture(scope="module")
def ref_seeds(stores):
    return RC.driver_seeds(stores[0], REF_CFG)


@pytest.fixture
def fresh_obs():
    for o in (obs, ref_obs):
        o.set_enabled(True)
        o.reset_all()
    yield
    for o in (obs, ref_obs):
        o.reset_all()
        o.set_enabled(None)


def _summary(rng, shape, scale=1.0):
    return Summary(rng.normal(scale=scale, size=shape).astype(np.float32),
                   np.abs(rng.normal(size=shape[:-1])).astype(np.float32))


# ------------------------------------------------------------------ wire ---

def test_wire_roundtrip_f32_exact():
    s = _summary(np.random.default_rng(0), (3, 5, 6))
    out, fp = TF.decode_summary(TF.encode_summary(s, wire="f32",
                                                  fingerprint="deadbeef"))
    assert fp == "deadbeef"
    assert np.array_equal(out.centers.numpy(), s.centers)
    assert np.array_equal(out.masses.numpy(), s.masses)
    assert out.centers.dtype == torch.float32


def test_wire_bf16_error_bound_pinned():
    """Round-to-nearest into bf16's 8-bit significand is elementwise
    |x̂ − x| ≤ 2⁻⁸·|x|, and the frame is about half the f32 bytes."""
    s = _summary(np.random.default_rng(1), (4, 5, 6), scale=100.0)
    f32 = TF.encode_summary(s, wire="f32")
    bf16 = TF.encode_summary(s, wire="bf16")
    assert len(bf16) < 0.6 * len(f32)
    out, _ = TF.decode_summary(bf16)
    assert TF.BF16_REL_BOUND == 2.0 ** -8
    for got, want in zip(out, s):
        assert np.all(np.abs(got.numpy() - want)
                      <= TF.BF16_REL_BOUND * np.abs(want) + 1e-30)


def test_wire_zero_slot_stack():
    s = Summary(np.zeros((0, 5, 6), np.float32), np.zeros((0, 5), np.float32))
    out, _ = TF.decode_summary(TF.encode_summary(s))
    assert tuple(out.centers.shape) == (0, 5, 6)


def test_wire_rejects_unknown_dtype_and_bad_magic():
    s = _summary(np.random.default_rng(0), (1, 2, 3))
    with pytest.raises(ValueError, match="unknown wire dtype"):
        TF.encode_summary(s, wire="f16")
    with pytest.raises(ValueError, match="bad magic"):
        TF.decode_summary(b"XXXX" + TF.encode_summary(s)[4:])


def _wire_values(rng):
    """Random float32s plus the cases rounding decides: exact ties (even
    and odd kept bits, both signs), one ulp either side of a tie,
    subnormals, ±0, ±inf, NaNs of both signs, the largest finite value
    (rounds to inf) and values just below a power of two."""
    bits = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    base = rng.integers(0, 2 ** 31 - 2 ** 24, size=64,
                        dtype=np.uint64) & ~np.uint64(0xFFFF)
    ties = np.concatenate([base | 0x8000, base | 0x18000,
                           base | 0x7FFF, base | 0x8001,
                           (base | 0x8000) | 0x80000000])
    special = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                        0xFFC00000, 0x7F800001, 0xFFA00001, 0x00000001,
                        0x00008000, 0x00018000, 0x007FFFFF, 0x7F7FFFFF,
                        0x3F7FFFFF, 0xBF7FC000, 0x3F808000, 0x3F818000],
                       np.uint64)
    allbits = np.concatenate([bits, ties, special]).astype(np.uint32)
    vals = allbits.view(np.float32)
    n = vals.size // 8 * 8
    return vals[:n].reshape(-1, 2, 4)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_wire_frames_byte_identical_both_ways(wire):
    """The same arrays and fingerprint frame to the same bytes in both
    packages (from numpy and from a tensor), and each package decodes
    the other's frame to the same float32 values."""
    rng = np.random.default_rng(7)
    centers = _wire_values(rng)
    masses = np.abs(centers[..., 0])
    s = Summary(centers, masses)
    fp = "0123456789abcdef"
    ref = RF.encode_summary(s, wire=wire, fingerprint=fp)
    port = TF.encode_summary(s, wire=wire, fingerprint=fp)
    assert port == ref
    assert TF.encode_summary(Summary(torch.from_numpy(centers),
                                     torch.from_numpy(masses)),
                             wire=wire, fingerprint=fp) == ref
    (r_c, r_m), r_fp = RF.decode_summary(port)
    (p_c, p_m), p_fp = TF.decode_summary(ref)
    assert r_fp == p_fp == fp
    for a, b in ((r_c, p_c), (r_m, p_m)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_bf16_rounding_matches_ml_dtypes_on_every_class():
    """`to_bf16_bits` is round-to-nearest-even as ``ml_dtypes`` casts,
    NaNs included, over 2²⁰ random bit patterns and the tie cases."""
    from repro_torch.fleet.wire import from_bf16_bits, to_bf16_bits
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.integers(0, 2 ** 32, size=1 << 20,
                     dtype=np.uint64).astype(np.uint32).view(np.float32),
        _wire_values(rng).ravel()])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16)
    assert np.array_equal(to_bf16_bits(x), want.view(np.uint16))
    assert np.array_equal(from_bf16_bits(want.view(np.uint16)).view(
        np.uint32), want.astype(np.float32).view(np.uint32))


# ---------------------------------------------------------------- parity ---

@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_fleet_parity_f32(store, reference, n_hosts):
    """Fleet fit over 1/2/4 simulated hosts ≡ the 1-shard fit within
    1e-5 relative objective on separable data."""
    _, q_ref = reference
    res = TF.fleet_fit(store, CFG, TF.FleetConfig(n_hosts=n_hosts,
                                                  shards_per_host=2), **CPU)
    assert res.live == tuple(range(n_hosts))
    assert res.n_rows == store.n_rows
    assert res.centers.dtype == res.masses.dtype == np.float32
    assert abs(res.objective - q_ref) / q_ref < 1e-5


def test_fleet_parity_quantized_exchange(store, reference):
    _, q_ref = reference
    res = TF.fleet_fit(store, CFG, TF.FleetConfig(
        n_hosts=4, shards_per_host=2, wire="bf16"), **CPU)
    assert abs(res.objective - q_ref) / q_ref < 1e-3


def test_fleet_centers_match_reference(store, reference):
    c_ref, _ = reference
    res = TF.fleet_fit(store, CFG, TF.FleetConfig(n_hosts=2), **CPU)
    a = c_ref[np.argsort(c_ref[:, 0])]
    b = res.centers[np.argsort(res.centers[:, 0])]
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_more_hosts_than_chunks():
    """A host that owns zero shards posts an empty stack and still
    agrees with everyone."""
    x, _ = TD.make_blobs(4000, 6, 5, seed=3)
    small = TD.ChunkStore.ingest(x, chunk_rows=2048)   # 2 chunks
    res = TF.fleet_fit(small, CFG, TF.FleetConfig(n_hosts=3), **CPU)
    assert res.live == (0, 1, 2)
    assert res.n_rows == 4000


# ------------------------------------------------- zero-coordination ------

def test_hosts_derive_identical_seeds_and_plans(store):
    cfg = TC.BigFCMConfig(n_clusters=4, sample_size=256, seed=7,
                          backend="torch")      # use_driver=True, Flag pinned
    assert np.array_equal(TC.driver_seeds(store, cfg, **CPU),
                          TC.driver_seeds(store, cfg, **CPU))
    fleet = TF.FleetConfig(n_hosts=3, shards_per_host=2)
    tr = TF.MailboxTransport()
    hosts = [TF.FleetHost(h, store, CFG, fleet, tr, **CPU) for h in range(3)]
    assert len({h.plan.fingerprint() for h in hosts}) == 1
    owned = sorted(s for h in hosts for s in h.my_shards())
    assert owned == list(range(hosts[0].plan.n_shards))   # full cover
    assert np.array_equal(hosts[0].seeds(), hosts[2].seeds())


def test_plan_divergence_fails_loud(store, ref_seeds):
    """Hosts partitioning differently must error at exchange via the
    fingerprint stamp — never merge."""
    tr = TF.MailboxTransport()
    hosts = [TF.FleetHost(h, store, CFG, TF.FleetConfig(
        n_hosts=2, shards_per_host=h + 1, gather_timeout_s=10), tr, **CPU)
        for h in (0, 1)]
    errs = {}

    def go(h):
        try:
            h.exchange(h.local_fit(ref_seeds))
        except RuntimeError as e:
            errs[h.host_id] = e

    ts = [threading.Thread(target=go, args=(h,)) for h in hosts]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert any("fingerprint" in str(e) for e in errs.values())


def test_shard_fits_rotate_over_devices(store, ref_seeds):
    """``devices`` spreads a host's shard fits; the stack comes back on
    the host's ``device`` and equals the one-device fit's."""
    fleet = TF.FleetConfig(n_hosts=1, shards_per_host=3)
    one = TF.FleetHost(0, store, CFG, fleet, TF.MailboxTransport(), **CPU)
    two = TF.FleetHost(0, store, CFG, fleet, TF.MailboxTransport(),
                       devices=["cpu", torch.device("cpu")], **CPU)
    assert two.devices == (torch.device("cpu"),) * 2
    a, b = one.local_fit(ref_seeds), two.local_fit(ref_seeds)
    assert b.centers.device == two.device and tuple(b.centers.shape) == \
        (3, 5, 6)
    assert torch.equal(a.centers, b.centers)
    assert torch.equal(a.masses, b.masses)


def test_host_id_out_of_range(store):
    with pytest.raises(ValueError, match="not in"):
        TF.FleetHost(2, store, CFG, TF.FleetConfig(n_hosts=2),
                     TF.MailboxTransport(), **CPU)


# -------------------------------------------------------------- transport --

def test_dir_transport_tombstone_and_eviction(tmp_path):
    tr = TF.DirTransport(str(tmp_path), poll_s=0.01)
    tr.post(0, 0, "sum", b"abc")
    tr.mark_dead(1)
    with pytest.raises(TF.HostLost) as e:
        tr.gather(0, 0, (0, 1), "sum", timeout_s=30.0)
    assert e.value.lost == (1,)
    with pytest.raises(TF.Evicted):
        tr.post(0, 1, "sum", b"xyz")       # the dead host's own post
    assert tr.gather(0, 0, (0,), "sum", timeout_s=1.0) == {0: b"abc"}


def test_dir_transport_timeout_backstop(tmp_path):
    tr = TF.DirTransport(str(tmp_path), poll_s=0.01)
    tr.post(0, 0, "sum", b"abc")
    t0 = time.monotonic()
    with pytest.raises(TF.HostLost) as e:
        tr.gather(0, 0, (0, 1), "sum", timeout_s=0.2)
    assert e.value.lost == (1,)
    assert time.monotonic() - t0 < 30.0


def test_mailbox_transport_gather_blocks_until_post():
    tr = TF.MailboxTransport()
    tr.post(0, 0, "sum", b"a")
    poster = threading.Timer(0.1, lambda: tr.post(0, 1, "sum", b"b"))
    poster.start()
    assert tr.gather(0, 0, (0, 1), "sum", timeout_s=30.0) == \
        {0: b"a", 1: b"b"}
    poster.join(timeout=30)
    assert set(tr.post_times(0, "sum")) == {0, 1}


def test_mailbox_transport_dead_host_and_eviction():
    tr = TF.MailboxTransport()
    tr.post(0, 0, "sum", b"a")
    tr.mark_dead(2)
    with pytest.raises(TF.HostLost) as e:
        tr.gather(0, 0, (0, 1, 2), "sum", timeout_s=30.0)
    assert e.value.lost == (2,)
    with pytest.raises(TF.Evicted):
        tr.gather(0, 2, (0, 2), "sum", timeout_s=30.0)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_dir_transport_directory_reads_the_same_from_both(tmp_path, writer):
    """A mailbox directory written by one package — posts and a
    tombstone — is gathered by the other, HostLost and Evicted
    included."""
    pkgs = {"ref": RF, "port": TF}
    w = pkgs[writer].DirTransport(str(tmp_path), poll_s=0.01)
    r = pkgs["port" if writer == "ref" else "ref"].DirTransport(
        str(tmp_path), poll_s=0.01)
    w.post(0, 0, "sum", b"frame0")
    w.post(0, 2, "sum", b"frame2")
    assert r.gather(0, 0, (0, 2), "sum", timeout_s=5.0) == \
        {0: b"frame0", 2: b"frame2"}
    assert set(r.post_times(0, "sum")) == {0, 2}
    w.mark_dead(1)
    with pytest.raises((RF.HostLost, TF.HostLost)) as e:
        r.gather(0, 0, (0, 1, 2), "sum", timeout_s=30.0)
    assert e.value.lost == (1,)
    with pytest.raises((RF.Evicted, TF.Evicted)):
        r.post(1, 1, "sum", b"late")
    assert sorted(os.listdir(tmp_path)) == [
        "dead.h0001", "e0000.sum.h0000.bin", "e0000.sum.h0002.bin"]


# ------------------------------------------------- prefetch + straggler ---

def test_prefetch_on_off_identical(store, reference, fresh_obs):
    _, q_ref = reference
    on = TF.fleet_fit(store, CFG, TF.FleetConfig(n_hosts=2,
                                                 shards_per_host=2), **CPU)
    assert obs.counter("fleet.prefetch.bytes").value > 0
    off = TF.fleet_fit(store, CFG, TF.FleetConfig(
        n_hosts=2, shards_per_host=2, prefetch=False), **CPU)
    assert np.array_equal(on.centers, off.centers)
    tiny = TF.fleet_fit(store, CFG, TF.FleetConfig(
        n_hosts=2, shards_per_host=2, prefetch_bytes=1024), **CPU)
    assert np.array_equal(on.centers, tiny.centers)
    assert abs(on.objective - q_ref) / q_ref < 1e-5


def _straggler_fleet():
    return dict(n_hosts=3, shards_per_host=2, debug_delay_s={1: DELAY_S},
                straggler_factor=2.0, straggler_min_s=0.4)


def test_straggler_evicted_and_replanned(stores, reference, fresh_obs):
    """A host whose per-row rate collapses is tombstoned mid-fit, the
    survivors replan (moved count = the reference's deterministic
    replan's), and the fit reaches the 1-shard objective without it."""
    ref_store, store, _ = stores
    _, q_ref = reference
    res = TF.fleet_fit(store, CFG, TF.FleetConfig(**_straggler_fleet()),
                       **CPU)
    assert res.live == (0, 2)
    assert res.epoch == 1
    assert obs.counter("fleet.straggler.detected").value == 1
    _, moved = ref_replan(ref_store, ref_plan_partitions(
        ref_store, 6), 4)
    assert moved > 0 and res.moved_chunks == moved
    assert obs.counter("fleet.replan.moved_chunks").value == \
        moved * len(res.live)
    assert abs(res.objective - q_ref) / q_ref < 1e-5


def test_detect_stragglers_matches_reference(fresh_obs):
    """The row-normalized rule on random phase timings: the same hosts
    flagged as the reference's, and the same ``ft.straggler.flags``."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        k = int(rng.integers(1, 6))
        hosts = rng.permutation(10)
        finished = {int(h): (float(rng.uniform(0.1, 3)),
                             int(rng.integers(0, 5000)))
                    for h in hosts[:k]}
        inflight = {int(h): (float(rng.uniform(0.0, 9)),
                             int(rng.integers(0, 5000)))
                    for h in hosts[k:k + int(rng.integers(0, 5))]}
        kw = dict(factor=float(rng.uniform(1.5, 5)),
                  min_s=float(rng.uniform(0, 1)))
        assert TE.detect_stragglers(inflight, finished, **kw) == \
            RE.detect_stragglers(inflight, finished, **kw)
    assert obs.counter("ft.straggler.flags").value == \
        ref_obs.counter("ft.straggler.flags").value > 0


def test_straggler_monitor_flags_outlier(monkeypatch, fresh_obs):
    """tests/test_infra.py's case on a scripted clock: ten steps of
    0.02 s, the eighth 0.08 s, flagged once; the EWMA skips it."""
    steps = [0.02 if i != 7 else 0.08 for i in range(10)]
    clock = iter(np.cumsum([x for s in steps for x in (0.5, s)]).tolist())
    monkeypatch.setattr(TE, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock)))
    seen = []
    mon = TE.StragglerMonitor(threshold=1.5, min_samples=2,
                              on_straggler=lambda dt, ew: seen.append(dt))
    flags = []
    for _ in steps:
        mon.start()
        flags.append(mon.stop())
    assert flags == [i == 7 for i in range(10)]
    assert mon.flags == 1 and seen == [pytest.approx(0.08)]
    assert mon.ewma == pytest.approx(0.02)
    assert obs.counter("ft.straggler.flags").value == 1


# ------------------------------------------------ side by side: the fleet --

@pytest.mark.parametrize("n_hosts,wire", [(1, "f32"), (2, "f32"),
                                          (4, "f32"), (4, "bf16")])
def test_fleet_matches_reference(stores, ref_seeds, n_hosts, wire):
    """Both packages' fleets on the same store from the reference's
    seeds: the same live set and row count, centers within 1e-5, the
    objective within 1e-5 relative."""
    ref_store, store, _ = stores
    fleet = dict(n_hosts=n_hosts, shards_per_host=2, wire=wire)
    ref = RF.fleet_fit(ref_store, REF_CFG, RF.FleetConfig(**fleet),
                       v_init=ref_seeds)
    port = TF.fleet_fit(store, CFG, TF.FleetConfig(**fleet),
                        v_init=ref_seeds, **CPU)
    assert port.live == ref.live and port.n_rows == ref.n_rows
    assert port.epoch == ref.epoch == 0
    np.testing.assert_allclose(port.centers, np.asarray(ref.centers),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.masses, np.asarray(ref.masses),
                               rtol=1e-4)
    assert abs(port.objective - ref.objective) / ref.objective < 1e-5


def test_plan_fingerprints_match_reference(stores):
    """Hosts of both packages derive the same plans, before and after a
    replan, so their frames' fingerprints agree."""
    ref_store, store, _ = stores
    for n in (1, 3, 6, 8, 20, 25):
        assert TD.plan_partitions(store, n).fingerprint() == \
            ref_plan_partitions(ref_store, n).fingerprint()
    for hosts, per in ((3, 2), (4, 1), (2, 3)):
        fleet = dict(n_hosts=hosts, shards_per_host=per)
        r = RF.FleetHost(0, ref_store, REF_CFG, RF.FleetConfig(**fleet),
                         RF.MailboxTransport())
        p = TF.FleetHost(0, store, CFG, TF.FleetConfig(**fleet),
                         TF.MailboxTransport(), **CPU)
        assert p.plan.fingerprint() == r.plan.fingerprint()
        assert p.my_shards() == r.my_shards() and p.my_rows() == r.my_rows()
        assert p.handle_loss([hosts - 1]) == r.handle_loss([hosts - 1])
        assert p.plan.fingerprint() == r.plan.fingerprint()
        assert p.epoch == r.epoch == 1


def test_exchange_frames_match_reference(stores, ref_seeds):
    """One host of each package over the same shards: the posted summary
    frames decode to stacks within 1e-5, their headers equal."""
    ref_store, store, _ = stores
    fleet = dict(n_hosts=2, shards_per_host=2, gather_timeout_s=0.1)
    r_tr, p_tr = RF.MailboxTransport(), TF.MailboxTransport()
    r = RF.FleetHost(0, ref_store, REF_CFG, RF.FleetConfig(**fleet), r_tr)
    p = TF.FleetHost(0, store, CFG, TF.FleetConfig(**fleet), p_tr, **CPU)
    for host in (r, p):
        with pytest.raises((RF.HostLost, TF.HostLost)):  # host 1 never posts
            host.exchange(host.local_fit(ref_seeds))
    r_frame = r_tr.gather(0, 0, (0,), "sum", 1.0)[0]
    p_frame = p_tr.gather(0, 0, (0,), "sum", 1.0)[0]
    hlen = int.from_bytes(r_frame[4:8], "little")
    assert p_frame[:8 + hlen] == r_frame[:8 + hlen]
    (rc, rm), _ = RF.decode_summary(r_frame)
    (pc, pm), _ = TF.decode_summary(p_frame)
    np.testing.assert_allclose(pc.numpy(), rc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pm.numpy(), rm, rtol=1e-5)


def _obs_counts(o):
    snap = o.metrics_snapshot()
    return ({k: v for k, v in snap["counters"].items()
             if k.startswith(("fleet.", "ft.", "data."))},
            {k: h["count"] for k, h in snap["histograms"].items()
             if k.startswith("span.") and h["count"]})


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_fleet_obs_matches_reference(stores, ref_seeds, fresh_obs, wire):
    """Instrumented fleets side by side, every pass run (ε < 0: each
    shard runs ``max_iter`` passes in both): the same counters
    (exchange bytes by wire, prefetch bytes, chunk reads) and span
    counts, and one ``fleet.fit.done`` event per host."""
    ref_store, store, _ = stores
    kw = dict(CFG_KW, combiner_eps=-1.0, max_iter=4)
    fleet = dict(n_hosts=2, shards_per_host=2, wire=wire)
    RF.fleet_fit(ref_store, RC.BigFCMConfig(backend="jnp", **kw),
                 RF.FleetConfig(**fleet), v_init=ref_seeds)
    TF.fleet_fit(store, TC.BigFCMConfig(backend="torch", **kw),
                 TF.FleetConfig(**fleet), v_init=ref_seeds, **CPU)
    counters, spans = _obs_counts(obs)
    assert (counters, spans) == _obs_counts(ref_obs)
    assert counters[f"fleet.exchange.bytes{{wire={wire}}}"] > 0
    assert spans["span.fleet.shard_fit"] == 4
    assert spans["span.fleet.exchange"] == spans["span.fleet.objective"] == 2
    done = [e for e in obs.ring_events() if e["name"] == "fleet.fit.done"]
    assert sorted(e["host"] for e in done) == [0, 1]


def test_straggler_obs_matches_reference(stores, ref_seeds, fresh_obs):
    """The straggler run in both packages: one detection, one
    ``ft.straggler.flags``, the same moved chunks per survivor."""
    ref_store, store, _ = stores
    ref = RF.fleet_fit(ref_store, REF_CFG,
                       RF.FleetConfig(**_straggler_fleet()), v_init=ref_seeds)
    port = TF.fleet_fit(store, CFG, TF.FleetConfig(**_straggler_fleet()),
                        v_init=ref_seeds, **CPU)
    assert port.live == ref.live == (0, 2)
    assert port.moved_chunks == ref.moved_chunks > 0
    for name in ("fleet.straggler.detected", "ft.straggler.flags",
                 "fleet.replan.moved_chunks"):
        assert obs.counter(name).value == ref_obs.counter(name).value > 0
    np.testing.assert_allclose(port.centers, np.asarray(ref.centers),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------- kill one host -----

_KILL = r"""
import json, os, sys, time
import numpy as np
from repro_torch.core import BigFCMConfig
from repro_torch.data import ChunkStore
from repro_torch.fleet import (FleetConfig, collect_results, fleet_fit,
                               spawn_fleet, watch_fleet)
from repro_torch.fleet.proc import MAIL_DIR

store_dir, fleet_dir, cfg_kw = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
fleet_kw = dict(shards_per_host=2, debug_delay_s={1: 4000.0},
                gather_timeout_s=600.0)
procs = spawn_fleet(3, store_dir, fleet_dir, cfg_kw, fleet_kw, device="cpu")
try:
    mail = os.path.join(fleet_dir, MAIL_DIR)
    deadline = time.monotonic() + 400
    while not all(os.path.exists(os.path.join(mail, f"e0000.sum.h{h:04d}.bin"))
                  for h in (0, 2)):
        assert time.monotonic() < deadline, "survivors never posted"
        time.sleep(0.1)
    procs[1].terminate()
    watch_fleet(procs, fleet_dir, timeout_s=400)
finally:
    for p in procs.values():
        if p.is_alive():
            p.terminate()
        p.join(timeout=30)
results = collect_results(fleet_dir, 3)
born2 = fleet_fit(ChunkStore.open(store_dir), BigFCMConfig(**cfg_kw),
                  FleetConfig(n_hosts=2, shards_per_host=2), device="cpu")
out = {"codes": {h: p.exitcode for h, p in procs.items()},
       "hosts": sorted(results),
       "born2": {"centers": born2.centers.tolist(),
                 "objective": born2.objective}}
for h, r in results.items():
    out[str(h)] = {k: np.asarray(v).tolist() for k, v in r.items()}
print("FLEET_KILL " + json.dumps(out))
"""


def test_kill_one_host_replans_and_converges(stores, tmp_path):
    """tests/test_fleet_elastic.py's kill-one-host article on the port:
    three spawned CPU host processes over the on-disk store, host 1
    stopped once hosts 0 and 2 have posted; the survivors exit 0, agree
    bit for bit, replan to the reference's moved count (each process's
    own obs counter too) and land on a fleet born at 2 hosts."""
    ref_store, _, store_dir = stores
    cfg_kw = dict(CFG_KW, backend="torch")
    out = subprocess.run(
        [sys.executable, "-c", _KILL, store_dir, str(tmp_path / "run"),
         json.dumps(cfg_kw)], capture_output=True, text=True, timeout=600,
        # one intra-op thread per host process: four interpreters share
        # the test host with the other workers
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("FLEET_KILL ")]
    assert line, (out.stdout[-1500:], out.stderr[-2500:])
    res = json.loads(line[0][len("FLEET_KILL "):])
    assert res["hosts"] == [0, 2]
    assert res["codes"]["0"] == res["codes"]["2"] == 0
    assert res["codes"]["1"] != 0
    r0, r2 = res["0"], res["2"]
    _, moved = ref_replan(ref_store, ref_plan_partitions(
        ref_store, 6), 4)
    assert r0["live"] == r2["live"] == [0, 2]
    assert r0["epoch"] == 1 and r0["n_rows"] == 20000
    assert r0["moved_chunks"] == r2["moved_chunks"] == moved > 0
    assert r0["obs_moved"] == r2["obs_moved"] == moved
    assert r0["centers"] == r2["centers"]
    assert r0["objective"] == r2["objective"]
    np.testing.assert_allclose(np.asarray(r0["centers"]),
                               np.asarray(res["born2"]["centers"]),
                               rtol=0, atol=1e-5)
    assert abs(r0["objective"] - res["born2"]["objective"]) / \
        res["born2"]["objective"] < 1e-5


# ------------------------------------------------------------- mr_kmeans --

def test_mr_kmeans_matches_reference():
    """Mahout-KM on separable blobs: the port's centers within 1e-5 of
    the reference's, the same counts and the same number of jobs."""
    x, _ = RD.make_blobs(6000, 5, 4, seed=11)
    init = x[np.random.default_rng(2).choice(len(x), 4, replace=False)]
    r_c, r_n, r_i, r_jobs, _ = RB.mr_kmeans(x, init)
    p_c, p_n, p_i, p_jobs, elapsed = TB.mr_kmeans(x, init, **CPU)
    assert p_jobs == r_jobs
    np.testing.assert_allclose(p_c.numpy(), np.asarray(r_c), rtol=0,
                               atol=1e-5)
    assert np.array_equal(p_n.numpy(), np.asarray(r_n))
    assert float(p_n.sum()) == len(x)
    assert abs(float(p_i) - float(r_i)) / float(r_i) < 1e-5
    assert elapsed >= 0


def test_mr_kmeans_empty_cluster_keeps_its_center():
    """A center no record is nearest to stays where it was, in both."""
    x, _ = RD.make_blobs(2000, 3, 2, seed=1)
    init = np.concatenate([x[:2], np.full((1, 3), 1e4, np.float32)])
    r_c, r_n, *_ = RB.mr_kmeans(x, init, max_iter=5)
    p_c, p_n, *_ = TB.mr_kmeans(x, init, max_iter=5, **CPU)
    assert float(p_n[2]) == 0.0
    np.testing.assert_array_equal(p_c[2].numpy(), init[2])
    np.testing.assert_allclose(p_c.numpy(), np.asarray(r_c), rtol=0,
                               atol=1e-5)
    with pytest.raises(NotImplementedError):
        TB.mr_kmeans(x, init, mesh=object(), **CPU)


# ------------------------------------------ the wrappers' launch counts --

def test_launch_counts_exact_under_thread_contention():
    """Eight threads count 2,000 launches each on one wrapper, with the
    interpreter switching threads every microsecond: no update lost."""
    fn = types.SimpleNamespace()
    fcm_update.reset_counts()
    fn.launches, fn.shapes = 0, fcm_update.collections.Counter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda k=k: [
            fcm_update._count(fn, ("rows", k % 2, 5)) for _ in range(2000)])
            for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert fn.launches == 16000
    assert fn.shapes == {("rows", 0, 5): 8000, ("rows", 1, 5): 8000}
