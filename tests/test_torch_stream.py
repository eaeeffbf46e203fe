"""`repro_torch`'s streaming plane against `repro`'s: the ``windowed`` and
``pairwise`` merge topologies, the window ring, the drift detector, the
stream sources, the loader, `StreamingBigFCM` step by step, `run`'s
channel rules, `assign_stream`, and stream checkpoints read both ways.

Both packages get the same numpy inputs made from a seed.  The reference
runs on its f32 ``jnp`` backend (its "auto" races backends and may pick
bf16 on this host), the port on ``torch`` with ``device="cpu"``.

The stream cases are step-locked: before every ingest the port takes the
reference's state (`StreamingBigFCM.load_state_arrays` of the
reference's ``state_dict()``), both ingest the same batch, and the two
reports and states are held to each other — equal decisions and
counters, centers within 1e-5 of the data's RMS, per-center masses
within 1e-5 of the largest (1e-3 on the split stream, where the test
says why), objectives within 1e-5 relative, equal combiner sweeps.  On
a (re)seed the port is handed the reference's own `jax.random` draws
(`RefDraws`) and both packages' driver
race is pinned to its FCM branch (`pin_driver`): the race is decided by
wall-clock time, so unpinned the two packages could keep different
branches' centers.  The reference's two stream tests that fail on jax
0.9.0 (the split stream's end counts, the mesh combiner) are mirrored
here as per-ingest comparisons and as the port's mesh error."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.data as RD
import repro.engine as RE
import repro.serve as RSV
import repro.stream as RS
import repro.stream.streaming as RSS
import repro_torch.core as TC
import repro_torch.data as TD
import repro_torch.engine as TE
import repro_torch.serve as TSV
import repro_torch.stream as TS
import repro_torch.stream.streaming as TSS
from repro.ft import CheckpointManager as RefCkpt
from repro_torch.ft import CheckpointManager as PortCkpt

CPU = dict(device="cpu")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# ------------------------------------------------------------- helpers --

@pytest.fixture
def pin_driver(monkeypatch):
    """Pin both packages' driver race to its FCM branch (Flag = 1): the
    same seeds, the same sweeps, no wall clock."""
    def ref_driver(x_sample, cfg, key):
        idx = jax.random.choice(key, x_sample.shape[0], (cfg.n_clusters,),
                                replace=False)
        res = RC.fcm(x_sample, jnp.take(x_sample, idx, axis=0), m=cfg.m,
                     eps=cfg.driver_eps, max_iter=cfg.max_iter,
                     backend=cfg.backend)
        return res.centers, True, 0.0, 0.0

    def port_driver(x_sample, cfg, *, seed_idx, device):
        seeds = x_sample[torch.as_tensor(np.asarray(seed_idx, np.int64))]
        res = TC.fcm(x_sample, seeds, m=cfg.m, eps=cfg.driver_eps,
                     max_iter=cfg.max_iter, backend=cfg.backend,
                     device=device)
        return res.centers, True, 0.0, 0.0

    monkeypatch.setattr(RSS, "run_driver", ref_driver)
    monkeypatch.setattr(TSS, "run_driver", port_driver)


class RefDraws:
    """The reference's (re)seed draws (`streaming.py` `_driver_seed` and
    `run_driver`'s seed choice), from the key the reference model holds
    before the ingest — the port's ``draws=``."""

    def __init__(self, ref):
        self.ref = ref
        self.calls = 0

    def __call__(self, x, w, reseeds):
        self.calls += 1
        cfg = self.ref.cfg
        key = (jax.random.PRNGKey(cfg.seed) if self.ref.state is None
               else self.ref.state.key)
        k_sample, k_seed = jax.random.split(key)
        wj = jnp.asarray(_np(w))
        lam = min(cfg.driver_sample, int(jnp.sum(wj > 0)))
        p = wj / jnp.maximum(jnp.sum(wj), 1e-12)
        idx = jax.random.choice(k_sample, x.shape[0], (lam,), replace=False,
                                p=p)
        seed_idx = jax.random.choice(k_seed, lam, (cfg.n_clusters,),
                                     replace=False)
        return np.asarray(idx), np.asarray(seed_idx)


def _pair(seed=0, **kw):
    """A reference model (``jnp``) and its port twin (``torch``, CPU) with
    the reference's draws injected."""
    ref = RS.StreamingBigFCM(RS.StreamConfig(backend="jnp", seed=seed, **kw))
    port = TS.StreamingBigFCM(TS.StreamConfig(backend="torch", seed=seed,
                                              **kw), **CPU)
    port.draws = RefDraws(ref)
    return ref, port


def _carry(ref):
    return {k: np.asarray(v) for k, v in ref.state_dict().items()}


def _hold_step(rr, pr, ref, port, scale, *, iter_slack=0, mass_rtol=1e-5):
    """One step's bars (module note); per-center masses within
    ``mass_rtol`` of the largest."""
    for f in ("step", "drifted", "reseeded", "reason", "late_dropped",
              "born", "died", "n_centers"):
        assert getattr(pr, f) == getattr(rr, f), (f, pr, rr)
    assert pr.watermark == pytest.approx(rr.watermark, rel=1e-6)
    for f in ("objective_pre", "objective_post"):
        a, b = getattr(pr, f), getattr(rr, f)
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(
            b, rel=1e-5), (f, a, b)
    assert pr.mass == pytest.approx(rr.mass, rel=1e-5)
    assert np.all(np.abs(pr.combiner_iters - rr.combiner_iters)
                  <= iter_slack), (pr.combiner_iters, rr.combiner_iters)
    ps, rs = port.state, ref.state
    for f in ("cursor", "step", "since_reseed", "reseeds", "slot_buckets",
              "ages", "late_dropped", "births", "deaths"):
        np.testing.assert_array_equal(_np(getattr(ps, f)),
                                      np.asarray(getattr(rs, f)), err_msg=f)
    assert _np(ps.max_event) == pytest.approx(float(rs.max_event))
    np.testing.assert_allclose(_np(ps.centers), np.asarray(rs.centers),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(_np(ps.win_centers),
                               np.asarray(rs.win_centers), rtol=0,
                               atol=1e-5 * scale)
    for f in ("weights", "win_weights"):
        want = np.asarray(getattr(rs, f))
        np.testing.assert_allclose(
            _np(getattr(ps, f)), want, rtol=mass_rtol,
            atol=mass_rtol * float(np.abs(want).max(initial=0.0)), err_msg=f)
    assert port.detector.n == ref.detector.n


def step_locked(ref, port, items, *, iter_slack=0, ts=False, mass_rtol=1e-5):
    """Ingest ``items`` ((x, ts) pairs when ``ts``) into both models, the
    port carrying the reference's state before each ingest; returns the
    reference's reports."""
    reps = []
    for item in items:
        x, t = item if ts else (item, None)
        if ref.state is not None:
            port.load_state_arrays(_carry(ref))
        pr = port.ingest(x, ts=t)
        rr = ref.ingest(x, ts=t)
        _hold_step(rr, pr, ref, port, float(np.sqrt(np.mean(x * x))),
                   iter_slack=iter_slack, mass_rtol=mass_rtol)
        reps.append(rr)
    return reps


# ------------------------------------------------------------ merge plans --

def _stack(seed, s=6, c=4, d=5, phantom=(2,)):
    rng = np.random.default_rng(seed)
    truth = rng.normal(0, 5, size=(c, d))
    cent = (truth[None] + rng.normal(0, 0.3, size=(s, c, d))).astype(
        np.float32)
    mass = rng.uniform(1, 20, size=(s, c)).astype(np.float32)
    mass[list(phantom)] = 0.0                     # phantom slots
    return cent, mass


@pytest.mark.parametrize("s", [2, 5, 8])
@pytest.mark.parametrize("topology", ["windowed", "pairwise"])
def test_merge_topologies_match_reference(topology, s):
    cent, mass = _stack(s + 11, s=s, phantom=(1,))
    plan_kw = dict(m=2.0, eps=1e-9, max_iter=200)
    got = TE.merge_summaries(TE.summary(cent, mass, **CPU),
                             TE.MergePlan(topology, **plan_kw),
                             backend="torch")
    want = RE.merge_summaries(RE.summary(cent, mass),
                              RE.MergePlan(topology, **plan_kw),
                              backend="jnp")
    assert got.n_iter == int(want.n_iter)
    for g, e in zip(got.summary, want.summary):
        np.testing.assert_allclose(_np(g), np.asarray(e), rtol=3e-4,
                                   atol=3e-5 * float(np.abs(e).max()))
    # q sums d² of sketch points sitting on or near their centers, where
    # the x² + v² − 2x·v expansion cancels: it is held to that
    # expansion's f32 rounding bound, 2·γ_{d+2}·Σ w (‖x‖² + max ‖v‖²)
    # (γ_k = k·2⁻²⁴), beside the raw-accumulator rtol.
    v2 = float(np.max(np.sum(np.asarray(want.summary.centers) ** 2, -1)))
    q_atol = 2 * (cent.shape[-1] + 2) * 2.0 ** -24 * float(np.sum(
        mass * (np.sum(cent.astype(np.float64) ** 2, -1) + v2)))
    np.testing.assert_allclose(_np(got.objective), float(want.objective),
                               rtol=3e-4, atol=q_atol)


def test_windowed_merge_with_init_and_all_phantom_but_one():
    """``init`` seeds the windowed WFCM; a window with one live slot among
    phantoms merges to that slot."""
    cent, mass = _stack(3, s=4, phantom=(0, 2, 3))
    plan = dict(m=2.0, eps=1e-9, max_iter=200)
    init = cent[1] + 0.2
    got = TE.merge_summaries(TE.summary(cent, mass, **CPU),
                             TE.MergePlan("windowed", **plan),
                             backend="torch", init=torch.from_numpy(init))
    want = RE.merge_summaries(RE.summary(cent, mass),
                              RE.MergePlan("windowed", **plan),
                              backend="jnp", init=jnp.asarray(init))
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(_np(got.summary.centers),
                               np.asarray(want.summary.centers), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(_np(got.summary.centers), cent[1], atol=1e-4)


def test_pairwise_rejects_init_as_the_reference_does():
    cent, mass = _stack(4, s=3)
    for pkg, arr in ((TE, torch.from_numpy), (RE, jnp.asarray)):
        s = pkg.summary(cent, mass, **(CPU if pkg is TE else {}))
        with pytest.raises(ValueError, match="pairwise"):
            pkg.merge_summaries(s, pkg.MergePlan("pairwise"),
                                backend="torch" if pkg is TE else "jnp",
                                init=arr(cent[0]))


# ----------------------------------------------------------------- window --

def test_window_functions_match_reference():
    rng = np.random.default_rng(0)
    w_, c_, d_ = 4, 3, 2
    pc, pw = TS.init_window(w_, c_, d_, **CPU)
    rc, rw = RS.init_window(w_, c_, d_)
    np.testing.assert_array_equal(_np(pc), np.asarray(rc))
    p_cur, r_cur = TS.streaming._i32(0), jnp.int32(0)
    for _ in range(6):                           # wraps the ring
        v = rng.normal(size=(c_, d_)).astype(np.float32)
        m = rng.uniform(0.5, 2, size=(c_,)).astype(np.float32)
        pc, pw, p_cur = TS.push_summary(pc, pw, p_cur, torch.from_numpy(v),
                                        torch.from_numpy(m), decay=0.7)
        rc, rw, r_cur = RS.push_summary(rc, rw, r_cur, jnp.asarray(v),
                                        jnp.asarray(m), decay=0.7)
        assert int(p_cur) == int(r_cur)
        np.testing.assert_array_equal(_np(pc), np.asarray(rc))
        np.testing.assert_allclose(_np(pw), np.asarray(rw), rtol=1e-7)
    assert float(TS.window_mass(pw)) == pytest.approx(
        float(RS.window_mass(rw)), rel=1e-6)
    ps, rs = TS.window_summary(pc, pw), RS.window_summary(rc, rw)
    np.testing.assert_array_equal(_np(ps.centers), np.asarray(rs.centers))
    np.testing.assert_array_equal(_np(TS.init_slot_buckets(5)),
                                  np.asarray(RS.init_slot_buckets(5)))
    assert TS.NO_BUCKET == RS.NO_BUCKET
    for t, wm in ((25.0, 0.0), (45.0, 50.0), (-5.0, -100.0), (9.99, 10.0)):
        assert TS.assign_slot(t, wm, slot_span=10.0, window=4) == \
            RS.assign_slot(t, wm, slot_span=10.0, window=4)


def test_window_decay_halves_old_mass():
    v = torch.ones((2, 2))
    w = torch.ones((2,))
    win_c, win_w = TS.init_window(3, 2, 2, **CPU)
    cur = 0
    for _ in range(3):
        win_c, win_w, cur = TS.push_summary(win_c, win_w, cur, v, w,
                                            decay=0.5)
    got = sorted(_np(win_w).sum(axis=1).tolist())
    np.testing.assert_allclose(got, [0.5, 1.0, 2.0])
    assert cur == 0


@pytest.mark.parametrize("head,to", [(1, 3), (1, 6), (0, 1)])
def test_advance_window_matches_reference_and_retires_stale(head, to):
    rng = np.random.default_rng(head + to)
    ww = rng.uniform(0.5, 2, size=(4, 3)).astype(np.float32)
    sb = np.array([0, 1, TS.NO_BUCKET, -3], np.int32)
    got = TS.advance_window(torch.from_numpy(ww), torch.from_numpy(sb),
                            head, to, decay=0.8)
    want = RS.advance_window(jnp.asarray(ww), jnp.asarray(sb), head, to,
                             decay=0.8)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    # slots whose bucket fell out of the W-bucket span hold no mass
    dead = sb <= to - 4
    assert not _np(got)[dead].any()


def test_place_summary_matches_reference_and_late_equals_on_time():
    """Set, same-bucket merge and late merge, against the reference; then
    the slot algebra of tests/test_event_time.py: merging a late summary,
    scaled by the decay it missed, equals pushing it on time."""
    rng = np.random.default_rng(0)
    W, C, d, decay = 4, 3, 2, 0.8
    plan_kw = dict(m=2.0, eps=1e-12, max_iter=200)
    sums = [(rng.normal(size=(C, d)).astype(np.float32),
             rng.uniform(0.5, 2.0, size=(C,)).astype(np.float32))
            for _ in range(3)]

    def run(pkg, late):
        to = torch.from_numpy if pkg is TS else jnp.asarray
        be = "torch" if pkg is TS else "jnp"
        plan = (TE if pkg is TS else RE).MergePlan("windowed", **plan_kw)
        wc, ww = pkg.init_window(W, C, d, **(CPU if pkg is TS else {}))
        sb = pkg.init_slot_buckets(W)
        (a_c, a_w), (b_c, b_w), (c_c, c_w) = [(to(c), to(m))
                                              for c, m in sums]
        wc, ww, sb = pkg.place_summary(wc, ww, sb, 0, 0, a_c, a_w,
                                       plan=plan, backend=be)
        if not late:
            wc, ww, sb = pkg.place_summary(wc, ww, sb, 0, 0, b_c, b_w,
                                           plan=plan, backend=be)
        ww = pkg.advance_window(ww, sb, 0, 2, decay=decay)
        wc, ww, sb = pkg.place_summary(wc, ww, sb, 2, 2, c_c, c_w,
                                       plan=plan, backend=be)
        if late:
            wc, ww, sb = pkg.place_summary(wc, ww, sb, 0, 0, b_c, b_w,
                                           plan=plan, backend=be,
                                           scale=decay ** 2)
        return [np.asarray(_np(a)) for a in (wc, ww, sb)]

    for late in (False, True):
        got, want = run(TS, late), run(RS, late)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=3e-4, atol=3e-5)
    on_time, late = run(TS, False), run(TS, True)
    np.testing.assert_array_equal(on_time[2], late[2])
    np.testing.assert_allclose(on_time[0], late[0], atol=1e-4)
    np.testing.assert_allclose(on_time[1], late[1], rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------ drift --

def test_drift_detector_copy_flags_as_reference_and_round_trips():
    rng = np.random.default_rng(0)
    cfg = dict(min_batches=3, q_threshold=2.0)
    port, ref = (TS.DriftDetector(TS.DriftConfig(**cfg)),
                 RS.DriftDetector(RS.DriftConfig(**cfg)))
    assert port.outlier_threshold() is None
    stream = [(5.0 + rng.uniform(-0.2, 0.2), 0.05 + rng.uniform(0, 0.01),
               1.0 + rng.uniform(0, 0.1)) for _ in range(8)]
    stream += [(25.0, 3.0, 9.0), (5.1, 0.5, 1.0), (5.0, 0.05, 1.0)]
    for q, sh, resid in stream:
        flags = [(d.objective_drifted(q), d.shift_drifted(sh),
                  d.outlier_threshold()) for d in (port, ref)]
        assert flags[0] == flags[1]
        for d in (port, ref):
            d.observe(q, sh, flags[0][0] or flags[0][1], resid)
    assert port.objective_drifted(25.0) and not port.objective_drifted(5.0)
    for a, b in ((port, ref), (ref, port)):
        tree = {k: np.asarray(v) for k, v in a.state_arrays().items()}
        other = type(b)(b.cfg)
        other.load_state_arrays(tree)
        assert other.n == a.n
        assert other.ewma_q == pytest.approx(a.ewma_q)
        assert other.ewma_shift == pytest.approx(a.ewma_shift)
        assert other.ewma_resid == pytest.approx(a.ewma_resid)
    fresh = TS.DriftDetector()
    fresh.load_state_arrays(RS.DriftDetector().state_arrays())
    assert fresh.ewma_q is None and fresh.n == 0


# ---------------------------------------------------------------- sources --

def _same_chunks(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, e in zip(got, want):
        if isinstance(e, tuple):
            assert isinstance(g, tuple)
            for a, b in zip(g, e):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert np.asarray(g).dtype == np.asarray(e).dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(e))


def test_make_moving_blobs_same_arrays():
    for kw in (dict(drift_at=2), dict(drift_at=1, drift_clusters=(0,),
                                      shift=12.0)):
        _same_chunks(TD.make_moving_blobs(4, 50, 6, 4, seed=7, **kw),
                     RD.make_moving_blobs(4, 50, 6, 4, seed=7, **kw))


def test_iterator_source_rechunks_as_reference():
    parts = [np.ones((5, 2)), np.full((7, 2), 2.0), np.zeros((0, 2)),
             np.full((3, 2), 3.0)]
    ts = [np.arange(5.0), np.arange(5.0, 12.0), np.arange(0.0),
          np.arange(12.0, 15.0)]
    for rows in (None, 4):
        _same_chunks(TD.iterator_source(iter(parts), chunk_rows=rows),
                     RD.iterator_source(iter(parts), chunk_rows=rows))
        _same_chunks(TD.iterator_source(zip(parts, ts), chunk_rows=rows),
                     RD.iterator_source(zip(parts, ts), chunk_rows=rows))
    x = np.ones((4, 2), np.float32)
    with pytest.raises(ValueError, match="mix"):
        list(TD.iterator_source([(x, np.arange(4.0)), x], chunk_rows=3))


@pytest.mark.parametrize("shuffle", [False, True])
def test_replay_source_array_and_store_as_reference(tmp_path, shuffle):
    x = np.arange(202, dtype=np.float32).reshape(101, 2)
    ts = np.arange(101, dtype=np.float64) * 0.5
    kw = dict(epochs=2, shuffle=shuffle, seed=3)
    _same_chunks(TD.replay_source(x, 16, **kw),
                 RD.replay_source(x, 16, **kw))
    _same_chunks(TD.replay_source(x, 16, timestamps=ts, **kw),
                 RD.replay_source(x, 16, timestamps=ts, **kw))
    ref_store = RD.ChunkStore.ingest(x, chunk_rows=24,
                                     cache_dir=str(tmp_path))
    port_store = TD.ChunkStore.open(str(tmp_path))
    _same_chunks(TD.replay_source(port_store, 16, timestamps=ts, **kw),
                 RD.replay_source(ref_store, 16, timestamps=ts, **kw))
    with pytest.raises(ValueError, match="timestamps length"):
        list(TD.replay_source(port_store, 16, timestamps=ts[:5]))


def test_stamp_and_out_of_order_sources_as_reference():
    x = np.arange(400, dtype=np.float32).reshape(200, 2)
    chunks = [x[i:i + 40] for i in range(0, 200, 40)]
    _same_chunks(TD.stamp_source(iter(chunks), start=5.0, dt=0.5),
                 RD.stamp_source(iter(chunks), start=5.0, dt=0.5))
    ts = np.arange(200, dtype=np.float64)
    got = list(TD.out_of_order_source(TD.replay_source(x, 40, timestamps=ts),
                                      skew=7.0, seed=3))
    _same_chunks(got, RD.out_of_order_source(
        RD.replay_source(x, 40, timestamps=ts), skew=7.0, seed=3))
    all_ts = np.concatenate([t for _, t in got])
    np.testing.assert_array_equal(np.sort(all_ts), ts)
    lateness = np.maximum.accumulate(all_ts) - all_ts
    assert 0.0 < float(lateness.max()) <= 7.0
    with pytest.raises(ValueError, match="timestamped"):
        list(TD.out_of_order_source(iter(chunks), skew=1.0))


def test_socket_sim_source_delivers_everything_in_order():
    chunks = [np.full((3, 2), i, np.float32) for i in range(5)]
    stamped = [(c, np.full((3,), float(i))) for i, c in enumerate(chunks)]
    _same_chunks(TD.socket_sim_source(iter(chunks), rate_hz=500.0,
                                      jitter=0.5), chunks)
    _same_chunks(TD.socket_sim_source(iter(stamped)), stamped)

    def poisoned():
        yield chunks[0]
        raise RuntimeError("upstream socket failure")

    with pytest.raises(RuntimeError, match="upstream socket failure"):
        list(TD.socket_sim_source(poisoned()))


# ----------------------------------------------------------------- loader --

def test_parse_records_and_normalize_as_reference():
    with pytest.raises(ValueError, match="ragged"):
        TD.parse_records(["1,2,3", "4,5"])
    lines = ["1, 2,3", "", "4,5,6 ", "7,,8,9"]
    np.testing.assert_array_equal(TD.parse_records(lines),
                                  RD.parse_records(lines))
    np.testing.assert_array_equal(TD.parse_records(["1;2", "3;4"], sep=";"),
                                  RD.parse_records(["1;2", "3;4"], sep=";"))
    x = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    np.testing.assert_array_equal(TD.normalize(x), RD.normalize(x))
    with pytest.raises(ValueError):
        TD.parse_records(["# comment", "1,2"])


@pytest.mark.parametrize("rows", [4, 7, 96])
def test_stream_loader_batches_as_reference_with_phantom_tail(rows):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(250, 3)).astype(np.float32)
    got = list(TD.stream_loader(TD.replay_source(x, 33), rows, **CPU))
    want = list(RD.stream_loader(RD.replay_source(x, 33), rows))
    assert len(got) == len(want) == -(-250 // rows)
    for (gx, gw), (ex, ew) in zip(got, want):
        assert gx.dtype == torch.float32 and tuple(gx.shape) == (rows, 3)
        np.testing.assert_array_equal(_np(gx), np.asarray(ex))
        np.testing.assert_array_equal(_np(gw), np.asarray(ew))
    assert float(sum(float(w.sum()) for _, w in got)) == 250.0


def test_loader_caches_replays_and_goes_resident():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1000, 4)).astype(np.float32)
    loader = TD.ShardedLoader(iter([x[:700], x[700:]]), batch_rows=96,
                              transform=lambda a: 2 * a, **CPU)
    e1 = [(_np(a).copy(), _np(w).copy()) for a, w in loader]
    assert loader.store is not None and loader.store.n_rows == 1000
    np.testing.assert_array_equal(loader.store.materialize(), 2 * x)
    assert loader.resident
    e2 = [(_np(a), _np(w)) for a, w in loader]
    assert len(e1) == len(e2) == -(-1000 // 96)
    for (a1, w1), (a2, w2) in zip(e1, e2):
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(w1, w2)
    big = TD.ShardedLoader(x, batch_rows=96, resident_bytes=1024, **CPU)
    assert sum(float(w.sum()) for _, w in big) == 1000.0
    assert not big.resident and big.store is not None
    assert sum(float(w.sum()) for _, w in big) == 1000.0   # from the store


def test_loader_single_use_stream_errors_and_mesh():
    loader = TD.ShardedLoader(iter([np.ones((8, 2), np.float32)]),
                              batch_rows=4, cache=False, **CPU)
    assert len(list(loader)) == 2 and loader.store is None
    with pytest.raises(RuntimeError, match="single-use"):
        list(loader)

    def poisoned():
        yield np.ones((10, 3), np.float32)
        raise RuntimeError("upstream parse failure")

    with pytest.raises(RuntimeError, match="upstream parse failure"):
        list(TD.ShardedLoader(poisoned(), batch_rows=4, **CPU))
    # on a 1-rank mesh every batch is this rank's whole block (the 4-rank
    # mesh is tests/test_torch_mesh.py's)
    from torch_mesh_jobs import one_rank_mesh
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    with one_rank_mesh() as mesh:
        got = [(_np(a).copy(), _np(w).copy())
               for a, w in TD.stream_loader(iter([x]), 2, mesh=mesh)]
        loader = TD.ShardedLoader(x, 2, **CPU)
        loader.reshard(mesh, ("data",))
        assert [_np(a).tolist() for a, _ in loader] == [x[:2].tolist(),
                                                        x[2:].tolist()]
    assert [a.tolist() for a, _ in got] == [x[:2].tolist(), x[2:].tolist()]
    assert all(w.tolist() == [1.0, 1.0] for _, w in got)


def test_loader_abandoned_epoch_retires_producer_and_dead_one_raises():
    def endless():
        while True:
            yield np.ones((64, 3), np.float32)

    loader = TD.ShardedLoader(endless(), batch_rows=32, cache=False,
                              prefetch=1, **CPU)
    it = iter(loader)
    next(it)
    it.close()
    loader._pump_thread.join(timeout=5)
    assert not loader._pump_thread.is_alive()
    with pytest.raises(RuntimeError, match="already consumed"):
        iter(loader)

    class BrokenPump(TD.ShardedLoader):
        def _pump(self, chunk_iter, q, writer, apply_transform, stop):
            q.put(("batch", (np.ones((4, 3), np.float32),
                             np.ones((4,), np.float32))))

    it = iter(BrokenPump(iter([np.ones((8, 3), np.float32)]), batch_rows=4,
                         **CPU))
    next(it)
    with pytest.raises(RuntimeError, match="producer thread died"):
        next(it)


# ---------------------------------------------------------- step-locked --

def test_initial_key_is_the_references(pin_driver):
    x, _ = TD.make_blobs(300, 3, 2, seed=1)
    for seed in (0, 5, 2 ** 31 - 1):
        port = TS.StreamingBigFCM(TS.StreamConfig(
            n_clusters=2, driver_sample=64, seed=seed, backend="torch"),
            **CPU)
        port.ingest(x)
        np.testing.assert_array_equal(
            _np(port.state.key), np.asarray(jax.random.PRNGKey(seed)))
        assert port.state.key.dtype == torch.uint32


def test_stationary_stream_step_locked(pin_driver):
    ref, port = _pair(n_clusters=3, window=3, max_iter=200,
                      driver_sample=256)
    x, _ = RD.make_blobs(8000, 5, 3, seed=2)
    reps = step_locked(ref, port, RD.replay_source(x, 1000))
    assert port.draws.calls == 1
    assert not any(r.drifted or r.born or r.died for r in reps)


def test_global_drift_stream_step_locked(pin_driver):
    """tests/test_stream.py's acceptance stream: the re-seed step, its
    draws and the driver's seeds match the reference's."""
    ref, port = _pair(n_clusters=4, window=3, decay=0.8, max_iter=300,
                      driver_sample=384)
    chunks = [x for x, _ in RD.make_moving_blobs(8, 1500, 6, 4, drift_at=4,
                                                 shift=10.0, seed=5)]
    reps = step_locked(ref, port, chunks)
    assert [r.reason for r in reps].count("objective") == 1
    assert port.draws.calls == 2 and int(port.state.reseeds) == 1


def test_split_stream_birth_death_step_locked(pin_driver):
    """tests/test_stream.py's birth/death stream (one component splits
    off), held per ingest — the reference's end counts are not a stable
    oracle on jax 0.9.0."""
    ref, port = _pair(n_clusters=4, window=3, decay=0.6, max_iter=200,
                      driver_sample=384, death_mass_floor=0.25,
                      reseed_cooldown=2)
    chunks = [x for x, _ in RD.make_moving_blobs(
        10, 1200, 6, 4, drift_at=4, shift=12.0, seed=7,
        drift_clusters=(0,))]
    # Per-center masses at 1e-3: where the newborn center shares a blob
    # with the starving one it replaces, the split of that blob's mass
    # between the two is ill-conditioned (it parts by up to 1e-3 relative
    # while the centers agree to 1e-6 of the RMS).
    reps = step_locked(ref, port, chunks, mass_rtol=1e-3)
    assert sum(r.born for r in reps) >= 1
    assert int(port.state.reseeds) == 0


def test_sweep_combiner_and_pairwise_window_step_locked(pin_driver):
    ref, port = _pair(n_clusters=3, window=4, decay=0.7, max_iter=200,
                      driver_sample=256, combiner_mode="sweep",
                      merge_plan="pairwise")
    x, _ = RD.make_blobs(3000, 4, 3, seed=8)
    step_locked(ref, port, RD.replay_source(x, 500))


def test_event_time_streams_step_locked(pin_driver):
    """tests/test_event_time.py's streams: in order, out of order within
    a skew below the allowed lateness (same-bucket and late merges), and
    a batch wholly behind the watermark."""
    kw = dict(n_clusters=3, window=8, decay=0.9, max_iter=200,
              driver_sample=256, event_time=True, slot_span=10.0,
              allowed_lateness=20.0)
    x, _ = RD.make_blobs(4000, 5, 3, seed=2)
    ts = np.arange(x.shape[0], dtype=np.float64) * 0.01
    for src in (RD.replay_source(x, 500, timestamps=ts),
                RD.out_of_order_source(RD.replay_source(x, 500,
                                                        timestamps=ts),
                                       skew=5.0, seed=1)):
        ref, port = _pair(**kw)
        items = list(src) + [(x[:300], np.full(300, 1.0))]
        reps = step_locked(ref, port, items, ts=True)
        assert reps[-1].late_dropped == 300
        assert sum(r.late_dropped for r in reps[:-1]) == 0


def test_padded_tail_batch_ingests_as_its_real_rows(pin_driver):
    """A phantom-padded batch (the loader's tail) gives the unpadded
    batch's result: phantoms never seed, probe or merge."""
    x, _ = TD.make_blobs(2600, 4, 3, seed=3)
    cfg = TS.StreamConfig(n_clusters=3, window=3, driver_sample=128,
                          backend="torch")
    draws = (lambda x, w, r: (np.arange(0, 2 * 128, 2),
                              np.array([0, 50, 100])))
    plain = TS.StreamingBigFCM(cfg, draws=draws, **CPU)
    padded = TS.StreamingBigFCM(cfg, draws=draws, **CPU)
    loader = TD.stream_loader(TD.replay_source(x, 1000), 1000, **CPU)
    for (bx, bw), raw in zip(loader, TD.replay_source(x, 1000)):
        a, b = plain.ingest(raw), padded.ingest(bx, bw)
        assert a.objective_pre == pytest.approx(b.objective_pre, rel=1e-5)
        assert a.objective_post == pytest.approx(b.objective_post, rel=1e-5)
        np.testing.assert_allclose(_np(padded.state.centers),
                                   _np(plain.state.centers), atol=1e-4)
    assert bx.shape[0] == 1000 and float(bw.sum()) == 600


def test_default_draws_never_pick_phantom_rows():
    x = np.zeros((400, 2), np.float32)
    x[:100] = np.random.default_rng(0).normal(size=(100, 2))
    w = np.zeros(400, np.float32)
    w[:100] = 1.0
    model = TS.StreamingBigFCM(TS.StreamConfig(n_clusters=2,
                                               driver_sample=512,
                                               backend="torch"), **CPU)
    seen = []
    TSS_run = TSS.run_driver

    def spy(x_sample, cfg, *, seed_idx, device):
        seen.append(x_sample.shape[0])
        assert bool((x_sample.abs().sum(1) > 0).all())
        return TSS_run(x_sample, cfg, seed_idx=seed_idx, device=device)

    TSS.run_driver = spy
    try:
        model.ingest(x, w)
    finally:
        TSS.run_driver = TSS_run
    assert seen == [100]
    with pytest.raises(ValueError, match="zero-mass"):
        TS.StreamingBigFCM(TS.StreamConfig(n_clusters=2, backend="torch"),
                           **CPU).ingest(
            x, np.zeros(400, np.float32))


def test_plain_path_follows_torch_default_dtype_to_float64(pin_driver):
    """With torch's default float type set to float64 (the card run's
    exact witness), a ``torch``-backend stream started from a float32
    model's state keeps every device leaf in float64 and, step-locked on
    the split stream through its birth, lands within f32 rounding of the
    float32 model's step.  (Its eighth step is left out: there the
    newborn and the starving center share one blob, and their positions
    part by 2e-2 of the RMS at an equal objective.)"""
    chunks = [x for x, _ in RD.make_moving_blobs(7, 1200, 6, 4, drift_at=4,
                                                 shift=12.0, seed=7,
                                                 drift_clusters=(0,))]
    cfg = TS.StreamConfig(n_clusters=4, window=3, decay=0.6, max_iter=200,
                          driver_sample=384, death_mass_floor=0.25,
                          reseed_cooldown=2, backend="torch")
    f32 = TS.StreamingBigFCM(cfg, **CPU)
    f32.ingest(chunks[0])
    events = 0
    old = torch.get_default_dtype()
    for x in chunks[1:]:
        pre = f32.state_dict()
        torch.set_default_dtype(torch.float64)
        try:
            f64 = TS.StreamingBigFCM.from_state_arrays(cfg, pre, **CPU)
            b = f64.ingest(x)
        finally:
            torch.set_default_dtype(old)
        a = f32.ingest(x)
        for f in ("centers", "weights", "win_centers", "win_weights"):
            assert getattr(f64.state, f).dtype == torch.float64, f
            assert getattr(f32.state, f).dtype == torch.float32, f
        assert (a.born, a.died, a.reason, a.n_centers) == (
            b.born, b.died, b.reason, b.n_centers)
        assert a.objective_post == pytest.approx(b.objective_post, rel=1e-5)
        np.testing.assert_allclose(
            _np(f32.state.centers), _np(f64.state.centers), rtol=0,
            atol=1e-5 * float(np.sqrt(np.mean(np.square(x)))))
        events += a.born
    assert events == 1


def test_mesh_waits_for_the_multi_gpu_slice(tmp_path, pin_driver):
    """The mesh stream runs: on a 1-rank mesh (the 4-rank mesh is
    tests/test_torch_mesh.py's) it ingests as the plain model does, bit
    for bit, and `restore(mesh=)` puts a checkpoint back onto the mesh."""
    from torch_mesh_jobs import one_rank_mesh
    x, _ = RD.make_blobs(2000, 4, 3, seed=6)
    cfg = TS.StreamConfig(n_clusters=3, window=3, driver_sample=128,
                          backend="torch")
    draws = (lambda x, w, r: (np.arange(0, 256, 2), np.array([0, 40, 80])))
    plain = TS.StreamingBigFCM(cfg, draws=draws, **CPU)
    with one_rank_mesh() as mesh:
        on_mesh = TS.StreamingBigFCM(cfg, mesh=mesh, draws=draws)
        for chunk in RD.replay_source(x, 500):
            a, b = on_mesh.ingest(chunk), plain.ingest(chunk)
            assert a == b
        ckpt = PortCkpt(str(tmp_path), async_save=False)
        on_mesh.save(ckpt)
        back = TS.StreamingBigFCM.restore(ckpt, cfg, d=4, mesh=mesh)
        assert back.mesh is mesh
    for f in TS.StreamState._fields:
        assert torch.equal(getattr(back.state, f),
                           getattr(plain.state, f)), f


# -------------------------------------------------------- run + serving --

def test_run_rejects_mismatched_tuple_channels_as_reference():
    x, y = TD.make_blobs(600, 3, 2, seed=0)
    ts = np.arange(600, dtype=np.float64)
    proc = TS.StreamingBigFCM(TS.StreamConfig(n_clusters=2, window=2,
                                              driver_sample=128,
                                              backend="torch"), **CPU)
    with pytest.raises(ValueError, match="event_time"):
        proc.run(TD.replay_source(x, 300, timestamps=ts))
    with pytest.raises(ValueError, match="labels"):
        proc.run([(x[:300], y[:300])])
    ev = TS.StreamingBigFCM(TS.StreamConfig(
        n_clusters=2, window=8, event_time=True, slot_span=10.0,
        allowed_lateness=20.0, driver_sample=128, backend="torch"), **CPU)
    with pytest.raises(ValueError, match="labels"):
        ev.run([(x[:300], y[:300])])
    with pytest.raises(ValueError, match="labels"):
        ev.run([(x[:300], torch.from_numpy(y[:300]))])
    with pytest.raises(ValueError, match="allowed_lateness"):
        TS.StreamConfig(n_clusters=3, window=4, event_time=True,
                        slot_span=1.0, allowed_lateness=10.0)
    # a loader's (x, w) float32 batches are weights
    reps = proc.run(TD.stream_loader(TD.replay_source(x, 250), 250, **CPU))
    assert [r.step for r in reps] == [1, 2, 3]


def test_assign_stream_matches_make_assigner_and_reference(pin_driver):
    x, _ = RD.make_blobs(3000, 4, 3, seed=4)
    ref, port = _pair(n_clusters=3, window=2, max_iter=150,
                      driver_sample=256)
    outs = list(TSV.assign_stream(port, TD.replay_source(x, 1000)))
    want = list(RSV.assign_stream(ref, RD.replay_source(x, 1000)))
    assert len(outs) == 3
    labels, rep = outs[-1]
    assert labels.shape == (1000,) and rep.step == 3
    frozen = TSV.make_assigner(port.state.centers, backend="torch", **CPU)
    np.testing.assert_array_equal(_np(frozen(x[-1000:])), labels)
    for (a, _), (b, _) in zip(outs, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    soft, none = next(TSV.assign_stream(port, [x[:10]], soft=True,
                                        update=False))
    assert none is None and soft.shape == (10, 3)
    np.testing.assert_allclose(soft.sum(1), 1.0, rtol=1e-5)
    # the loader's padded tail batch: labels for its real rows only
    tail = list(TSV.assign_stream(port, TD.stream_loader(
        TD.replay_source(x, 700), 700, **CPU), update=False))
    assert [t.shape[0] for t, _ in tail] == [700] * 4 + [200]
    np.testing.assert_array_equal(tail[-1][0], _np(frozen(x[-200:])))


def test_snapshot_listener_sees_every_step():
    x, _ = TD.make_blobs(900, 3, 2, seed=6)
    model = TS.StreamingBigFCM(TS.StreamConfig(n_clusters=2, window=2,
                                               driver_sample=64,
                                               backend="torch"), **CPU)
    seen = []
    model.add_snapshot_listener(lambda v, c, w: seen.append((v, c.shape,
                                                             type(c))))
    model.run(TD.replay_source(x, 300))
    assert seen == [(i, (2, 3), np.ndarray) for i in (1, 2, 3)]
    with pytest.raises(RuntimeError, match="no data"):
        TS.StreamingBigFCM(TS.StreamConfig(n_clusters=2, backend="torch"),
                           **CPU).assign(x)


# ------------------------------------------------------------ checkpoint --

@pytest.mark.parametrize("event_time", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stream_checkpoints_cross_read_and_keep_ingesting(
        tmp_path, pin_driver, writer, event_time):
    kw = dict(n_clusters=3, window=6, max_iter=150, driver_sample=256)
    if event_time:
        kw.update(event_time=True, slot_span=12.0, allowed_lateness=24.0)
    x, _ = RD.make_blobs(3000, 4, 3, seed=9)
    ts = np.arange(x.shape[0], dtype=np.float64) * 0.02
    items = list(RD.replay_source(x, 750, timestamps=ts if event_time
                                  else None))
    ref, port = _pair(**kw)
    step_locked(ref, port, items[:3], ts=event_time)
    port.load_state_arrays(_carry(ref))
    if writer == "reference":
        src = ref
        ckpt = RefCkpt(str(tmp_path), async_save=False)
        ref.save(ckpt)
        other = TS.StreamingBigFCM.restore(
            PortCkpt(str(tmp_path)), TS.StreamConfig(backend="torch", **kw),
            d=4, **CPU)
        np.testing.assert_array_equal(_np(other.state.centers),
                                      np.asarray(src.state.centers))
    else:
        src = port
        ckpt = PortCkpt(str(tmp_path), async_save=False)
        port.save(ckpt)
        other = RS.StreamingBigFCM.restore(
            RefCkpt(str(tmp_path)), RS.StreamConfig(backend="jnp", **kw),
            d=4)
        np.testing.assert_array_equal(np.asarray(other.state.centers),
                                      _np(src.state.centers))
    for f in TS.StreamState._fields:
        a, b = np.asarray(_np(getattr(other.state, f))), \
            np.asarray(_np(getattr(src.state, f)))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert other.detector.n == src.detector.n
    # the restored stream keeps ingesting as the writer does
    item = items[3]
    x4, t4 = item if event_time else (item, None)
    ra, rb = other.ingest(x4, ts=t4), src.ingest(x4, ts=t4)
    assert (ra.drifted, ra.n_centers, ra.late_dropped) == \
        (rb.drifted, rb.n_centers, rb.late_dropped)
    assert ra.objective_post == pytest.approx(rb.objective_post, rel=1e-5)
    with pytest.raises(ValueError, match="expected"):
        TS.StreamingBigFCM.restore(PortCkpt(str(tmp_path)),
                                   TS.StreamConfig(**kw), d=5, **CPU)
