"""`repro_torch.obs` against `repro.obs`: the metrics and tracing plane's
own behaviour (tests/test_obs.py's stdlib cases, run on the port's copy),
and instrumented runs side by side — the same numpy inputs through
`repro` (backend "jnp", as the reference's own obs tests run) and
`repro_torch` (``device="cpu"``, backend "torch"), both registries reset
first — whose deterministic counters, span counts and phase sets must be
equal.  No wall-clock overhead race: an ingest's obs calls are counted
instead (the card measures what each one costs, `chip_smoke.py`)."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.data as RD
import repro.serve as RSV
import repro.stream as RS
import repro.stream.streaming as RSS
import repro.tenant as RT
import repro_torch.core as TC
import repro_torch.data as TD
import repro_torch.serve as TSV
import repro_torch.stream as TS
import repro_torch.stream.streaming as TSS
import repro_torch.tenant as TT
from repro import obs as ref_obs
from repro.core.bigfcm import _sample_rows
from repro.ft import CheckpointManager as RefCkpt
from repro_torch import obs
from repro_torch.ft import CheckpointManager as PortCkpt
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def fresh_obs():
    """Both registries and rings empty, obs on; back to the environment's
    setting afterwards."""
    for o in (obs, ref_obs):
        o.set_enabled(True)
        o.reset_all()
    yield
    for o in (obs, ref_obs):
        o.reset_all()
        o.set_enabled(None)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# ------------------------------------------------------------- metrics ---

@pytest.mark.parametrize("labels", [{}, {"be": "torch"}])
def test_counter_and_gauge_basics(labels):
    c = obs.counter("t.c", **labels)
    c.add()
    c.add(2.5)
    assert obs.counter("t.c", **labels) is c    # registry: same series
    assert c.value == 3.5
    g = obs.gauge("t.g", **labels)
    g.set(7)
    g.set(3)
    assert g.value == 3 and g.max == 7


def test_counter_labels_are_independent_series():
    obs.counter("t.lc", be="torch").add(1)
    obs.counter("t.lc", be="hopper").add(5)
    obs.counter("t.lc").add(2)
    snap = obs.metrics_snapshot()["counters"]
    assert snap == {"t.lc{be=torch}": 1, "t.lc{be=hopper}": 5, "t.lc": 2}
    with pytest.raises(TypeError, match="already registered"):
        obs.gauge("t.lc")


def test_counter_thread_safety_under_producer_threads():
    c = obs.counter("t.mt")
    n_threads, n_adds = 8, 2000

    def work():
        for _ in range(n_adds):
            c.add(1)

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == n_threads * n_adds    # exact: no lost updates


def test_histogram_quantiles_match_numpy_within_bucket_ratio():
    h = obs.histogram("t.h")
    rng = np.random.default_rng(0)
    vals = np.exp(rng.normal(loc=-6.0, scale=1.5, size=5000))
    for v in vals:
        h.observe(float(v))
    ratio = 10.0 ** (1.0 / obs_metrics.PER_DECADE)
    for q in (0.5, 0.9, 0.99):
        exact = float(np.percentile(vals, q * 100))
        assert exact / ratio <= h.quantile(q) <= exact * ratio
    assert h.quantile(0.0) == float(vals.min())
    assert h.quantile(1.0) == float(vals.max())
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(1.5)


def test_histogram_underflow_overflow_answer_min_max():
    h = obs.histogram("t.h2")
    h.observe(1e-9)
    h.observe(5e4)
    assert h.quantile(0.01) == 1e-9
    assert h.quantile(0.99) == 5e4
    assert np.isnan(obs.histogram("t.empty").quantile(0.5))


def test_kill_switch_compiles_to_noops():
    obs.set_enabled(False)
    obs.counter("t.off").add(5)
    obs.gauge("t.off.g").set(1)
    obs.histogram("t.off.h").observe(0.5)
    obs.event("t.off.ev")
    with obs.span("t.off.span"):
        pass
    assert obs.counter("t.off").value == 0
    assert obs.histogram("t.off.h").count == 0
    assert obs.ring_events() == []
    assert obs.metrics_snapshot()["histograms"]["t.off.h"]["count"] == 0


# --------------------------------------------------------------- spans ---

def test_spans_nest_and_record_parent_and_feed_histograms():
    with obs.span("outer"):
        with obs.span("inner", labels={"replica": "r1"}, rows=3):
            pass
    by = {e["name"]: e for e in obs.ring_events()}
    assert by["inner"]["parent"] == "outer"
    assert by["outer"]["parent"] is None
    assert by["inner"]["rows"] == 3 and by["inner"]["replica"] == "r1"
    assert by["inner"]["ts"] <= by["outer"]["ts"] + by["outer"]["dur_s"]
    snap = obs.metrics_snapshot()["histograms"]
    assert snap["span.outer"]["count"] == 1
    assert snap["span.inner"]["count"] == 1             # the aggregate
    assert snap["span.inner{replica=r1}"]["count"] == 1  # and per label


def test_span_stack_isolated_per_thread():
    seen = {}

    def work():
        with obs.span("threaded"):
            pass
        seen["done"] = True

    with obs.span("main_scope"):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    ev = [e for e in obs.ring_events() if e["name"] == "threaded"][0]
    assert ev["parent"] is None
    assert seen["done"]


def test_ring_buffer_evicts_oldest_first():
    obs.set_ring_size(5)
    try:
        for i in range(9):
            obs.event("tick", i=i)
        assert [e["i"] for e in obs.ring_events()] == [4, 5, 6, 7, 8]
    finally:
        obs.set_ring_size(obs_trace._ring_size())


def test_warn_once_dedupes_but_keeps_payload():
    obs_trace._reset_warned()
    with pytest.warns(RuntimeWarning, match="probe blew up"):
        assert obs.warn_once("t_probe", "probe blew up", error="E1")
    assert not obs.warn_once("t_probe", "probe blew up again")
    warns = [e for e in obs.ring_events() if e["name"] == "warn.t_probe"]
    assert len(warns) == 1 and warns[0]["error"] == "E1"
    obs_trace._reset_warned()


# ---------------------------------------------------------- JSONL sink ---
# Each test passes `flush_jsonl` an explicit path: a test process holds
# both packages, and two atexit hooks must not write one file.

def test_jsonl_round_trip_and_snapshot_line(tmp_path):
    obs.counter("t.rt").add(3)
    with obs.span("t.rt.span"):
        pass
    obs.event("t.rt.ev", detail="x")
    path = str(tmp_path / "events.jsonl")
    assert obs.flush_jsonl(path) == path
    evs = obs.load_jsonl(path)
    kinds = [e["kind"] for e in evs]
    assert kinds.count("span") == 1 and kinds.count("event") == 1
    assert kinds[-1] == "snapshot"
    assert evs[-1]["metrics"]["counters"]["t.rt"] == 3
    text = obs.render_report(evs)
    assert "t.rt.span" in text and "t.rt" in text


def test_flush_without_a_sink_writes_nothing(monkeypatch):
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    assert obs.flush_jsonl() is None


def test_jsonl_tolerates_corrupt_lines(tmp_path):
    path = str(tmp_path / "events.jsonl")
    good = {"kind": "span", "name": "ok", "ts": 1.0, "dur_s": 0.5}
    with open(path, "w") as f:
        f.write(json.dumps(good) + "\n")
        f.write("{truncated json li\n")
        f.write("[1, 2, 3]\n")
        f.write(json.dumps(dict(good, name="ok2")) + "\n")
    assert [e["name"] for e in obs.load_jsonl(path)] == ["ok", "ok2"]
    assert obs.load_jsonl(str(tmp_path / "missing.jsonl")) == []


def test_report_main_renders_phase_table(tmp_path, capsys):
    with obs.span("demo.phase"):
        pass
    obs.counter("demo.count").add(2)
    obs.gauge("demo.gauge").set(4)
    obs.event("demo.event", k=1)
    path = str(tmp_path / "events.jsonl")
    obs.flush_jsonl(path)
    from repro_torch.obs.report import main
    assert main(["--jsonl", path, "--events", "1"]) == 0
    out = capsys.readouterr().out
    assert "demo.phase" in out and "p99_ms" in out
    assert "demo.count" in out and "demo.gauge" in out
    assert "demo.event" in out


def test_phase_breakdown_live_vs_jsonl_agree(tmp_path):
    for _ in range(4):
        with obs.span("agree.phase"):
            pass
    live = {r["phase"]: r for r in obs.phase_breakdown()}
    path = str(tmp_path / "events.jsonl")
    obs.flush_jsonl(path)
    sunk = {r["phase"]: r for r in obs.phase_breakdown(obs.load_jsonl(path))}
    assert live["agree.phase"]["count"] == sunk["agree.phase"]["count"] == 4
    assert sunk["agree.phase"]["total_s"] == \
        pytest.approx(live["agree.phase"]["total_s"], rel=1e-6)


def test_lazy_report_names_and_the_reference_schema():
    """The lazy `report` names, and the public names of `repro.obs`."""
    assert set(obs.__all__) == set(ref_obs.__all__)
    assert obs.snapshot()["metrics"] == obs.metrics_snapshot()
    with pytest.raises(AttributeError):
        obs.no_such_name


# ----------------------------------------------- side by side: counters --

def _counters(o, prefix):
    return {k: v for k, v in o.metrics_snapshot()["counters"].items()
            if k.startswith(prefix)}


def _span_counts(o):
    return {k: h["count"]
            for k, h in o.metrics_snapshot()["histograms"].items()
            if k.startswith("span.") and h["count"]}


def _phases(o):
    return {r["phase"] for r in o.phase_breakdown()}


def _counting_chunk(monkeypatch, cls):
    """Wrap ``cls.chunk`` to count its calls independently of obs."""
    calls = {"n": 0}
    orig = cls.chunk

    def counting(self, i):
        calls["n"] += 1
        return orig(self, i)
    monkeypatch.setattr(cls, "chunk", counting)
    return calls


def test_store_fit_and_scoring_counters_match_reference(tmp_path,
                                                       monkeypatch):
    """tests/test_obs.py's acceptance run in both packages — ChunkStore
    ingest, `bigfcm_fit_store` from the same draws, `assign_store` —
    with every pass run (ε < 0: the pass count is ``max_iter`` in both),
    chunk reads counted against a wrapped `ChunkStore.chunk`."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1200, 3)).astype(np.float32)
    kw = dict(n_clusters=3, max_iter=15, sample_size=128, use_driver=False,
              combiner_eps=-1.0)
    rcfg = RC.BigFCMConfig(backend="jnp", **kw)
    k_sample, k_seed = jax.random.split(jax.random.PRNGKey(rcfg.seed))
    sample_idx = _sample_rows(k_sample, 1200, 128)
    seed_idx = np.asarray(jax.random.choice(k_seed, 128, (3,),
                                            replace=False))
    stores = {}
    for pkg, data in (("ref", RD), ("port", TD)):
        stores[pkg] = data.ChunkStore.ingest(
            x, chunk_rows=300, cache_dir=str(tmp_path / pkg))
    assert _counters(obs, "data.") == _counters(ref_obs, "data.") == {
        "data.cache.chunks_written": 4,
        "data.cache.cold_parse_bytes": x.nbytes}
    assert _span_counts(obs) == _span_counts(ref_obs) == {
        "span.data.ingest": 1}
    obs.reset_all()
    ref_obs.reset_all()
    ref_calls = _counting_chunk(monkeypatch, RD.ChunkStore)
    port_calls = _counting_chunk(monkeypatch, TD.ChunkStore)
    ref = RC.bigfcm_fit_store(stores["ref"], rcfg)
    port = TC.bigfcm_fit_store(stores["port"],
                               TC.BigFCMConfig(backend="torch", **kw),
                               sample_idx=sample_idx, seed_idx=seed_idx,
                               **CPU)
    np.testing.assert_allclose(_np(port.centers), np.asarray(ref.centers),
                               rtol=0, atol=1e-4)
    r_out = list(RSV.assign_store(stores["ref"], ref.centers, backend="jnp"))
    p_out = list(TSV.assign_store(stores["port"], port.centers,
                                  backend="torch", **CPU))
    assert len(p_out) == len(r_out) == 4
    assert ref_calls["n"] == port_calls["n"] > 0
    got, want = _counters(obs, ""), _counters(ref_obs, "")
    assert got == want
    assert got["data.cache.chunk_reads"] == port_calls["n"]
    assert got["serve.records"] == 1200
    assert "data.cache.warm_mem_bytes" not in got
    assert _span_counts(obs) == _span_counts(ref_obs)
    assert _phases(obs) == _phases(ref_obs) >= {
        "engine.fit_store", "engine.combiner", "engine.sweep",
        "engine.merge", "serve.assign"}
    h = obs.metrics_snapshot()["histograms"]["span.serve.assign"]
    assert h["count"] == 4 and 0 < h["p50"] <= h["p99"]
    # the per-pass series and the fit's end, field for field
    names = ("engine.fit.iter", "engine.fit.done")
    for name in names:
        p_ev = [e for e in obs.ring_events() if e["name"] == name]
        r_ev = [e for e in ref_obs.ring_events() if e["name"] == name]
        assert len(p_ev) == len(r_ev) > 0
        for a, b in zip(p_ev, r_ev):
            assert set(a) == set(b)
    iters = [e for e in obs.ring_events() if e["name"] == "engine.fit.iter"]
    assert [e["i"] for e in iters] == list(range(15))
    ref_iters = [e for e in ref_obs.ring_events()
                 if e["name"] == "engine.fit.iter"]
    for a, b in zip(iters, ref_iters):
        assert a["objective"] == pytest.approx(b["objective"], rel=1e-4)


def test_in_memory_fit_events_match_reference():
    """`bigfcm_fit` in memory: one ``engine.fit`` span, the driver race
    and the fit's end as events with the reference's fields."""
    x, _ = RD.make_blobs(2000, 4, 3, seed=3)
    kw = dict(n_clusters=3, sample_size=256, max_iter=100)
    RC.bigfcm_fit(x, RC.BigFCMConfig(backend="jnp", **kw))
    TC.bigfcm_fit(x, TC.BigFCMConfig(backend="torch", **kw), **CPU)
    assert _span_counts(obs) == _span_counts(ref_obs) == {"span.engine.fit": 1}
    for name in ("engine.driver_race", "engine.fit.done"):
        p_ev = [e for e in obs.ring_events() if e["name"] == name]
        r_ev = [e for e in ref_obs.ring_events() if e["name"] == name]
        assert len(p_ev) == len(r_ev) == 1 and set(p_ev[0]) == set(r_ev[0])
    assert [e for e in obs.ring_events()
            if e["name"] == "engine.fit.done"][0]["backend"] == "torch"


def test_open_or_ingest_hit_miss_counters_match_reference(tmp_path):
    x = np.random.default_rng(1).normal(size=(100, 2)).astype(np.float32)
    for pkg, data in (("ref", RD), ("port", TD)):
        d = str(tmp_path / pkg)
        data.ChunkStore.open_or_ingest(d, x, chunk_rows=50)   # cold: miss
        data.ChunkStore.open_or_ingest(d, x, chunk_rows=50)   # warm: hit
    got = _counters(obs, "data.cache")
    assert got == _counters(ref_obs, "data.cache")
    assert got["data.cache.open_misses"] == got["data.cache.open_hits"] == 1
    assert got["data.cache.chunks_written"] == 2
    assert got["data.cache.cold_parse_bytes"] == x.nbytes


def test_loader_counters_match_reference():
    """An ingest epoch and its resident replay: the batches each package
    takes from its queue and replays from its resident cache."""
    x = np.random.default_rng(4).normal(size=(1000, 3)).astype(np.float32)
    for loader in (RD.ShardedLoader(x, 300, chunk_rows=250),
                   TD.ShardedLoader(x, 300, chunk_rows=250, **CPU)):
        for _ in range(3):
            assert sum(int(b[0].shape[0]) for b in loader) == 1200
    keys = ("data.loader.batches", "data.loader.resident_batches")
    got = {k: obs.counter(k).value for k in keys}
    assert got == {k: ref_obs.counter(k).value for k in keys}
    assert got == {"data.loader.batches": 4,
                   "data.loader.resident_batches": 8}
    for o in (obs, ref_obs):
        assert o.gauge("data.loader.queue_depth").max >= 0
        assert o.counter("data.loader.producer_stall_s").value >= 0


def test_checkpoint_counters_match_reference(tmp_path):
    tree = {"v": np.arange(6, dtype=np.float32).reshape(2, 3)}
    for pkg, ckpt in (("ref", RefCkpt), ("port", PortCkpt)):
        for async_save in (False, True):
            mgr = ckpt(str(tmp_path / f"{pkg}{async_save}"),
                       async_save=async_save)
            mgr.save(1, tree)
            mgr.wait()
            out = mgr.restore(tree)
            np.testing.assert_array_equal(np.asarray(out["v"]), tree["v"])
            mgr.restore_arrays()
    got = _counters(obs, "ft.")
    assert got == _counters(ref_obs, "ft.") == {
        "ft.checkpoint.saves": 2, "ft.checkpoint.restores": 4}
    assert _span_counts(obs) == _span_counts(ref_obs) == {
        "span.ft.checkpoint.save": 2, "span.ft.checkpoint.restore": 4}


@pytest.mark.parametrize("looped", [False, True])
def test_tenant_fit_and_assign_counters_match_reference(looped):
    rng = np.random.default_rng(5)
    data = [(rng.normal(size=(int(rng.integers(8, 40)), 4))
             + 4.0 * (i % 5)).astype(np.float32) for i in range(7)]
    kw = dict(n_clusters=3, seed=11)
    (RT.fit_tenants_looped if looped else RT.fit_tenants)(
        data, RT.TenantFitConfig(backend="jnp", **kw))
    ts = (TT.fit_tenants_looped if looped else TT.fit_tenants)(
        data, TT.TenantFitConfig(backend="torch", **kw), **CPU)
    assert obs.counter("tenant.fit.launches").value == \
        ref_obs.counter("tenant.fit.launches").value == (7 if looped else 1)
    assert _span_counts(obs) == _span_counts(ref_obs) == {
        "span.tenant.fit": 1, "span.tenant.fit{tenants=7}": 1}
    for scorer in (RSV.TenantScorer(RSV.tenant_snapshot(ts)),
                   TSV.TenantScorer(TSV.tenant_snapshot(ts, **CPU), **CPU)):
        scorer.assign(ts.ids[2], data[2][:5])
    assert _span_counts(obs)["span.tenant.assign{tenants=1}"] == \
        _span_counts(ref_obs)["span.tenant.assign{tenants=1}"] == 1


# ------------------------------------------- side by side: the stream ---

@pytest.fixture
def pin_driver(monkeypatch):
    """Both packages' driver race pinned to its FCM branch (Flag = 1), as
    tests/test_torch_stream.py pins it: the same seeds, no wall clock."""
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


def _ref_draws(ref):
    """The reference's (re)seed draws from the key its model holds before
    an ingest — the port's ``draws=``."""
    def draws(x, w, reseeds):
        cfg = ref.cfg
        key = (jax.random.PRNGKey(cfg.seed) if ref.state is None
               else ref.state.key)
        k_sample, k_seed = jax.random.split(key)
        wj = jnp.asarray(_np(w))
        lam = min(cfg.driver_sample, int(jnp.sum(wj > 0)))
        idx = jax.random.choice(k_sample, x.shape[0], (lam,), replace=False,
                                p=wj / jnp.maximum(jnp.sum(wj), 1e-12))
        seed_idx = jax.random.choice(k_seed, lam, (cfg.n_clusters,),
                                     replace=False)
        return np.asarray(idx), np.asarray(seed_idx)
    return draws


def _step_locked(kw, items, ts=False):
    """Both models over ``items``, the port carrying the reference's state
    before each ingest (tests/test_torch_stream.py's step lock); returns
    (reference, port) after the last ingest."""
    ref = RS.StreamingBigFCM(RS.StreamConfig(backend="jnp", **kw))
    port = TS.StreamingBigFCM(TS.StreamConfig(backend="torch", **kw), **CPU)
    port.draws = _ref_draws(ref)
    for item in items:
        x, t = item if ts else (item, None)
        if ref.state is not None:
            port.load_state_arrays({k: np.asarray(v) for k, v in
                                    ref.state_dict().items()})
        pr, rr = port.ingest(x, ts=t), ref.ingest(x, ts=t)
        assert (pr.reseeded, pr.born, pr.died, pr.late_dropped,
                pr.n_centers) == (rr.reseeded, rr.born, rr.died,
                                  rr.late_dropped, rr.n_centers)
    return ref, port


def _blobs(seed, **kw):
    return [x for x, _ in RD.make_moving_blobs(seed=seed, **kw)]


STREAMS = {
    # tests/test_stream.py's global drift: one re-seed
    "global_drift": (dict(n_clusters=4, window=3, decay=0.8, max_iter=300,
                          driver_sample=384),
                     lambda: _blobs(5, n_chunks=8, chunk=1500, d=6, c=4,
                                    drift_at=4, shift=10.0), False),
    # its split stream: a birth and a death
    "split": (dict(n_clusters=4, window=3, decay=0.6, max_iter=200,
                   driver_sample=384, death_mass_floor=0.25,
                   reseed_cooldown=2),
              lambda: _blobs(7, n_chunks=10, chunk=1200, d=6, c=4,
                             drift_at=4, shift=12.0, drift_clusters=(0,)),
              False),
    # event time, a batch wholly behind the watermark: late drops
    "event_time": (dict(n_clusters=3, window=8, decay=0.9, max_iter=200,
                        driver_sample=256, event_time=True, slot_span=10.0,
                        allowed_lateness=20.0),
                   lambda: list(RD.replay_source(
                       RD.make_blobs(2000, 5, 3, seed=2)[0], 500,
                       timestamps=np.arange(2000, dtype=np.float64) * 0.01))
                   + [(np.zeros((300, 5), np.float32), np.full(300, 1.0))],
                   True),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_counters_match_reference(pin_driver, name):
    kw, make, ts = STREAMS[name]
    items = make()
    ref, port = _step_locked(dict(seed=0, **kw), items, ts=ts)
    keys = ("stream.records", "stream.births", "stream.deaths",
            "stream.reseeds", "stream.late_dropped")
    got = {k: obs.counter(k).value for k in keys}
    assert got == {k: ref_obs.counter(k).value for k in keys}
    assert got["stream.records"] == sum(
        len(i[0] if ts else i) for i in items)
    assert got["stream.births"] == int(port.state.births)
    assert got["stream.deaths"] == int(port.state.deaths)
    assert got["stream.reseeds"] == int(port.state.reseeds)
    assert got["stream.late_dropped"] == int(port.state.late_dropped)
    assert any(got[k] for k in keys[1:])       # each stream exercises one
    g, rg = obs.gauge("stream.n_centers"), ref_obs.gauge("stream.n_centers")
    assert (g.value, g.max) == (rg.value, rg.max)
    assert _span_counts(obs) == _span_counts(ref_obs)
    assert _span_counts(obs)["span.stream.ingest"] == len(items)
    assert _phases(obs) == _phases(ref_obs) == {"stream.ingest",
                                               "stream.window_merge"}
    # frozen scoring replicas: one span and the records per chunk
    obs.reset_all()
    ref_obs.reset_all()
    x = items[1][0] if ts else items[1]
    list(TSV.assign_stream(port, [x, x[:7]], update=False))
    list(RSV.assign_stream(ref, [x, x[:7]], update=False))
    assert obs.counter("serve.records").value == \
        ref_obs.counter("serve.records").value == len(x) + 7
    assert _span_counts(obs) == _span_counts(ref_obs) == {
        "span.serve.assign": 2}


def test_stream_records_count_a_loaders_real_rows_only():
    """The port labels and counts real rows: a loader's phantom-padded tail
    batch adds its real rows to ``stream.records``."""
    x, _ = TD.make_blobs(1000, 3, 2, seed=1)
    model = TS.StreamingBigFCM(TS.StreamConfig(n_clusters=2, window=2,
                                               driver_sample=64,
                                               backend="torch"), **CPU)
    list(TSV.assign_stream(model, TD.stream_loader(
        TD.replay_source(x, 300), 300, **CPU)))
    assert obs.counter("stream.records").value == 1000
    assert obs.counter("serve.records").value == 1000
    assert _span_counts(obs)["span.stream.ingest"] == 4


# ------------------------------------------------------- the obs budget --

class _CountCalls:
    """Counts calls of the package-level obs entry points the instrumented
    modules go through (``obs.span``, ``obs.counter(...).add``, ...)."""

    NAMES = ("span", "counter", "gauge", "histogram", "event")

    def __init__(self, monkeypatch):
        self.calls = 0
        for name in self.NAMES:
            monkeypatch.setattr(obs, name, self._wrap(getattr(obs, name)))

    def _wrap(self, fn):
        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        return counted


def _stationary_model():
    x, _ = TD.make_blobs(6000, 5, 3, seed=2)
    model = TS.StreamingBigFCM(TS.StreamConfig(n_clusters=3, window=3,
                                               driver_sample=256,
                                               backend="torch"), **CPU)
    return model, [x[i:i + 1000] for i in range(0, 6000, 1000)]


def test_ingest_with_obs_disabled_records_nothing():
    model, chunks = _stationary_model()
    obs.set_enabled(False)
    for x in chunks[:3]:
        model.ingest(x)
    snap = obs.metrics_snapshot()
    assert not any(snap["counters"].values())
    assert all(h["count"] == 0 for h in snap["histograms"].values())
    assert all(g["max"] == float("-inf") for g in snap["gauges"].values())
    assert obs.ring_events() == []


def test_ingest_makes_a_fixed_small_number_of_obs_calls(monkeypatch):
    """A steady ingest (no drift, birth or death) makes the same few obs
    calls each time: the ``stream.ingest`` and ``stream.window_merge``
    spans, ``stream.records`` and the ``stream.n_centers`` gauge — what
    `chip_smoke.py` prices per ingest on the card."""
    model, chunks = _stationary_model()
    model.ingest(chunks[0])                  # the first ingest seeds
    counter = _CountCalls(monkeypatch)
    per_ingest = []
    for x in chunks[1:]:
        before = counter.calls
        rep = model.ingest(x)
        assert not (rep.drifted or rep.born or rep.died)
        per_ingest.append(counter.calls - before)
    assert per_ingest == [4] * len(per_ingest)
