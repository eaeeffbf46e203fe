"""The measured performance plane of `repro_torch` against `repro.perf`:
the bucket rule, the calibration cache (reuse, invalidation, corrupt
files, the disable switch, `wipe`, the (device, bucket) memo), the race
rules (parity gate 2e-2, 5 % dethrone margin, the ``torch`` oracle; on
the card only the kernel backends may win, and a wrong one raises),
``torch_bf16`` against the f32 sweep and against the reference's
``jnp_bf16`` at the accumulators and at the fit, launch-plan autotuning
(persistence, pick-up, its 5 % margin, host-bound buckets left
untuned, the plans its choices give), the roofline model
equal to the reference's, and the probes.

Every test that touches the cache runs against its own calibration dir
(``REPRO_CALIB_DIR`` → tmp_path) with both packages' memos cleared.  On
the CPU the race includes the ``hopper`` backends: their wrappers take
the plain versions on CPU tensors.  Autotuning times launch plans on the
card; here its card and timer are stubbed, and the plans it picks are
checked as pure functions (tests/test_torch_cuda.py holds a tuned plan
against the plain version on the card)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.core.metrics as RM
import repro.engine as RE
import repro.obs as ref_obs
import repro.perf as RP
import repro_torch.core as TC
import repro_torch.data.synth as TD
import repro_torch.engine as TE
import repro_torch.obs as port_obs
import repro_torch.perf as TP
from repro.perf import calibrate as ref_calibrate
from repro.perf import microbench as ref_microbench
from repro_torch.engine import backend as backend_mod
from repro_torch.kernels import fcm_update as fu
from repro_torch.kernels.fcm_update import (CT_TILES, PlanChoice,
                                            plan_batched, plan_sweep)
from repro_torch.perf import autotune, calibrate, microbench
from repro_torch.perf.calibrate import (bucket_key, calibrated_backend_name,
                                        load_calibration, race_shape,
                                        shape_bucket)
from repro_torch.perf.roofline import (kernel_roofline, roofline_report,
                                       sweep_bytes, sweep_flops,
                                       sweep_intensity)

CPU = dict(device="cpu")
SHAPE = (300, 3, 4)     # a small bucket: races here take milliseconds
# An H100's numbers for the pure launch plan (132 SMs, 227 KB of shared
# memory per block, two resident CTAs per SM)
CARD = dict(sms=132, smem_limit=232448, ctas_per_sm=2)


@pytest.fixture
def calib_dir(tmp_path, monkeypatch):
    """Isolated calibration store for both packages + cleared memos."""
    monkeypatch.setenv(calibrate.ENV_DIR, str(tmp_path))
    calibrate.clear_memory_cache()
    ref_calibrate.clear_memory_cache()
    yield tmp_path
    calibrate.clear_memory_cache()
    ref_calibrate.clear_memory_cache()


def _stub_race(calls, winner="torch"):
    def race(shape, *, m=2.0, device="cpu", **kw):
        calls.append((tuple(shape), str(device)))
        return winner, {winner: {"us": 1.0, "parity_ok": True,
                                 "center_rel_err": 0.0,
                                 "objective_rel_err": 0.0}}
    return race


def _inputs(n, d, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32))


# ---------------------------------------------------------- bucket rule --

@pytest.mark.parametrize("shape", [(300, 3, 4), (10, 8, 16),
                                   (1 << 24, 129, 1), (4_898_431, 23, 41),
                                   (11_000_000, 2, 28), (262_144, 64, 2048),
                                   (3184, 23, 41), (1, 1, 1)])
def test_shape_bucket_rule_matches_reference(shape):
    bucket = shape_bucket(*shape)
    assert bucket == ref_calibrate.shape_bucket(*shape)
    assert bucket_key(bucket) == ref_calibrate.bucket_key(bucket)
    assert race_shape(bucket) == ref_calibrate.race_shape(bucket)
    assert autotune.tile_key(shape) == bucket_key(bucket)


def test_shape_bucket_rule():
    assert shape_bucket(300, 3, 4) == (512, 4, 4)
    assert shape_bucket(10, 8, 16) == (256, 8, 16)
    assert shape_bucket(1 << 24, 129, 1) == (1 << 20, 256, 1)
    assert race_shape((1 << 20, 8, 16)) == (4096, 8, 16)
    assert race_shape((256, 8, 16)) == (256, 8, 16)
    assert calibrate.DEFAULT_SHAPE == ref_calibrate.DEFAULT_SHAPE
    assert calibrate.CALIB_NAME == "calibration_torch.json" \
        != ref_calibrate.CALIB_NAME
    assert (calibrate.ENV_DIR, calibrate.ENV_DISABLE) == (
        ref_calibrate.ENV_DIR, ref_calibrate.ENV_DISABLE)


# ------------------------------------------------- measured auto-select --

def test_auto_selects_by_measurement(calib_dir):
    """"auto" runs a real race on the CPU, caches the winner on disk,
    and the entry has the reference's fields; every registered backend
    entered the race; the winner won on time among parity-passing
    candidates (near-ties within 5 % go to the ``torch`` oracle)."""
    be = TE.resolve_backend("auto", shape=SHAPE, **CPU)
    path = os.path.join(str(calib_dir), calibrate.CALIB_NAME)
    with open(path) as f:
        data = json.load(f)
    assert data["key"]["device"] == "cpu"
    assert data["key"]["backends"] == sorted(backend_mod._REGISTRY)
    entry = data["winners"][bucket_key(shape_bucket(*SHAPE))]
    assert entry["winner"] == be.name
    assert entry["raced_shape"] == list(race_shape(shape_bucket(*SHAPE)))
    assert set(entry["times_us"]) | set(entry["errors"]) \
        == set(backend_mod._REGISTRY)
    assert entry["parity"][be.name] is True
    assert entry["parity"]["torch"] is True
    eligible = {k: v for k, v in entry["times_us"].items()
                if entry["parity"].get(k)}
    fastest = min(eligible, key=eligible.get)
    assert entry["winner"] == fastest or (
        entry["winner"] == "torch"
        and eligible[fastest] > 0.95 * eligible["torch"])
    # the reference's entry for the same bucket has the same fields
    RE.resolve_backend("auto", shape=SHAPE)
    with open(os.path.join(str(calib_dir), ref_calibrate.CALIB_NAME)) as f:
        ref_entry = json.load(f)["winners"][bucket_key(shape_bucket(*SHAPE))]
    assert set(ref_entry) == set(entry)


def test_race_emits_obs_event(calib_dir):
    port_obs.reset_all()
    calibrated_backend_name(SHAPE, **CPU)
    ev = [e for e in port_obs.ring_events()
          if e.get("name") == "perf.calibrate.race"]
    assert len(ev) == 1
    fields = ev[0].get("fields", ev[0])
    assert fields["bucket"] == bucket_key(shape_bucket(*SHAPE))
    assert set(fields["parity"]) == set(backend_mod._REGISTRY)
    port_obs.reset_all()


def _fake_times(monkeypatch, module, times):
    """Make ``module.time_fn`` report ``times[backend]`` seconds: the
    backend is recognized by the function the race hands it."""
    def fake(fn, *args, **kw):
        be = getattr(fn, "__wrapped__", fn).__defaults__[0]
        return times[be.name]
    monkeypatch.setattr(module, "time_fn", fake)


@pytest.mark.parametrize("ratio,want", [(0.96, "oracle"), (0.94, "bf16"),
                                        (0.5, "bf16"), (1.2, "oracle")])
def test_race_rules_identical_to_reference(calib_dir, monkeypatch, ratio,
                                           want):
    """With the same relative times both races crown the same kind of
    backend: a challenger must beat the oracle by more than 5 %; the
    parity gate is 2e-2 on centers and objective."""
    others = {"hopper": 9.0, "hopper_accumulate": 9.0}
    _fake_times(monkeypatch, microbench,
                {"torch": 1.0, "torch_bf16": ratio, **others})
    _fake_times(monkeypatch, ref_microbench,
                {"jnp": 1.0, "jnp_bf16": ratio, "pallas": 9.0,
                 "pallas_accumulate": 9.0})
    port, port_res = calibrate.race_backends((256, 4, 8), **CPU)
    ref, ref_res = ref_calibrate.race_backends((256, 4, 8))
    assert port == {"oracle": "torch", "bf16": "torch_bf16"}[want]
    assert ref == {"oracle": "jnp", "bf16": "jnp_bf16"}[want]
    assert port_res["torch_bf16"]["parity_ok"] == \
        ref_res["jnp_bf16"]["parity_ok"] is True


def test_parity_gate_disqualifies_fast_wrong_backend(calib_dir, monkeypatch):
    class Wrong(backend_mod.TorchBackend):
        name = "wrong_test_backend"

        def sweep(self, x, w, centers, m):
            v, wi, q = super().sweep(x, w, centers, m)
            return v * 1.05, wi, q

    class Broken(backend_mod.TorchBackend):
        name = "broken_test_backend"

        def sweep(self, x, w, centers, m):
            raise RuntimeError("broken")

    for be in (Wrong(), Broken()):
        backend_mod.register_backend(be)
    try:
        _fake_times(monkeypatch, microbench,
                    {"torch": 1.0, "torch_bf16": 1.0, "hopper": 1.0,
                     "hopper_accumulate": 1.0, "wrong_test_backend": 0.01})
        winner, res = calibrate.race_backends((256, 4, 8), **CPU)
        assert winner == "torch"
        assert res["wrong_test_backend"]["parity_ok"] is False
        assert res["wrong_test_backend"]["center_rel_err"] > 2e-2
        assert "broken" in res["broken_test_backend"]["error"]
    finally:
        backend_mod._REGISTRY.pop("wrong_test_backend", None)
        backend_mod._REGISTRY.pop("broken_test_backend", None)


def _results(us, parity=None):
    parity = parity or {}
    return {k: {"us": t, "parity_ok": parity.get(k, True)}
            for k, t in us.items()}


@pytest.mark.parametrize("us,want", [
    # the plain backends are timed but cannot win on the card
    ({"torch": 1.0, "torch_bf16": 0.5, "hopper": 9.0,
      "hopper_accumulate": 9.5}, "hopper"),
    # between the kernels the 5 % margin holds, with hopper the incumbent
    ({"torch": 9.0, "torch_bf16": 9.0, "hopper": 1.0,
      "hopper_accumulate": 0.96}, "hopper"),
    ({"torch": 9.0, "torch_bf16": 9.0, "hopper": 1.0,
      "hopper_accumulate": 0.94}, "hopper_accumulate"),
    ({"torch": 0.1, "torch_bf16": 9.0, "hopper": 2.0,
      "hopper_accumulate": 1.0}, "hopper_accumulate")])
def test_card_race_crowns_only_kernel_backends(us, want):
    """On a CUDA device "auto" always lands on a hand-written kernel:
    ``torch`` and ``torch_bf16`` are timed, never crowned."""
    assert calibrate.pick_winner(_results(us), device_type="cuda") == want


@pytest.mark.parametrize("us,want", [
    ({"torch": 1.0, "torch_bf16": 0.94, "hopper": 9.0,
      "hopper_accumulate": 9.0}, "torch_bf16"),
    ({"torch": 1.0, "torch_bf16": 0.96, "hopper": 9.0,
      "hopper_accumulate": 9.0}, "torch"),
    ({"torch": 1.0, "torch_bf16": 9.0, "hopper": 0.5,
      "hopper_accumulate": 0.6}, "hopper")])
def test_cpu_race_keeps_the_reference_rules(us, want):
    """On the CPU every parity-true backend may win and ``torch`` is the
    incumbent, as ``jnp`` is the reference's."""
    assert calibrate.pick_winner(_results(us), device_type="cpu") == want


def test_kernel_parity_failure_raises_on_the_card_only():
    us = {"torch": 1.0, "torch_bf16": 0.5, "hopper": 0.2,
          "hopper_accumulate": 0.3}
    bad = _results(us, {"hopper_accumulate": False, "torch_bf16": False})
    with pytest.raises(calibrate.KernelParityError, match="hopper_acc"):
        calibrate.pick_winner(bad, device_type="cuda")
    # a plain backend without parity only loses, on either device
    plain_bad = _results(us, {"torch_bf16": False})
    assert calibrate.pick_winner(plain_bad, device_type="cuda") == "hopper"
    assert calibrate.pick_winner(bad, device_type="cpu") == "hopper"


def test_auto_passes_a_kernel_parity_failure_on(calib_dir, monkeypatch):
    """A wrong kernel is a fault: "auto" raises instead of warning and
    taking the device rule (which would run that kernel)."""
    def wrong(*a, **k):
        raise calibrate.KernelParityError("hopper disagrees")
    monkeypatch.setattr(calibrate, "calibrated_backend_name", wrong)
    with pytest.raises(calibrate.KernelParityError):
        TE.resolve_backend("auto", shape=SHAPE, **CPU)


def test_cache_reuse_no_rerace(calib_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(calibrate, "race_backends", _stub_race(calls))
    assert calibrated_backend_name(SHAPE, **CPU) == "torch"
    assert len(calls) == 1
    assert calibrated_backend_name(SHAPE, **CPU) == "torch"   # memo
    assert len(calls) == 1
    calibrate.clear_memory_cache()                           # disk hit
    assert calibrated_backend_name(SHAPE, **CPU) == "torch"
    assert len(calls) == 1
    assert calibrated_backend_name((5000, 3, 4), **CPU) == "torch"
    assert len(calls) == 2
    # the memo is keyed by (device, bucket)
    assert ("cpu", bucket_key(shape_bucket(*SHAPE))) in calibrate._MEMO


def test_refresh_reraces_one_bucket(calib_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(calibrate, "race_backends", _stub_race(calls))
    calibrated_backend_name(SHAPE, **CPU)
    calibrated_backend_name((5000, 3, 4), **CPU)
    monkeypatch.setattr(calibrate, "race_backends",
                        _stub_race(calls, "torch_bf16"))
    assert calibrated_backend_name(SHAPE, refresh=True, **CPU) == "torch_bf16"
    winners = load_calibration(**CPU)["winners"]
    assert winners[bucket_key(shape_bucket(*SHAPE))]["winner"] == "torch_bf16"
    assert winners[bucket_key(shape_bucket(5000, 3, 4))]["winner"] == "torch"


def test_cache_invalidates_on_backend_set_change(calib_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(calibrate, "race_backends", _stub_race(calls))
    calibrated_backend_name(SHAPE, **CPU)
    assert len(calls) == 1

    class Dummy(backend_mod.TorchBackend):
        name = "dummy_test_backend"

    backend_mod.register_backend(Dummy())
    try:
        calibrate.clear_memory_cache()
        calibrated_backend_name(SHAPE, **CPU)
        assert len(calls) == 2
    finally:
        backend_mod._REGISTRY.pop("dummy_test_backend", None)
        calibrate.clear_memory_cache()


def test_file_of_another_device_is_discarded(calib_dir, monkeypatch):
    """A winner raced on a card never answers the CPU: the content key
    names the device, so a file keyed for CUDA is discarded here."""
    calls = []
    monkeypatch.setattr(calibrate, "race_backends", _stub_race(calls))
    key = dict(load_calibration(**CPU)["key"], device="cuda",
               device_name="NVIDIA H100 80GB HBM3")
    calibrate.store_calibration({"key": key, "winners": {
        bucket_key(shape_bucket(*SHAPE)): {"winner": "hopper"}},
        "tiles": {}, "peaks": None})
    assert calibrated_backend_name(SHAPE, **CPU) == "torch"
    assert len(calls) == 1


def test_corrupt_cache_falls_back_to_fresh_race(calib_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(calibrate, "race_backends", _stub_race(calls))
    calibrated_backend_name(SHAPE, **CPU)
    path = calibrate.calibration_path()
    with open(path, "w") as f:
        f.write("{ this is not json")
    calibrate.clear_memory_cache()
    assert calibrated_backend_name(SHAPE, **CPU) == "torch"
    assert len(calls) == 2
    with open(path) as f:
        assert json.load(f)["winners"]
    with open(path, "w") as f:
        json.dump({"key": {"format_version": -1}, "winners": {
            "n512_c4_d4": {"winner": "hopper"}}}, f)
    calibrate.clear_memory_cache()
    assert calibrated_backend_name(SHAPE, **CPU) == "torch"
    assert len(calls) == 3


def test_disable_env_skips_measurement(calib_dir, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("race must not run when disabled")
    monkeypatch.setattr(calibrate, "race_backends", boom)
    monkeypatch.setenv(calibrate.ENV_DISABLE, "0")
    assert calibrated_backend_name(SHAPE, **CPU) is None
    assert TE.resolve_backend("auto", shape=SHAPE, **CPU).name == "torch"
    assert TE.resolve_backend(None, **CPU).name == "torch"
    assert TE.default_backend_name("cuda") == "hopper"


def test_wipe_forces_rerace(calib_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(calibrate, "race_backends", _stub_race(calls))
    calibrated_backend_name(SHAPE, **CPU)
    calibrate.wipe()
    assert not os.path.exists(calibrate.calibration_path())
    calibrated_backend_name(SHAPE, **CPU)
    assert len(calls) == 2


def test_perf_failure_falls_back_to_device_rule_with_one_warning(
        calib_dir, monkeypatch):
    def boom(*a, **k):
        raise OSError("calibration store unreadable")
    monkeypatch.setattr(calibrate, "calibrated_backend_name", boom)
    port_obs.reset_all()
    port_obs.trace._reset_warned()
    for _ in range(3):
        assert TE.resolve_backend("auto", shape=SHAPE, **CPU).name == "torch"
    warned = [e for e in port_obs.ring_events()
              if "perf_calibration_failed" in json.dumps(e)]
    assert len(warned) == 1
    port_obs.reset_all()


def test_auto_needs_a_device():
    with pytest.raises(ValueError, match="device"):
        TE.resolve_backend("auto")


# ----------------------------------------------------- torch_bf16 parity --

def test_bf16_accumulators_match_f32_sweep_and_reference():
    x, w, v = _inputs(400, 8, 5, 0)
    xt, wt, vt = (torch.from_numpy(a) for a in (x, w, v))
    got = TE.fcm_accumulate_mixed(xt, wt, vt, 2.0)
    want = TE.fcm_accumulate(xt, wt, vt, 2.0)
    ref = RE.fcm_accumulate_mixed(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(v), 2.0)
    for g, e, r in zip(got, want, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-2,
                                   atol=2e-2)


def test_bf16_batched_accumulators_match_f32():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 200, 6)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2, size=(3, 200)).astype(
        np.float32))
    v = torch.from_numpy(rng.normal(size=(3, 4, 6)).astype(np.float32))
    m = torch.tensor([1.5, 2.0, 2.5])
    be = TE.get_backend("torch_bf16")
    got = be.batched_accumulate(x, w, v, m)
    want = TE.get_backend("torch").batched_accumulate(x, w, v, m)
    for g, e in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=2e-2,
                                   atol=2e-2)
    for t in range(3):
        one = be.accumulate(x[t], w[t], v[t], float(m[t]))
        for g, e in zip(got, one):
            np.testing.assert_allclose(g[t].numpy(), e.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_bf16_objective_parity_at_fit_level():
    """The gate that earns ``torch_bf16`` its registry entry: a full fit
    with the mixed-precision sweep reaches the f32 fit's objective within
    2e-2, as the reference's ``jnp_bf16`` reaches ``jnp``'s."""
    x, _ = TD.make_blobs(600, 4, 3, seed=5)
    qs = {}
    for name in ("torch", "torch_bf16"):
        res = TC.bigfcm_fit(x, TC.BigFCMConfig(
            n_clusters=3, sample_size=256, max_iter=120, backend=name,
            seed=1), **CPU)
        assert np.isfinite(res.centers.numpy()).all()
        qs[name] = float(RM.fuzzy_objective(jnp.asarray(x),
                                            jnp.asarray(res.centers.numpy())))
    for name in ("jnp", "jnp_bf16"):
        res = RC.bigfcm_fit(jnp.asarray(x), RC.BigFCMConfig(
            n_clusters=3, sample_size=256, max_iter=120, backend=name,
            seed=1))
        qs[name] = float(RM.fuzzy_objective(jnp.asarray(x), res.centers))
    assert abs(qs["torch_bf16"] - qs["torch"]) / qs["torch"] < 2e-2
    assert abs(qs["jnp_bf16"] - qs["jnp"]) / qs["jnp"] < 2e-2
    assert abs(qs["torch_bf16"] - qs["jnp_bf16"]) / qs["jnp_bf16"] < 2e-2


# ---------------------------------------------------- plan autotuning --

def _pure_planner(dev):
    def plan(shape, choice):
        if len(shape) == 3:
            n, c, d = shape
            return plan_sweep(n, d, c, choice=choice, **CARD)
        t, n, c, d = shape
        return plan_batched(t, n, d, c, choice=choice, **CARD)
    return plan


def _stub_tuning(monkeypatch, best, launch_s=2e-4):
    """The card's planner replaced by the pure plan at H100 numbers, the
    card timer by one that makes ``best`` (a PlanChoice) the fastest,
    and a synchronized launch taking ``launch_s`` (default: card-bound,
    so the search runs)."""
    monkeypatch.setattr(autotune, "_planner", _pure_planner)
    timed = []

    def fake(choice, data, m, iters):
        timed.append(choice)
        return 1e-4 if choice == best else 2e-4
    monkeypatch.setattr(autotune, "_time_choice", fake)
    monkeypatch.setattr(autotune, "_time_launch",
                        lambda choice, data, m, iters: launch_s)
    return timed


@pytest.mark.parametrize("shape,tenants,best,path", [
    ((4096, 2, 28), None, PlanChoice(split=2.0), "rows"),
    ((4096, 23, 41), None, PlanChoice(tile=0.5), "tile"),
    ((4096, 64, 2048), None, PlanChoice(tile=2.0, dsplit=0.5), "ctiled"),
    ((512, 3, 4), 64, PlanChoice(split=0.5), "rows"),
    ((512, 23, 41), 4096, PlanChoice(tile=0.5), "tile")])
def test_autotune_persists_and_kernels_pick_it_up(calib_dir, monkeypatch,
                                                  shape, tenants, best,
                                                  path):
    timed = _stub_tuning(monkeypatch, best)
    cfg = autotune.tune_sweep_blocks(shape, tenants=tenants, **CPU)
    assert cfg["choice"] == {"split": best.split, "tile": best.tile,
                             "dsplit": best.dsplit}
    assert cfg["plan"]["path"] == cfg["untuned_plan"]["path"] == path
    assert timed[0] == PlanChoice()          # the untuned plan is timed
    assert len(cfg["times_us"]) == len(timed) > 1
    assert cfg["tuned_us"] <= cfg["untuned_us"]
    key = autotune.tile_key(shape, tenants)
    assert load_calibration(**CPU)["tiles"][key]["choice"] == cfg["choice"]
    calibrate.clear_memory_cache()           # a new process: disk hit
    assert autotune.tuned_blocks(shape, tenants=tenants, **CPU) == cfg
    timed.clear()
    assert autotune.tune_sweep_blocks(shape, tenants=tenants, **CPU) == cfg
    assert timed == []                       # a lookup, not a search
    # the wrappers' lookup gives the choice to the plan
    n, c, d = shape
    dev = torch.device("cpu")
    assert fu.tuned_choice(dev, n, d, c, tenants) == best
    plan = _pure_planner(dev)(autotune.tune_shape(shape, tenants), best)
    assert {k: getattr(plan, k) for k in cfg["plan"]} == cfg["plan"]


@pytest.mark.parametrize("ratio,won", [(0.96, False), (0.94, True),
                                       (0.5, True), (1.2, False)])
def test_autotune_dethrone_margin(calib_dir, monkeypatch, ratio, won):
    """The untuned plan is the incumbent: a choice replaces it only by
    beating its time by more than 5 %, as a backend must beat the race's
    incumbent."""
    monkeypatch.setattr(autotune, "_planner", _pure_planner)
    best = PlanChoice(split=2.0)

    def fake(choice, data, m, iters):
        return 1e-4 * (ratio if choice == best else 1.0)
    monkeypatch.setattr(autotune, "_time_choice", fake)
    monkeypatch.setattr(autotune, "_time_launch",
                        lambda choice, data, m, iters: 1.2e-4)
    cfg = autotune.tune_sweep_blocks((4096, 2, 28), **CPU)
    want = best if won else PlanChoice()
    assert cfg["choice"] == {"split": want.split, "tile": want.tile,
                             "dsplit": want.dsplit}
    assert cfg["tuned_us"] == round(1e-4 * (ratio if won else 1.0) * 1e6, 2)


@pytest.mark.parametrize("launch_s,searched", [(1e-3, False), (4.1e-4, False),
                                               (3.9e-4, True), (2e-4, True)])
def test_host_bound_bucket_keeps_the_untuned_plan(calib_dir, monkeypatch,
                                                  launch_s, searched):
    """Where the untuned plan's card time is under half of what a
    synchronized launch costs, no challenger is timed and the bucket
    keeps the untuned plan, however much faster a choice would run on the
    card."""
    timed = _stub_tuning(monkeypatch, PlanChoice(tile=2.0),
                         launch_s=launch_s)
    cfg = autotune.tune_sweep_blocks((4096, 23, 41), **CPU)
    assert cfg["host_bound"] is not searched
    assert cfg["launch_us"] == round(launch_s * 1e6, 2)
    if searched:
        assert len(timed) > 1 and cfg["choice"]["tile"] == 2.0
    else:
        assert timed == [PlanChoice()]
        assert cfg["choice"] == {"split": 1.0, "tile": 1.0, "dsplit": 1.0}
        assert cfg["plan"] == cfg["untuned_plan"]


def test_tuning_times_each_distinct_plan_once(calib_dir, monkeypatch):
    timed = _stub_tuning(monkeypatch, PlanChoice())
    autotune.tune_sweep_blocks((262_144, 64, 2048), **CPU)
    plans = [_pure_planner(None)(autotune.tune_shape((262_144, 64, 2048)),
                                 ch) for ch in timed]
    assert len(set(plans)) == len(plans)
    assert autotune.tune_shape((262_144, 64, 2048)) == (131_072, 64, 2048)
    assert autotune.tune_shape((11_000_000, 2, 28)) == (1 << 20, 2, 32)


def test_untuned_bucket_keeps_the_untuned_plan(calib_dir):
    assert autotune.tuned_blocks((64, 2, 2), **CPU) is None
    assert fu.tuned_choice(torch.device("cpu"), 64, 2, 2) is None
    for n, d, c in ((4096, 28, 2), (4096, 41, 23), (4096, 2048, 64),
                    (100, 130, 7)):
        assert plan_sweep(n, d, c, **CARD) == plan_sweep(
            n, d, c, choice=PlanChoice(), **CARD)
    assert plan_batched(64, 512, 4, 3, **CARD) == plan_batched(
        64, 512, 4, 3, choice=PlanChoice(), **CARD)


def test_autotune_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        autotune.tune_sweep_blocks(SHAPE, refresh=True, **CPU)


@pytest.mark.parametrize("n,d,c", [(11_000_000, 28, 2), (3184, 28, 2),
                                   (4_898_431, 41, 23), (2048, 41, 23),
                                   (46, 41, 23), (262_144, 2048, 64),
                                   (128, 2048, 64), (4096, 900, 64),
                                   (1024, 7168, 384), (300, 130, 131)])
def test_every_choice_keeps_the_path_and_covers_the_rows(n, d, c):
    """A choice changes a plan's free picks only: the path stays, the
    rows are covered, the record tile is one of CT_TILES and the
    d-splits stay within d's 32-dim chunks."""
    untuned = plan_sweep(n, d, c, **CARD)
    for choice in autotune.choice_grid(untuned.path):
        plan = plan_sweep(n, d, c, choice=choice, **CARD)
        assert plan.path == untuned.path
        if plan.path == "rows":
            assert plan.rows * plan.splits >= n
        elif plan.path == "tile":
            assert 1 <= plan.rows <= n and plan.grid >= 1
        elif plan.path == "ctiled":
            assert plan.tile in CT_TILES
            assert plan.dsplits == -(-(-(-d // 32)) // plan.kper)
            assert plan.scratch <= fu.CTILED_SCRATCH_BYTES
        elif plan.path == "wide":
            assert plan.dsplits * plan.kper >= d > (plan.dsplits - 1) * \
                plan.kper
            assert plan.grid % plan.dsplits == 0 and plan.rows >= 1


def test_tuned_choice_is_plain_math_on_the_cpu(calib_dir, monkeypatch):
    """On a CPU tensor the wrappers take the plain version whatever the
    bucket's tuned choice: equal to the ``torch`` oracle at
    tests/test_kernels.py's tolerances."""
    _stub_tuning(monkeypatch, PlanChoice(tile=0.5))
    autotune.tune_sweep_blocks((256, 4, 8), **CPU)
    x, w, v = (torch.from_numpy(a) for a in _inputs(256, 8, 4, 2))
    got = fu.fcm_accumulate_cuda(x, w, v, 2.0)
    want = TE.fcm_accumulate(x, w, v, 2.0)
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=3e-4,
                                   atol=3e-3)


# ------------------------------------------------------------- roofline --

@pytest.mark.parametrize("n,c,d", [(1024, 8, 16), (11_000_000, 2, 28),
                                   (4_898_431, 23, 41), (262_144, 64, 2048),
                                   (1, 1, 1)])
def test_sweep_model_equals_reference(n, c, d):
    from repro.perf import roofline as ref_roofline
    assert sweep_flops(n, c, d) == ref_roofline.sweep_flops(n, c, d)
    assert sweep_bytes(n, c, d) == ref_roofline.sweep_bytes(n, c, d)
    assert sweep_intensity(n, c, d) == ref_roofline.sweep_intensity(n, c, d)


def test_sweep_analytic_model():
    n, c, d = 1024, 8, 16
    assert sweep_flops(n, c, d) == pytest.approx(
        4.0 * n * c * d + 2.0 * n * d + 2.0 * c * d + 14.0 * n * c)
    assert sweep_bytes(n, c, d) < 4.0 * (n * d + n + 2 * c * d + c + 1) + 5
    assert sweep_intensity(10_000, 256, 256) == pytest.approx(256, rel=0.1)
    assert sweep_intensity(10_000, 4, 256) < 8


PEAKS = {"stream_bytes_per_s": 1e9, "matmul_f32_flops_per_s": 1e10,
         "matmul_bf16_flops_per_s": 5e9}


def test_kernel_roofline_row_fields():
    row = kernel_roofline("torch", (512, 4, 8), peaks=PEAKS, iters=1, **CPU)
    ref = RP.kernel_roofline("jnp", (512, 4, 8), peaks=PEAKS, iters=1)
    assert set(row) == set(ref)
    assert row["backend"] == "torch" and row["platform"] == "cpu"
    assert row["seconds"] > 0 and row["records_per_s"] > 0
    assert row["achieved_flops_per_s"] == pytest.approx(
        sweep_flops(512, 4, 8) / row["seconds"])
    assert row["frac_of_peak_flops"] == pytest.approx(
        row["achieved_flops_per_s"] / PEAKS["matmul_f32_flops_per_s"])
    assert row["bound"] in ("compute", "memory") and row["frac_of_bound"] > 0
    assert row["intensity_flop_per_byte"] == pytest.approx(
        sweep_intensity(512, 4, 8))
    for k in ("intensity_flop_per_byte", "bound", "t_bound_s"):
        assert row[k] == ref[k]
    row16 = kernel_roofline("torch_bf16", (512, 4, 8), peaks=PEAKS, iters=1,
                            **CPU)
    assert row16["frac_of_peak_flops"] == pytest.approx(
        row16["achieved_flops_per_s"] / PEAKS["matmul_bf16_flops_per_s"])


def test_roofline_report_errors_are_rows_not_crashes():
    rep = roofline_report([(256, 3, 4)], backends=["torch", "no_such"],
                          peaks=PEAKS, iters=1, **CPU)
    by_name = {r["backend"]: r for r in rep["rows"]}
    assert len(rep["rows"]) == 2
    assert "error" not in by_name["torch"] and "error" in by_name["no_such"]


def test_probe_peaks_smoke(calib_dir, monkeypatch):
    peaks = microbench.probe_peaks(stream_floats=(1 << 14,), matmul_ns=(64,),
                                   iters=1, **CPU)
    for k in ("stream_bytes_per_s", "matmul_f32_flops_per_s",
              "matmul_bf16_flops_per_s"):
        assert np.isfinite(peaks[k]) and peaks[k] > 0
    assert peaks["probe"]["platform"] == "cpu"
    assert set(peaks) == set(ref_microbench.probe_peaks(
        stream_floats=(1 << 14,), matmul_ns=(64,), iters=1))
    calls = []
    orig = microbench.probe_peaks

    def counting(**kw):
        calls.append(kw)
        return orig(stream_floats=(1 << 14,), matmul_ns=(64,), iters=1,
                    **CPU)
    monkeypatch.setattr(microbench, "probe_peaks", counting)
    p1 = calibrate.cached_peaks(**CPU)
    p2 = calibrate.cached_peaks(**CPU)
    assert len(calls) == 1 and p1 == p2


def test_probe_matmul_restores_tf32_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    microbench.probe_matmul_flops(32, iters=1, **CPU)
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_time_fn_median():
    xs = torch.arange(1024, dtype=torch.float32)
    t = microbench.time_fn(lambda a: a * 2.0, xs, warmup=1, iters=3)
    assert np.isfinite(t) and t > 0
