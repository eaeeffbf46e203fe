"""`repro_torch.engine` against `repro.engine`: sweep math, the backend
registry, summaries and the flat merge, on identical numpy inputs (the
windowed and pairwise topologies: tests/test_torch_stream.py).
Tolerances are those of tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine as R
import repro_torch.engine as T

SHAPES = [
    (64, 2, 2), (100, 130, 7), (257, 4, 3), (1000, 18, 10),
    (2048, 28, 50), (31, 41, 23), (512, 8, 129),
]
OFF_LANE_SHAPES = [
    (300, 130, 131), (200, 129, 140), (96, 257, 129), (513, 131, 200),
]


def _inputs(n, d, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32))


def _close(got, want, rtol, atol):
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    for g, e in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.cpu()), np.asarray(e),
                                   rtol=rtol, atol=atol)


def _both(fn_name, *arrays, **kw):
    return (getattr(T, fn_name)(*[torch.from_numpy(a) for a in arrays], **kw),
            getattr(R, fn_name)(*[jnp.asarray(a) for a in arrays], **kw))


# ------------------------------------------------------------ sweep math --

@pytest.mark.parametrize("n,d,c", SHAPES + OFF_LANE_SHAPES)
def test_sweep_matches_reference(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    got, want = _both("fcm_sweep", x, w, v, m=2.0)
    _close(got, want, 3e-4, 3e-5 if (n, d, c) in SHAPES else 3e-4)


@pytest.mark.parametrize("n,d,c", [(300, 13, 6), (257, 130, 131)])
def test_accumulate_matches_reference(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    got, want = _both("fcm_accumulate", x, w, v, m=2.0)
    _close(got, want, 3e-4, 3e-3)


@pytest.mark.parametrize("m", [1.05, 1.2, 2.0, 3.0])
def test_membership_and_assignments_match_reference_m(m):
    x, w, v = _inputs(500, 12, 6, 7)
    for name in ("membership_terms", "soft_assign"):
        got, want = _both(name, x, v, m=m)
        _close(got, want, 5e-4, 5e-5)
    got, want = _both("fcm_sweep", x, w, v, m=m)
    _close(got, want, 5e-4, 5e-5)
    got, want = _both("hard_assign", x, v)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, want = _both("pairwise_sqdist", x, v)
    _close(got, want, 3e-4, 3e-5)


def test_normalize_accumulators_matches_reference():
    rng = np.random.default_rng(1)
    v_num = rng.normal(size=(5, 3)).astype(np.float32)
    w_i = np.array([2.0, 0.0, 1e-14, 3.0, 0.5], np.float32)
    got, want = _both("normalize_accumulators", v_num, w_i,
                      np.array(4.0, np.float32))
    _close(got, want, 1e-6, 0)


# ------------------------------------------------------------- registry --

def test_registry_names_and_device_rule(monkeypatch, tmp_path):
    """The registry, and "auto": the calibrated winner of its (device,
    bucket), the device rule (CUDA → hopper, CPU → torch) with
    calibration off."""
    assert {"torch", "torch_bf16", "hopper", "hopper_accumulate"} <= set(
        T.available_backends())
    monkeypatch.setenv("REPRO_CALIB_DIR", str(tmp_path))
    from repro_torch.perf import calibrate
    calibrate.clear_memory_cache()
    try:
        assert T.resolve_backend("auto", device="cpu").name == \
            calibrate.calibrated_backend_name(device="cpu")
    finally:
        calibrate.clear_memory_cache()
    monkeypatch.setenv("REPRO_AUTO_CALIBRATE", "0")
    assert T.resolve_backend("auto", device="cpu").name == "torch"
    assert T.resolve_backend(None, device="cuda").name == "hopper"
    assert T.default_backend_name(torch.device("cuda", 0)) == "hopper"
    be = T.get_backend("hopper")
    assert T.resolve_backend(be) is be
    with pytest.raises(KeyError, match="unknown sweep backend"):
        T.get_backend("pallas")
    with pytest.raises(ValueError, match="needs the device"):
        T.resolve_backend("auto")


@pytest.mark.parametrize("name", ["torch", "hopper", "hopper_accumulate"])
def test_backends_on_cpu_match_reference_sweep(name):
    x, w, v = _inputs(200, 129, 140, 3)
    be = T.get_backend(name)
    got = be.sweep(*[torch.from_numpy(a) for a in (x, w, v)], 2.0)
    want = R.get_backend("jnp").sweep(*[jnp.asarray(a) for a in (x, w, v)],
                                      2.0)
    _close(got, want, 3e-4, 3e-4)


# ------------------------------------------------------------- summaries --

def test_summary_helpers_match_reference():
    rng = np.random.default_rng(4)
    cs = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(3)]
    ms = [rng.uniform(0, 2, size=(3,)).astype(np.float32) for _ in range(3)]
    ts = [T.summary(c, m, device="cpu") for c, m in zip(cs, ms)]
    rs = [R.summary(c, m) for c, m in zip(cs, ms)]
    st, sr = T.stack(ts), R.stack(rs)
    _close(tuple(st), tuple(sr), 0, 0)
    ct = T.concat([st, ts[0], T.phantom(3, 4, slots=2, device="cpu")])
    cr = R.concat([sr, rs[0], R.phantom(3, 4, slots=2)])
    _close(tuple(ct), tuple(cr), 0, 0)
    _close(T.slot_masses(ct), R.slot_masses(cr), 1e-6, 0)
    _close(T.total_mass(ct), R.total_mass(cr), 1e-6, 0)
    assert T.phantom(3, 4, device="cpu").centers.shape == (3, 4)
    with pytest.raises(ValueError, match="empty"):
        T.concat([])


# ------------------------------------------------------- merge + converge --

@pytest.mark.parametrize("seed_rule", ["first", "heaviest"])
def test_flat_merge_matches_reference(seed_rule):
    rng = np.random.default_rng(9)
    c, d, s = 4, 6, 5
    truth = rng.normal(0, 5, size=(c, d))
    cent = (truth[None] + rng.normal(0, 0.3, size=(s, c, d))).astype(
        np.float32)
    mass = rng.uniform(1, 20, size=(s, c)).astype(np.float32)
    mass[2] = 0.0                                   # a phantom slot
    plan_kw = dict(seed=seed_rule, m=2.0, eps=1e-9, max_iter=200)
    got = T.merge_summaries(T.summary(cent, mass, device="cpu"),
                            T.MergePlan("flat", **plan_kw), backend="torch")
    want = R.merge_summaries(R.summary(cent, mass),
                             R.MergePlan("flat", **plan_kw), backend="jnp")
    assert got.n_iter == int(want.n_iter)
    _close(got.summary.centers, want.summary.centers, 2e-3, 2e-4)
    _close(got.summary.masses, want.summary.masses, 2e-3, 2e-4)
    # The merge objective sums d² of sketch points sitting close to their
    # centers, where the x² + v² − 2x·v expansion cancels: the raw
    # accumulator tolerance of tests/test_kernels.py applies.
    _close(got.objective, want.objective, 3e-4, 0)


def test_merge_init_and_lone_slot_match_reference():
    rng = np.random.default_rng(2)
    cent = rng.normal(size=(1, 3, 2)).astype(np.float32)
    mass = rng.uniform(1, 2, size=(1, 3)).astype(np.float32)
    lone = T.merge_summaries(T.summary(cent, mass, device="cpu"),
                             backend="torch")
    assert lone.n_iter == 0
    _close(lone.summary.centers, cent[0], 0, 0)
    init = cent[0] + 0.1
    got = T.merge_summaries([T.summary(cent[0], mass[0], device="cpu")],
                            T.MergePlan(eps=1e-9), backend="torch",
                            init=torch.from_numpy(init))
    want = R.merge_summaries([R.summary(cent[0], mass[0])],
                             R.MergePlan(eps=1e-9), backend="jnp",
                             init=jnp.asarray(init))
    assert got.n_iter == int(want.n_iter)
    _close(got.summary.centers, want.summary.centers, 2e-3, 2e-4)


def test_merge_plan_rejects_topologies_not_in_slice():
    assert T.TOPOLOGIES == R.TOPOLOGIES
    for topo in T.TOPOLOGIES:
        assert T.MergePlan(topo).topology == topo
    with pytest.raises(ValueError, match="unknown merge topology"):
        T.MergePlan("ring")
    with pytest.raises(ValueError, match="seed rule"):
        T.MergePlan(seed="last")


@pytest.mark.parametrize("m,eps", [(2.0, 1e-8), (1.2, 1e-6), (3.0, 1e-7)])
def test_fcm_converge_matches_reference(m, eps):
    rng = np.random.default_rng(int(m * 10))
    x = np.concatenate([rng.normal(loc, 1.0, size=(200, 5))
                        for loc in (-6.0, 0.0, 6.0)]).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(600,)).astype(np.float32)
    got = T.fcm_converge(x, x[:3], m=m, eps=eps, max_iter=300,
                         point_weights=w, backend="torch", device="cpu")
    want = R.fcm_converge(jnp.asarray(x), jnp.asarray(x[:3]), m=m, eps=eps,
                          max_iter=300, point_weights=jnp.asarray(w),
                          backend="jnp")
    assert got.n_iter == int(want.n_iter)
    _close(got.summary.centers, want.summary.centers, 2e-3, 2e-4)
    _close(got.objective, want.objective, 1e-5, 0)


def test_converge_stopping_rule_edges():
    """max_iter=0 runs no iteration (one final sweep only); a huge eps
    stops after exactly one, as the reference's while_loop does."""
    x, w, v = _inputs(100, 3, 2, 0)
    for max_iter, eps in ((0, 1e-6), (50, 1e9)):
        got = T.fcm_converge(x, v, eps=eps, max_iter=max_iter,
                             point_weights=w, backend="torch", device="cpu")
        want = R.fcm_converge(jnp.asarray(x), jnp.asarray(v), eps=eps,
                              max_iter=max_iter, point_weights=jnp.asarray(w),
                              backend="jnp")
        assert got.n_iter == int(want.n_iter) == min(max_iter, 1)
        _close(got.summary.centers, want.summary.centers, 3e-4, 3e-5)
