"""The tenant plane of `repro_torch` against `repro`: the tenant-stacked
sweep (plain versions, engine math, the reference's Pallas vmap in
interpret mode), the batched convergence loop, packing and seeding,
`fit_tenants` / `fit_tenants_looped` and `TenantScorer`, on identical
numpy inputs.  On the CPU every kernel wrapper takes its plain version.

Sweep tolerances are those of tests/test_kernels.py.  Fits are held at
tests/test_tenant.py's bars, per tenant: with equal iteration counts,
centers within 1e-4 and objective within 1e-5 relative; with counts one
apart (summation order can move the ε crossing by one sweep), objective
within 1e-4.  The objective compared there is that of the fitted centers
evaluated in float64 with the direct ‖x − v‖² (`_objective64`).  The
f32 objective each fit reports is held to the f32 rounding bound of the
d² = ‖x‖² + ‖v‖² − 2x·v expansion both packages use (`_q_bound`): on
the cohorts' off-origin blobs that expansion's rounding alone moves q
by about 1e-5 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.obs as ref_obs
import repro.data.plane as RP
import repro.engine as RE
import repro.serve as RS
import repro.tenant as R
import repro_torch.core as TC
import repro_torch.obs as port_obs
import repro_torch.data.plane as TP
import repro_torch.engine as TE
import repro_torch.serve as TS
import repro_torch.tenant as T
from repro.tenant.core import normalize_tenant_data as ref_normalize
from repro_torch.data import synth
from repro_torch.kernels import ops
from repro_torch.kernels.fcm_update import (fcm_accumulate_batched_cuda,
                                            fcm_accumulate_batched_ref,
                                            fcm_sweep_batched_cuda,
                                            fcm_sweep_batched_ref)
from repro_torch.tenant.core import normalize_tenant_data

RTOL, SWEEP_ATOL, ACC_ATOL = 3e-4, 3e-5, 3e-3


def _cohort(t, seed=0, lo=8, hi=180, d=3):
    """tests/test_tenant.py's cohort: mixed-size per-tenant record sets
    around distinct blob centers."""
    rng = np.random.default_rng(seed)
    return {f"t{i}": (rng.normal(size=(int(rng.integers(lo, hi)), d))
                      + 3.0 * (i % 5)).astype(np.float32)
            for i in range(t)}


def _stack(t, n, d, c, seed, phantoms=2):
    """A tenant-stacked block: ragged rows padded by zero-weight phantom
    rows, then ``phantoms`` all-zero phantom tenants (x = 0, V = 0,
    w = 0).  Real tenants' weights lie in U(0.1, 3)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((t + phantoms, n, d), np.float32)
    w = np.zeros((t + phantoms, n), np.float32)
    v = np.zeros((t + phantoms, c, d), np.float32)
    for i in range(t):
        rows = int(rng.integers(max(1, n // 3), n + 1))
        x[i, :rows] = rng.normal(size=(rows, d)) + 0.5 * i
        w[i, :rows] = rng.uniform(0.1, 3.0, size=rows)
        v[i] = rng.normal(size=(c, d)) + 0.5 * i
    return x, w, v


def _fuzzifiers(kind, tenants, seed=0):
    if kind == "scalar":
        return 2.0
    rng = np.random.default_rng(seed)
    return rng.choice([1.05, 1.2, 2.0, 3.0], size=tenants).astype(
        np.float32)


def _close(got, want, rtol, atol):
    for g, e in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.cpu()), np.asarray(e),
                                   rtol=rtol, atol=atol)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _ms(m, t):
    return np.broadcast_to(np.asarray(m, np.float64), (t,))


def _objective64(xs, centers, ms):
    """Each tenant's Eq.-(2) objective at its fitted centers, in float64
    with the direct ‖x − v‖² and the log-space membership."""
    out = []
    for x, v, m in zip(xs, centers, ms):
        d2 = np.maximum(((x.astype(np.float64)[:, None]
                          - v.astype(np.float64)[None]) ** 2).sum(-1), 1e-12)
        lg = np.log(d2)
        r = np.exp(-(lg - lg.min(1, keepdims=True)) / (m - 1.0))
        out.append(((r / r.sum(1, keepdims=True)) ** m * d2).sum())
    return np.asarray(out)


def _q_bound(xs, centers):
    """How far two f32 evaluations of q through the d² expansion may
    part: each lies within 2·γ_{d+2}·Σ_k (‖x_k‖² + max_i ‖v_i‖²) of the
    exact value (γ_k = k·2⁻²⁴, Σ_i u_ik^m ≤ 1, unit weights)."""
    gamma = (xs[0].shape[1] + 2) * 2.0 ** -24
    return np.asarray([4 * gamma * float(
        (x.astype(np.float64) ** 2).sum()
        + x.shape[0] * (v.astype(np.float64) ** 2).sum(1).max())
        for x, v in zip(xs, centers)])


def _hold_fits(got, want, xs, ms):
    """tests/test_tenant.py's per-tenant bars (module docstring)."""
    g_it = np.asarray(got.n_iter, np.int64)
    w_it = np.asarray(want.n_iter, np.int64)
    assert np.all(np.abs(g_it - w_it) <= 1), (g_it, w_it)
    same = g_it == w_it
    jg, jw = _objective64(xs, got.centers, ms), _objective64(xs, want.centers,
                                                              ms)
    rel = np.abs(jg - jw) / np.maximum(np.abs(jw), 1e-12)
    assert np.all(rel[same] <= 1e-5), rel
    assert np.all(rel <= 1e-4), rel
    np.testing.assert_allclose(np.asarray(got.centers)[same],
                               np.asarray(want.centers)[same],
                               rtol=1e-4, atol=1e-4)
    qg = np.asarray(got.objective, np.float64)
    qw = np.asarray(want.objective, np.float64)
    bound = 1e-5 * np.abs(qw) + _q_bound(xs, want.centers)
    assert np.all(np.abs(qg - qw)[same] <= bound[same]), (qg, qw, bound)


# ---------------------------------------------- the tenant-stacked sweep --

STACKS = [(3, 64, 4, 3), (5, 37, 41, 23), (4, 32, 2, 2)]


@pytest.mark.parametrize("m_kind", ["scalar", "per_tenant"])
@pytest.mark.parametrize("t,n,d,c", STACKS)
def test_batched_accumulate_matches_reference(t, n, d, c, m_kind):
    """Plain versions, engine math and the torch backend against the
    reference's jnp batched math, phantom rows and tenants included."""
    x, w, v = _stack(t, n, d, c, seed=t + n + d + c)
    m = _fuzzifiers(m_kind, t + 2)
    want = RE.fcm_accumulate_batched(*_j(x, w, v), m if m_kind == "scalar"
                                     else jnp.asarray(m))
    mt = m if m_kind == "scalar" else torch.from_numpy(m)
    torch_be = TE.get_backend("torch")
    for got in (fcm_accumulate_batched_ref(*_t(x, w, v), mt),
                TE.fcm_accumulate_batched(*_t(x, w, v), mt),
                torch_be.batched_accumulate(*_t(x, w, v), mt)):
        _close(got, want, RTOL, ACC_ATOL)
        for out in got:                       # phantom tenants: exact zeros
            assert torch.equal(out[t:], torch.zeros_like(out[t:]))
    want_sweep = RE.normalize_accumulators(*want)
    for got in (fcm_sweep_batched_ref(*_t(x, w, v), mt),
                torch_be.batched_sweep(*_t(x, w, v), mt)):
        _close(got, want_sweep, RTOL, SWEEP_ATOL)


@pytest.mark.parametrize("t,n,d,c", [(3, 40, 4, 3), (2, 33, 9, 5)])
def test_plain_batched_matches_pallas_vmap_interpret(t, n, d, c):
    """The reference's tenant-stacked launch, `jax.vmap` of the Pallas
    kernel in interpret mode, with a Python-float m (the form it takes;
    see ROADMAP Queue 3)."""
    x, w, v = _stack(t, n, d, c, seed=n + d)
    want = RE.get_backend("pallas").batched_accumulate(*_j(x, w, v), 2.0)
    _close(fcm_accumulate_batched_ref(*_t(x, w, v), 2.0), want, RTOL,
           ACC_ATOL)
    _close(fcm_sweep_batched_ref(*_t(x, w, v), 2.0),
           RE.normalize_accumulators(*want), RTOL, SWEEP_ATOL)


def test_default_batched_accumulate_vmaps_the_backend():
    """A backend with only ``accumulate`` gets its batched entry by
    `torch.func.vmap`, as the reference's base class vmaps."""

    class Plain(TE.SweepBackend):
        name = "plain_vmapped"

        def accumulate(self, x, w, centers, m):
            return TE.fcm_accumulate(x, w, centers, m)

    x, w, v = _t(*_stack(4, 50, 6, 4, seed=3))
    for m in (1.2, torch.from_numpy(_fuzzifiers("per_tenant", 6))):
        _close(Plain().batched_accumulate(x, w, v, m),
               [a.numpy() for a in TE.fcm_accumulate_batched(x, w, v, m)],
               1e-5, 1e-5)


def test_batched_wrappers_on_cpu_take_plain_path_and_launch_nothing():
    x, w, v = _t(*_stack(5, 48, 4, 3, seed=9))
    m = torch.from_numpy(_fuzzifiers("per_tenant", 7))
    fcm_accumulate_batched_cuda.launches = fcm_sweep_batched_cuda.launches = 0
    for got, want in (
            (fcm_accumulate_batched_cuda(x, w, v, m),
             fcm_accumulate_batched_ref(x, w, v, m)),
            (fcm_sweep_batched_cuda(x, w, v, m),
             fcm_sweep_batched_ref(x, w, v, m)),
            (ops.HopperBackend().batched_sweep(x, w, v, m),
             fcm_sweep_batched_ref(x, w, v, m)),
            (ops.HopperAccumulateBackend().batched_sweep(x, w, v, m),
             TE.normalize_accumulators(*fcm_accumulate_batched_ref(
                 x, w, v, m)))):
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    T.fit_tenants(_cohort(4, seed=5),
                  T.TenantFitConfig(n_clusters=3, backend="torch"),
                  device="cpu")
    assert fcm_accumulate_batched_cuda.launches == 0
    assert fcm_sweep_batched_cuda.launches == 0


def test_batched_wrapper_rejects_bad_fuzzifier_shape():
    x, w, v = _t(*_stack(3, 20, 4, 3, seed=1))
    with pytest.raises(ValueError, match="one fuzzifier per tenant"):
        fcm_sweep_batched_cuda(x, w, v, torch.ones(4) * 2)


# ------------------------------------------------- batched convergence --

def _packed(t, seed, cfg):
    ids, xs = normalize_tenant_data(_cohort(t, seed=seed))
    X, W = T.pack_tenants(xs, cfg)
    V0 = np.zeros((X.shape[0], cfg.n_clusters, X.shape[2]), np.float32)
    V0[:t] = T.seed_centers(xs, cfg)
    return xs, X, W, V0


@pytest.mark.parametrize("m_kind", ["scalar", "per_tenant"])
def test_fcm_converge_batched_matches_reference(m_kind):
    cfg = T.TenantFitConfig(n_clusters=3, seed=11)
    xs, X, W, V0 = _packed(7, 21, cfg)
    m = (2.0 if m_kind == "scalar"
         else np.random.default_rng(4).uniform(1.5, 3.0, X.shape[0]).astype(
             np.float32))
    kw = dict(eps=1e-6, max_iter=300)
    want = RE.fcm_converge_batched(*_j(X, W, V0), m=m, backend="jnp", **kw)
    got = TE.fcm_converge_batched(X, W, V0, m=m, backend="torch",
                                  device="cpu", **kw)
    got_fcm = TC.fcm_batched(X, V0, m=m, point_weights=W, backend="torch",
                             device="cpu", **kw)
    want_fcm = RC.fcm_batched(*_j(X, V0), m=m, point_weights=jnp.asarray(W),
                              backend="jnp", **kw)
    t = len(xs)
    ms = _ms(m, X.shape[0])[:t]
    for (gv, gw, gq, gi), (ev, ew, eq, ei) in (
            (got, want),
            ((got_fcm.centers, got_fcm.center_weights, got_fcm.objective,
              got_fcm.n_iter),
             (want_fcm.centers, want_fcm.center_weights, want_fcm.objective,
              want_fcm.n_iter))):
        assert gi.dtype == torch.int32 and gv.shape == tuple(ev.shape)
        _hold_fits(_fit(gv, gq, gi, t), _fit(ev, eq, ei, t), xs, ms)
        for out in (gv, gw, gq):          # phantom tenants converge to 0
            assert not bool(out[t:].abs().any())


def _fit(v, q, n_iter, t):
    """The first t tenants of a batched result as a `TenantSet`."""
    def host(a):
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)[:t]
    return T.tenant_set(range(t), host(v), np.zeros(host(v).shape[:2]),
                        objective=host(q), n_iter=host(n_iter))


# ------------------------------------------------------ packing/seeding --

def test_pack_seed_and_buckets_bit_equal_reference():
    data = _cohort(11, seed=6, lo=3, hi=90)
    cfg_kw = dict(n_clusters=3, seed=5, row_base=16, tenant_base=4)
    ids, xs = normalize_tenant_data(data)
    r_ids, r_xs = ref_normalize(data)
    assert ids == r_ids and all(np.array_equal(a, b)
                                for a, b in zip(xs, r_xs))
    for got, want in zip(T.pack_tenants(xs, T.TenantFitConfig(**cfg_kw)),
                         R.pack_tenants(xs, R.TenantFitConfig(**cfg_kw))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(T.seed_centers(xs, T.TenantFitConfig(**cfg_kw)),
                          R.seed_centers(xs, R.TenantFitConfig(**cfg_kw)))
    for n in (1, 16, 17, 1000):
        assert TP.geom_bucket(n, base=16) == RP.geom_bucket(n, base=16)
        assert np.array_equal(TP.pad_rows(xs[0], 90), RP.pad_rows(xs[0], 90))


def test_tenant_set_matches_reference():
    rng = np.random.default_rng(2)
    args = ([f"u{i}" for i in range(6)],
            rng.normal(size=(6, 3, 4)), rng.uniform(1, 9, size=(6, 3)))
    kw = dict(versions=rng.integers(0, 9, size=6),
              objective=rng.normal(size=6), n_iter=rng.integers(1, 9, size=6))
    got, want = T.tenant_set(*args, **kw), R.tenant_set(*args, **kw)
    for a, b in zip(got.select(["u4", "u1"]), want.select(["u4", "u1"])):
        assert a == b if isinstance(a, tuple) else (
            np.array_equal(a, b) and a.dtype == b.dtype)
    assert got.index("u3") == want.index("u3") == 3
    with pytest.raises(KeyError):
        got.index("nope")


# -------------------------------------------------------------- the fits --

FITS = {"cohort9": (9, 1, None),
        "cohort6_mixed_m": (6, 2, np.asarray([1.5, 2.0, 2.5, 3.0, 1.7, 2.2],
                                             np.float32)),
        "kdd99_12": (12, 3, None)}
# The KDD99-width case (the paper's d = 41, C = 23, m = 1.2; chip_smoke's
# tenants_kdd99 cohort at a small size): 12 tenants of 24-60 consecutive
# records of one make_kdd_like array (24: C distinct seeds and one more).
# With about two records a center, m = 1.2 leaves centers that f32 does
# not fix: two f32 fits part within a few sweeps (an ulp in one d² decides
# which of two near-coincident centers takes a record), so the fit is
# compared as a trajectory, step-locked: each of KDD_SWEEPS sweeps runs
# both packages' fit (ε < 0, one sweep) from the reference's centers of
# the step before, injected as the seeds.  A step is held on the tenants
# whose reference step f32 fixes (its fits of the records scaled by
# 1 ± 2⁻²² land within test_tenant.py's 1e-4 of it), at least two thirds
# of them: centers within KDD_CENTER_TOL (absolute and relative) and the
# float64 objective within KDD_OBJ_RTOL, three times test_tenant.py's
# bars, since one sweep at m = 1.2 moves a membership by 1/(m − 1) = 5
# times the relative rounding of its d² (about 2e-6 here, ‖x‖² ≈ 680);
# the f32 q to the expansion's rounding bound.
KDD_SWEEPS = 6
KDD_CENTER_TOL, KDD_OBJ_RTOL = 3e-4, 3e-5


def _kdd_cohort(t, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(24, 61, size=t)
    x = synth.make_kdd_like(int(sizes.sum()), seed=seed)[0]
    return {f"h{i}": part for i, part in
            enumerate(np.split(x, np.cumsum(sizes)[:-1]))}


def _fit_from(fit, module, data, cfg, v, monkeypatch, **kw):
    """``fit`` (either package's `fit_tenants` or `fit_tenants_looped`)
    with ``v`` as every tenant's seeds."""
    monkeypatch.setattr(module, "seed_centers", lambda xs, cfg: v.copy())
    try:
        return fit(data, cfg, **kw)
    finally:
        monkeypatch.undo()


def _hold_kdd_trajectory(data, t, looped, monkeypatch):
    """The KDD99-width case's step-locked hold (the note above)."""
    import repro.tenant.fit as ref_fit
    import repro_torch.tenant.fit as port_fit
    port = T.fit_tenants_looped if looped else T.fit_tenants
    ref = R.fit_tenants_looped if looped else R.fit_tenants
    kw = dict(n_clusters=23, m=1.2, seed=11, eps=-1.0, max_iter=1)
    _, xs = normalize_tenant_data(data)
    v = T.seed_centers(xs, T.TenantFitConfig(**kw))
    assert np.array_equal(v, R.seed_centers(xs, R.TenantFitConfig(**kw)))
    ms = _ms(1.2, t)
    rcfg = R.TenantFitConfig(backend="jnp", **kw)
    for _ in range(KDD_SWEEPS):
        want = _fit_from(ref, ref_fit, data, rcfg, v, monkeypatch)
        got = _fit_from(port, port_fit, data,
                        T.TenantFitConfig(backend="torch", **kw), v,
                        monkeypatch, device="cpu")
        assert got.ids == want.ids and got.centers.dtype == np.float32
        assert np.all(got.n_iter == 1) and np.all(want.n_iter == 1)
        fixed = np.ones(t, bool)
        for sign in (1, -1):
            nudged = {k: x * np.float32(1 + sign * 2.0 ** -22)
                      for k, x in data.items()}
            n = _fit_from(ref, ref_fit, nudged, rcfg, v, monkeypatch)
            fixed &= np.all(np.abs(n.centers - want.centers)
                            <= 1e-4 + 1e-4 * np.abs(want.centers),
                            axis=(1, 2))
        assert 3 * fixed.sum() >= 2 * t, fixed
        np.testing.assert_allclose(got.centers[fixed], want.centers[fixed],
                                   rtol=KDD_CENTER_TOL, atol=KDD_CENTER_TOL)
        jg = _objective64(xs, got.centers, ms)
        jw = _objective64(xs, want.centers, ms)
        assert np.all((np.abs(jg - jw) <= KDD_OBJ_RTOL * np.abs(jw))[fixed])
        qg = np.asarray(got.objective, np.float64)
        qw = np.asarray(want.objective, np.float64)
        bound = 1e-5 * np.abs(qw) + _q_bound(xs, want.centers)
        assert np.all((np.abs(qg - qw) <= bound)[fixed]), (qg, qw, bound)
        v = want.centers


@pytest.mark.parametrize("looped", [False, True])
@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_tenants_matches_reference(case, looped, monkeypatch):
    t, seed, m_t = FITS[case]
    port = T.fit_tenants_looped if looped else T.fit_tenants
    ref = R.fit_tenants_looped if looped else R.fit_tenants
    port_launches = port_obs.counter("tenant.fit.launches")
    ref_launches = ref_obs.counter("tenant.fit.launches")
    if case.startswith("kdd99"):
        data = _kdd_cohort(t, seed)
        before = (port_launches.value, ref_launches.value)
        _hold_kdd_trajectory(data, t, looped, monkeypatch)
        # a dispatch per fit (per tenant looped): the port's step; the
        # reference's step and its two nudged twins
        launched = (port_launches.value - before[0],
                    ref_launches.value - before[1])
        per = t if looped else 1
        assert launched == (KDD_SWEEPS * per, 3 * KDD_SWEEPS * per)
        return
    data = _cohort(t, seed=seed)
    kw = dict(n_clusters=3, seed=11)
    before = (port_launches.value, ref_launches.value)
    got = port(data, T.TenantFitConfig(backend="torch", **kw), m_t=m_t,
               device="cpu")
    want = ref(data, R.TenantFitConfig(backend="jnp", **kw), m_t=m_t)
    assert got.ids == want.ids
    assert got.centers.dtype == np.float32 and got.n_iter.dtype == np.int32
    _, xs = normalize_tenant_data(data)
    _hold_fits(got, want, xs, _ms(2.0 if m_t is None else m_t, t))
    # device dispatches: one per batched fit, one per tenant looped
    launched = (port_launches.value - before[0],
                ref_launches.value - before[1])
    assert launched == ((t, t) if looped else (1, 1))


def test_port_batched_matches_port_looped():
    """tests/test_tenant.py:58 within the port: the batched fit against
    one fit per tenant through the single-model sweep."""
    data = _cohort(9, seed=1)
    cfg = T.TenantFitConfig(n_clusters=3, seed=11, backend="torch")
    b = T.fit_tenants(data, cfg, device="cpu")
    lp = T.fit_tenants_looped(data, cfg, device="cpu")
    _, xs = normalize_tenant_data(data)
    _hold_fits(b, lp, xs, _ms(2.0, 9))


# -------------------------------------------------------------- scoring --

@pytest.fixture(scope="module")
def fitted():
    data = _cohort(7, seed=8)
    ts = R.fit_tenants(data, R.TenantFitConfig(n_clusters=3, seed=2,
                                               backend="jnp"))
    port_ts = T.tenant_set(ts.ids, ts.centers, ts.weights,
                           versions=np.arange(7) + 10)
    return data, ts, port_ts


@pytest.mark.parametrize("soft", [False, True])
def test_tenant_scorer_matches_reference(fitted, soft):
    data, ts, port_ts = fitted
    rng = np.random.default_rng(0)
    tidx = rng.integers(0, 7, size=60)
    x = (rng.normal(size=(60, 3)) + 3.0 * (tidx % 5)[:, None]).astype(
        np.float32)
    got = TS.TenantScorer(port_ts, m=1.7, soft=soft, device="cpu").score(
        x, tidx)
    want = np.asarray(RS.TenantScorer(ts, m=1.7, soft=soft).score(x, tidx))
    if soft:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    out, version = TS.TenantScorer(port_ts, device="cpu").assign(
        "t3", data["t3"][:5])
    want_out, _ = RS.TenantScorer(ts).assign("t3", data["t3"][:5])
    np.testing.assert_array_equal(out, want_out)
    assert version == 13


def test_tenant_scorer_swap_keeps_one_snapshot_per_call(fitted):
    _, _, port_ts = fitted
    scorer = TS.TenantScorer(port_ts, device="cpu")
    held = scorer.read()
    moved = port_ts._replace(centers=port_ts.centers + 100.0,
                             versions=port_ts.versions + 1)
    scorer.swap(moved)
    assert scorer.read() is not held and held.centers.shape == (7, 3, 3)
    x = port_ts.centers[2, 1:2]                    # on center 1 of t2
    assert scorer.score(x, [2], held).tolist() == [1]
    assert scorer.assign("t2", x)[1] == int(moved.versions[2])
    snap = TS.tenant_snapshot(port_ts, device="cpu")
    scorer.swap(snap)
    out, version = scorer.assign("t2", x)
    assert scorer.read() is snap and out.tolist() == [1] and version == 12
    with pytest.raises(KeyError, match="unknown tenant"):
        scorer.assign("nope", x)
