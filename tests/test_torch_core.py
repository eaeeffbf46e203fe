"""`repro_torch.core` against `repro.core`: FCM, WFCMPB, the driver and the
single-device BigFCM fit, on identical numpy inputs with the reference's
`jax.random` draws injected into the port.

Centers are held at rtol 2e-3 / atol 2e-4 (tests/test_kernels.py's full
FCM loop), iteration counts exactly.  A fit's objective is compared as
the global q of its centers recomputed with `repro.engine.fcm_accumulate`
(≤1e-5 relative), never as ``BigFCMResult.objective``: on this path that
is the reducer's self-polish objective, f32 cancellation noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.metrics as RM
import repro.core.sampling as RS
import repro.data.synth as RD
import repro_torch.core as T
import repro_torch.core.metrics as TM
import repro_torch.core.sampling as TS
import repro_torch.data.synth as TD
from repro.engine import fcm_accumulate as ref_accumulate


def _close_centers(got, want):
    np.testing.assert_allclose(np.asarray(got.cpu()), np.asarray(want),
                               rtol=2e-3, atol=2e-4)


def _global_q(x, centers, m):
    xj = jnp.asarray(x)
    return float(ref_accumulate(xj, jnp.ones((x.shape[0],), jnp.float32),
                                jnp.asarray(np.asarray(centers)), m)[2])


# ------------------------------------------------------------ FCM / WFCMPB --

@pytest.mark.parametrize("n,weighted", [(600, False), (1000, True)])
def test_fcm_matches_reference(n, weighted):
    x, _ = RD.make_blobs(n, 8, 5, seed=11)
    w = (np.random.default_rng(1).uniform(0.5, 2.0, size=(n,)).astype(
        np.float32) if weighted else None)
    want = R.fcm(jnp.asarray(x), jnp.asarray(x[:5]), m=2.0, eps=1e-8,
                 max_iter=100, backend="jnp",
                 point_weights=None if w is None else jnp.asarray(w))
    got = T.fcm(x, x[:5], m=2.0, eps=1e-8, max_iter=100, backend="torch",
                point_weights=w, device="cpu")
    assert got.n_iter == int(want.n_iter)
    _close_centers(got.centers, want.centers)
    _close_centers(got.center_weights, want.center_weights)


@pytest.mark.parametrize("n,block_size", [(600, 200), (1000, 256)])
def test_wfcmpb_matches_reference(n, block_size):
    """(1000, 256): N is not a multiple of the block size, so the last
    block carries zero-weight phantom rows."""
    x, _ = RD.make_blobs(n, 8, 5, seed=11)
    want = R.wfcmpb(jnp.asarray(x), jnp.asarray(x[:5]), m=2.0, eps=1e-8,
                    max_iter=100, block_size=block_size, backend="jnp")
    got = T.wfcmpb(x, x[:5], m=2.0, eps=1e-8, max_iter=100,
                   block_size=block_size, backend="torch", device="cpu")
    assert got.n_iter == int(want.n_iter)
    _close_centers(got.centers, want.centers)
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=1e-5)


# -------------------------------------------------------------- BigFCM ---

def _reference_draws(cfg, n):
    """The reference fit's sample and seed indices (`bigfcm.py:_fit_array`
    and `_initial_centers`)."""
    k_sample, k_seed = jax.random.split(jax.random.PRNGKey(cfg.seed))
    lam = min(cfg.sample_size, n)
    sample_idx = np.asarray(jax.random.choice(k_sample, n, (lam,),
                                              replace=False))
    seed_idx = np.asarray(jax.random.choice(k_seed, lam, (cfg.n_clusters,),
                                            replace=False))
    return sample_idx, seed_idx


def test_bigfcm_fit_matches_reference():
    x, _ = RD.make_blobs(4000, 8, 4, seed=0)
    kw = dict(n_clusters=4, sample_size=512, use_driver=False)
    want = R.bigfcm_fit(jnp.asarray(x), R.BigFCMConfig(backend="jnp", **kw))
    sample_idx, seed_idx = _reference_draws(R.BigFCMConfig(**kw), 4000)
    got = T.bigfcm_fit(x, T.BigFCMConfig(backend="torch", **kw),
                       sample_idx=sample_idx,
                       seed_idx=seed_idx, device="cpu")
    _close_centers(got.centers, want.centers)
    assert got.diagnostics.combiner_iters == tuple(
        int(i) for i in want.diagnostics.combiner_iters)
    assert got.diagnostics.reducer_iters == int(
        want.diagnostics.reducer_iters)
    assert got.diagnostics.sample_size == want.diagnostics.sample_size == 512
    assert got.diagnostics.flag
    np.testing.assert_allclose(_global_q(x, got.centers, 2.0),
                               _global_q(x, want.centers, 2.0), rtol=1e-5)


def test_run_driver_matches_reference_branch():
    x, _ = RD.make_blobs(2000, 6, 3, seed=1)
    cfg_kw = dict(n_clusters=3, sample_size=256, block_size=128)
    sample_idx, seed_idx = _reference_draws(R.BigFCMConfig(**cfg_kw), 2000)
    xs = x[sample_idx]
    cfg = T.BigFCMConfig(backend="torch", **cfg_kw)
    v_init, flag, t_fcm, t_pb = T.run_driver(xs, cfg, seed_idx=seed_idx,
                                             device="cpu")
    assert t_fcm > 0 and t_pb > 0 and flag == (t_pb > t_fcm)
    seeds = jnp.asarray(xs[seed_idx])
    common = dict(m=cfg.m, eps=cfg.driver_eps, max_iter=cfg.max_iter,
                  backend="jnp")
    want = (R.fcm(jnp.asarray(xs), seeds, **common) if flag else
            R.wfcmpb(jnp.asarray(xs), seeds, block_size=cfg.block_size,
                     **common))
    _close_centers(v_init, want.centers)


def test_bigfcm_fit_default_draws_and_driver_recover_blobs():
    x, y = RD.make_blobs(4000, 8, 4, seed=0)
    res = T.bigfcm_fit(x, T.BigFCMConfig(n_clusters=4, sample_size=512,
                                         backend="torch"), device="cpu")
    pred = TM.assign(x, res.centers, device="cpu")
    agree = sum(np.bincount(y[pred == c]).max() for c in range(4)
                if (pred == c).any())
    assert agree / len(y) > 0.97
    assert res.diagnostics.t_fcm_driver > 0


def test_bigfcm_fit_rejects_paths_not_in_slice():
    """The mesh path runs (here on a 1-rank gloo mesh, which takes the
    single-device branch, as the reference's 1-device mesh does; the
    multi-rank mesh is tests/test_torch_mesh.py's); a `ChunkStore` input
    runs the out-of-core fit (`bigfcm_fit_store`, one shard) and refuses
    a mesh."""
    from repro_torch.data import ChunkStore
    from torch_mesh_jobs import one_rank_mesh
    x, _ = RD.make_blobs(100, 3, 2, seed=0)
    cfg = T.BigFCMConfig(n_clusters=2, sample_size=64, backend="torch")
    with one_rank_mesh() as mesh:
        on_mesh = T.bigfcm_fit(x, cfg, mesh=mesh, data_axes=("data",))
    plain = T.bigfcm_fit(x, cfg, device="cpu")
    assert torch.equal(on_mesh.centers, plain.centers)
    assert on_mesh.diagnostics.combiner_iters == \
        plain.diagnostics.combiner_iters
    store = ChunkStore.ingest(x, chunk_rows=64)
    with pytest.raises(ValueError, match="mesh"):
        T.bigfcm_fit(store, cfg, mesh=object(), device="cpu")
    got = T.bigfcm_fit(store, cfg, device="cpu")
    want = T.bigfcm_fit_store(store, cfg, device="cpu")
    assert torch.equal(got.centers, want.centers)
    assert got.diagnostics.combiner_iters == want.diagnostics.combiner_iters


# ------------------------------------------------ own copies of helpers ---

def test_sampling_copy_matches_reference():
    for c in (2, 5, 23):
        for r in (0.05, 0.1):
            assert TS.parker_hall_sample_size(c, r) == \
                RS.parker_hall_sample_size(c, r)
    for alpha in (0.05, 0.03, 0.001):
        assert TS.thompson_v(alpha) == RS.thompson_v(alpha)
        assert TS.thompson_sample_size(5, 0.05, alpha) == \
            RS.thompson_sample_size(5, 0.05, alpha)


@pytest.mark.parametrize("name,args", [
    ("make_blobs", (300, 5, 3)), ("make_susy_like", (200,)),
    ("make_higgs_like", (200,)), ("make_kdd_like", (500,))])
def test_synth_copy_matches_reference(name, args):
    for got, want in zip(getattr(TD, name)(*args, seed=4),
                         getattr(RD, name)(*args, seed=4)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_metrics_match_reference():
    x, _ = RD.make_blobs(500, 6, 4, seed=2)
    v = x[:4] + 0.5
    w = np.random.default_rng(0).uniform(0.5, 1.5, size=(500,)).astype(
        np.float32)
    xt, vt, wt = (torch.from_numpy(a) for a in (x, v, w))
    for pw, pwt in ((None, None), (jnp.asarray(w), wt)):
        np.testing.assert_allclose(
            float(TM.fuzzy_objective(xt, vt, 1.5, pwt)),
            float(RM.fuzzy_objective(jnp.asarray(x), jnp.asarray(v), 1.5,
                                     pw)), rtol=1e-5)
    np.testing.assert_array_equal(TM.assign(x, v, device="cpu"),
                                  RM.assign(x, v))
    assert TM.match_centers(v, x[:4]) == RM.match_centers(v, x[:4])


# ----------------------------------- metrics and synth (tests/test_infra) ---

def test_iris_copy_matches_reference():
    (x, y), (rx, ry) = TD.iris(), RD.iris()
    assert x.shape == (150, 4) and y.shape == (150,)
    assert np.bincount(y).tolist() == [50, 50, 50]
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    assert x.dtype == rx.dtype and y.dtype == ry.dtype


@pytest.mark.parametrize("n,seed", [(768, 0), (300, 5)])
def test_pima_like_copy_matches_reference(n, seed):
    for got, want in zip(TD.pima_like(n, seed=seed),
                         RD.pima_like(n, seed=seed)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_kdd_like_imbalanced():
    x, y = TD.make_kdd_like(5000)
    assert x.shape == (5000, 41)
    counts = np.bincount(y, minlength=23)
    assert counts.max() > 5 * max(counts[counts > 0].min(), 1)


def test_clustering_accuracy_perfect_permuted_and_reference():
    y = np.array([0, 0, 1, 1, 2, 2])
    a = np.array([2, 2, 0, 0, 1, 1])
    assert TM.clustering_accuracy(y, a, 3) == 1.0
    rng = np.random.default_rng(3)
    for c in (2, 4, 7):
        labels = rng.integers(0, 3, size=500)
        assign = rng.integers(0, c, size=500)
        assert TM.clustering_accuracy(labels, assign, c) == \
            RM.clustering_accuracy(labels, assign, c)


@pytest.mark.parametrize("n,max_points,seed", [(300, 300, 0),
                                               (600, 256, 7)])
def test_silhouette_matches_reference(n, max_points, seed):
    """(600, 256): the subsampled branch, drawn from ``seed``."""
    x, y = TD.pima_like(n)
    s = TM.silhouette_width(x, y, max_points=max_points, seed=seed)
    assert -1.0 <= s <= 1.0
    assert s == RM.silhouette_width(x, y, max_points=max_points, seed=seed)


def test_relative_speedup_matches_reference():
    for a, b in ((3.0, 1.5), (1.0, 0.0), (2.5, 7.0)):
        assert TM.relative_speedup(a, b) == RM.relative_speedup(a, b)
