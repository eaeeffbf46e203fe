"""`repro_torch`'s out-of-core store path against `repro`'s, on the same
on-disk store: the `ChunkStore` format both ways, the partition plans,
the out-of-core loops (`ooc_fcm`, `wfcmpb_store`), the store fit, the
MR-FKM baseline, store scoring, and checkpoints (both ways).  Mirrors
tests/test_plane.py on its `blob_store` fixture; both packages get the
same numpy inputs, and the port the reference's `jax.random` draws.

The port runs on the CPU here (``device="cpu"``, the ``torch`` backend);
the reference on its ``jnp`` backend.  A store fit is compared by its
centers (1e-4) and by the global q of its centers recomputed with
`repro.engine.fcm_accumulate` (1e-5 relative), never by the one-shard
``.objective`` (the reducer's self-polish objective, f32 noise)."""
import collections
import json
import os
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines as RB
import repro.core as RC
import repro.data as RD
import repro.serve as RSV
import repro.tenant as RT
import repro_torch.baselines as TB
import repro_torch.core as TC
import repro_torch.data as TD
import repro_torch.serve as TSV
import repro_torch.tenant as TT
from repro.core.bigfcm import _sample_rows
from repro.engine import fcm_accumulate as ref_accumulate
from repro.ft import CheckpointManager as RefCkpt
from repro_torch.core.bigfcm import _draws
from repro_torch.engine import fcm_accumulate
from repro_torch.ft import CheckpointManager as PortCkpt

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def blob_store(tmp_path_factory):
    """8192×8 blobs spilled to an on-disk store in 1024-row chunks by the
    reference (tests/test_plane.py's fixture), and the same directory
    opened by the port."""
    x, _ = RD.make_blobs(8192, 8, 5, seed=3)
    x = x.astype(np.float32)
    d = tmp_path_factory.mktemp("chunk_cache")
    ref = RD.ChunkStore.ingest(
        iter([x[i:i + 1000] for i in range(0, 8192, 1000)]),
        chunk_rows=1024, cache_dir=str(d))
    return x, ref, TD.ChunkStore.open(str(d))


def _global_q(x, centers, m=2.0):
    return float(ref_accumulate(
        jnp.asarray(x), jnp.ones((x.shape[0],), jnp.float32),
        jnp.asarray(np.asarray(centers)), m)[2])


def _ref_draws(cfg, n):
    """The reference store fit's draws (`_fit_store`, use_driver=False)."""
    k_sample, k_seed = jax.random.split(jax.random.PRNGKey(cfg.seed))
    lam = min(cfg.sample_size, n)
    sample_idx = _sample_rows(k_sample, n, lam)
    seed_idx = np.asarray(jax.random.choice(k_seed, lam, (cfg.n_clusters,),
                                            replace=False))
    return sample_idx, seed_idx


def _same_store(a, b):
    assert (a.content_hash, a.rows, a.dim, a.chunk_rows, a.n_chunks) == \
        (b.content_hash, b.rows, b.dim, b.chunk_rows, b.n_chunks)
    for i in range(a.n_chunks):
        np.testing.assert_array_equal(np.asarray(a.chunk(i)),
                                      np.asarray(b.chunk(i)))
    for f, g in zip(a.stats(), b.stats()):
        np.testing.assert_array_equal(f, g)


# ------------------------------------------------------------- the format --

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_opens_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 5)).astype(np.float32)
    src, dst = (RD, TD) if writer == "reference" else (TD, RD)
    written = src.ChunkStore.ingest(iter([x[:300], x[300:]]), chunk_rows=128,
                                    cache_dir=str(tmp_path))
    opened = dst.ChunkStore.open(str(tmp_path))
    _same_store(written, opened)
    assert opened.verify()
    idx = rng.integers(0, 1000, 37)
    np.testing.assert_array_equal(opened.take(idx), written.take(idx))
    # the manifest is the reference's, key for key
    with open(tmp_path / "manifest.json") as f:
        assert sorted(json.load(f)) == [
            "chunk_rows", "col_stats", "content_hash", "dim",
            "dtype", "format_version", "rows"]


def test_chunkstore_roundtrip_take_and_hash(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 5)).astype(np.float32)
    s = TD.ChunkStore.ingest(iter([x[:300], x[300:]]), chunk_rows=128,
                             cache_dir=str(tmp_path))
    assert (s.n_rows, s.dim, s.n_chunks) == (1000, 5, 8)
    assert s.rows[-1] == 1000 - 7 * 128           # short tail chunk
    reopened = TD.ChunkStore.open(str(tmp_path))
    np.testing.assert_array_equal(reopened.materialize(), x)
    idx = rng.integers(0, 1000, 37)
    np.testing.assert_array_equal(reopened.take(idx), x[idx])
    assert reopened.verify()
    # the content hash identifies the DATA, not the chunking, and is the
    # reference's
    ref_hash = RD.ChunkStore.ingest(x, chunk_rows=64).content_hash
    assert TD.ChunkStore.ingest(x, chunk_rows=333).content_hash \
        == s.content_hash == ref_hash
    assert TD.ChunkStore.ingest(x[::-1].copy(),
                                chunk_rows=333).content_hash \
        != s.content_hash
    with pytest.raises(IndexError):
        s.take([1000])


def test_chunkstore_invalidation_rules(tmp_path):
    x = np.ones((100, 3), np.float32)
    s = TD.ChunkStore.ingest(x, chunk_rows=40, cache_dir=str(tmp_path))
    # 1. no manifest (interrupted ingest) ⇒ invalid
    os.remove(tmp_path / "manifest.json")
    with pytest.raises(TD.CacheInvalid):
        TD.ChunkStore.open(str(tmp_path))
    # 2. manifest/chunk shape mismatch ⇒ invalid, in both packages
    s = TD.ChunkStore.ingest(x, chunk_rows=40, cache_dir=str(tmp_path))
    np.save(tmp_path / "chunk_000001.npy", np.ones((7, 3), np.float32))
    for pkg in (TD, RD):
        with pytest.raises(pkg.CacheInvalid):
            pkg.ChunkStore.open(str(tmp_path))
    # 3. same shape but corrupted bytes ⇒ open succeeds, verify() fails
    s = TD.ChunkStore.ingest(x, chunk_rows=40, cache_dir=str(tmp_path))
    bad = np.asarray(s.chunk(1)).copy()
    bad[0, 0] += 1.0
    np.save(tmp_path / "chunk_000001.npy", bad)
    assert not TD.ChunkStore.open(str(tmp_path)).verify()
    assert not RD.ChunkStore.open(str(tmp_path)).verify()


def test_open_or_ingest_skips_source_on_warm_cache(tmp_path):
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    cold = TD.ChunkStore.open_or_ingest(str(tmp_path), lambda: iter([x]),
                                        chunk_rows=8)
    assert cold.n_rows == 20

    def exploding():
        raise AssertionError("warm start must not re-read the source")

    warm = TD.ChunkStore.open_or_ingest(str(tmp_path), exploding,
                                        chunk_rows=8)
    assert warm.content_hash == cold.content_hash
    np.testing.assert_array_equal(warm.materialize(), x)
    # the reference's warm start takes the port's cache too
    ref_warm = RD.ChunkStore.open_or_ingest(str(tmp_path), exploding,
                                            chunk_rows=8)
    assert ref_warm.content_hash == cold.content_hash
    rechunked = TD.ChunkStore.open_or_ingest(str(tmp_path),
                                             lambda: iter([x]), chunk_rows=5)
    assert rechunked.chunk_rows == 5 and rechunked.n_rows == 20
    y = x + 1.0
    repinned = TD.ChunkStore.open_or_ingest(
        str(tmp_path), lambda: iter([y]), chunk_rows=5,
        expected_hash=RD.ChunkStore.ingest(y, chunk_rows=5).content_hash)
    np.testing.assert_array_equal(repinned.materialize(), y)


def test_empty_source_rejected():
    with pytest.raises(ValueError):
        TD.ChunkStore.ingest(iter([]))


def test_stats_and_normalizer_match_reference():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(3.0, 2.0, size=(400, 2)),
                        np.full((400, 1), 6.0)], axis=1).astype(np.float32)
    ref = RD.ChunkStore.ingest(x, chunk_rows=100)
    port = TD.ChunkStore.ingest(x, chunk_rows=100)
    for f, g in zip(ref.stats(), port.stats()):
        np.testing.assert_array_equal(f, g)
    for kind in ("standard", "minmax"):
        np.testing.assert_array_equal(port.normalizer(kind)(x),
                                      ref.normalizer(kind)(x))
    with pytest.raises(ValueError):
        port.normalizer("weird")


# -------------------------------------------------------------- the plans --

@pytest.mark.parametrize("n_shards", range(1, 10))
def test_plans_equal_reference(blob_store, n_shards):
    _, ref, port = blob_store
    a = TD.plan_partitions(port, n_shards)
    b = RD.plan_partitions(ref, n_shards)
    assert (a.n_shards, a.assignment, a.shard_rows) == \
        (b.n_shards, b.assignment, b.shard_rows)
    assert a.fingerprint() == b.fingerprint()
    assert all(a.chunks_of(s) == b.chunks_of(s) for s in range(n_shards))
    assert sum(a.shard_rows) == port.n_rows


def test_replan_moves_as_reference(blob_store):
    _, ref, port = blob_store
    for old, new in ((2, 4), (4, 3), (9, 1)):
        got, moved = TD.replan(port, TD.plan_partitions(port, old), new)
        want, want_moved = RD.replan(ref, RD.plan_partitions(ref, old), new)
        assert (got.assignment, moved) == (want.assignment, want_moved)


def test_shard_batches_phantoms_ignored_by_accumulation(blob_store):
    x, ref, port = blob_store
    plan, rplan = TD.plan_partitions(port, 3), RD.plan_partitions(ref, 3)
    v = torch.from_numpy(x[:5])
    total, rows_seen = None, 0.0
    for s in range(3):
        # batch size that does NOT divide the shard rows ⇒ padded tails
        got = list(TD.shard_batches(port, plan, s, 700))
        want = list(RD.shard_batches(ref, rplan, s, 700))
        assert len(got) == len(want)
        for (bx, bw), (rx, rw) in zip(got, want):
            np.testing.assert_array_equal(bx, rx)
            np.testing.assert_array_equal(bw, rw)
        vn, wi, qi = TC.ooc_accumulate(got, v, 2.0, backend="torch", **CPU)
        total = (vn, wi, qi) if total is None else (
            total[0] + vn, total[1] + wi, total[2] + qi)
        rows_seen += sum(float(bw.sum()) for _, bw in got)
    assert rows_seen == port.n_rows                   # exact row counts
    want = ref_accumulate(jnp.asarray(x), jnp.ones((x.shape[0],), np.float32),
                          jnp.asarray(x[:5]), 2.0)
    for g, e in zip(total, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-5)


def test_buckets_and_as_store_match_reference(blob_store):
    x, _, port = blob_store
    for max_rows, base, factor in ((1000, 64, 2), (64, 64, 2),
                                   (4096, 32, 4)):
        assert TD.shape_buckets(max_rows, base=base, factor=factor) == \
            RD.shape_buckets(max_rows, base=base, factor=factor)
    ladder = TD.shape_buckets(1000)
    assert [TD.bucket_for(n, ladder) for n in (1, 64, 65, 1000)] == \
        [RD.bucket_for(n, ladder) for n in (1, 64, 65, 1000)]
    with pytest.raises(ValueError):
        TD.bucket_for(1001, ladder)
    assert TD.as_store(port) is port
    assert TD.as_store(x, chunk_rows=1000).content_hash == port.content_hash


# ---------------------------------------------------- out-of-core loops ---

def test_ooc_accumulate_equals_one_sweep_over_the_array(blob_store):
    x, _, port = blob_store
    v = x[:5]
    got = TC.ooc_accumulate(TD.batched(port.iter_chunks(), 1024), v, 2.0,
                            backend="torch", **CPU)
    want = fcm_accumulate(torch.from_numpy(x), torch.ones(x.shape[0]),
                          torch.from_numpy(v), 2.0)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=2e-5, atol=1e-3)
    with pytest.raises(ValueError, match="empty"):
        TC.ooc_accumulate(iter([]), v, 2.0, backend="torch", **CPU)


def test_ooc_fcm_matches_reference(blob_store):
    x, ref, port = blob_store
    plan, rplan = TD.plan_partitions(port, 2), RD.plan_partitions(ref, 2)
    want = RC.ooc_fcm(lambda: RD.shard_batches(ref, rplan, 1, 700),
                      jnp.asarray(x[:5]), m=2.0, eps=1e-6, max_iter=100,
                      backend="jnp")
    got = TC.ooc_fcm(lambda: TD.shard_batches(port, plan, 1, 700), x[:5],
                     m=2.0, eps=1e-6, max_iter=100, backend="torch", **CPU)
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               atol=1e-5)
    np.testing.assert_allclose(got.center_weights.numpy(),
                               np.asarray(want.center_weights), rtol=1e-5)


@pytest.mark.parametrize("shard", [None, 1])
def test_wfcmpb_store_matches_reference(blob_store, shard):
    """The whole store, and one shard of a 3-shard plan (the combiner of
    a multi-shard store fit)."""
    x, ref, port = blob_store
    kw = dict(m=2.0, eps=1e-6, max_iter=200, batch_rows=1024)
    want = RC.wfcmpb_store(
        ref, jnp.asarray(x[:5]), backend="jnp",
        plan=None if shard is None else RD.plan_partitions(ref, 3),
        shard=shard or 0, **kw)
    got = TC.wfcmpb_store(
        port, x[:5], backend="torch",
        plan=None if shard is None else TD.plan_partitions(port, 3),
        shard=shard or 0, **kw, **CPU)
    assert got.n_iter == int(want.n_iter)
    rel = abs(float(got.objective) - float(want.objective)) \
        / abs(float(want.objective))
    assert rel <= 1e-4, rel
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               atol=1e-4)


def test_wfcmpb_batches_without_objective_is_nan(blob_store):
    x, _, port = blob_store
    res = TC.wfcmpb_batches(lambda: TD.batched(port.iter_chunks(), 2048),
                            x[:5], eps=1e-4, max_iter=50, backend="torch",
                            with_objective=False, **CPU)
    assert np.isnan(float(res.objective)) and res.n_iter > 0
    with pytest.raises(ValueError, match="empty"):
        TC.wfcmpb_batches(lambda: iter([]), x[:5], backend="torch", **CPU)


# ----------------------------------------------------------- store fit ---

@pytest.mark.parametrize("n_shards,extra", [
    (1, {}), (4, {}),
    ("more", dict(sample_size=256, combiner_eps=1e-6, max_iter=60))])
def test_bigfcm_fit_store_matches_reference(blob_store, n_shards, extra):
    """One shard (the self-polish reducer), four shards (the flat reducer
    over the stacked summaries, then the global-objective pass) and more
    shards than chunks (clamped to one combiner per chunk)."""
    x, ref, port = blob_store
    if n_shards == "more":
        n_shards = port.n_chunks + 5
    kw = dict(n_clusters=5, use_driver=False, sample_size=512, seed=0)
    kw.update(extra)
    rcfg = RC.BigFCMConfig(backend="jnp", **kw)
    want = RC.bigfcm_fit_store(ref, rcfg, n_shards=n_shards)
    sample_idx, seed_idx = _ref_draws(rcfg, ref.n_rows)
    got = TC.bigfcm_fit_store(port, TC.BigFCMConfig(backend="torch", **kw),
                              n_shards=n_shards, sample_idx=sample_idx,
                              seed_idx=seed_idx, **CPU)
    assert got.diagnostics.combiner_iters == tuple(
        int(i) for i in np.asarray(want.diagnostics.combiner_iters))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               atol=1e-4)
    q_got, q_want = _global_q(x, got.centers), _global_q(x, want.centers)
    assert abs(q_got - q_want) / q_want <= 1e-5
    if n_shards > 1:       # the multi-shard return is the global objective
        assert abs(float(got.objective) - q_want) / q_want <= 1e-4


def test_bigfcm_fit_store_matches_in_memory_fit(blob_store):
    """The same default draws (numpy `default_rng(cfg.seed)`): a store
    that fits reproduces the in-memory fit to f32 summation order."""
    x, _, port = blob_store
    cfg = TC.BigFCMConfig(n_clusters=5, use_driver=False, sample_size=512,
                          seed=0, backend="torch")
    mem = TC.bigfcm_fit(x, cfg, **CPU)
    ooc = TC.bigfcm_fit_store(port, cfg, **CPU)
    assert mem.diagnostics.combiner_iters == ooc.diagnostics.combiner_iters
    torch.testing.assert_close(ooc.centers, mem.centers, rtol=0, atol=1e-4)


def test_driver_seeds_match_reference(blob_store):
    _, ref, port = blob_store
    for use_driver in (False, True):
        kw = dict(n_clusters=5, sample_size=512, seed=1,
                  use_driver=use_driver)
        rcfg = RC.BigFCMConfig(backend="jnp", **kw)
        sample_idx, seed_idx = _ref_draws(rcfg, ref.n_rows)
        got = TC.driver_seeds(port, TC.BigFCMConfig(backend="torch", **kw),
                              sample_idx=sample_idx, seed_idx=seed_idx, **CPU)
        np.testing.assert_allclose(got, RC.driver_seeds(ref, rcfg),
                                   atol=1e-4)


def test_store_sample_is_o_lambda_for_huge_row_counts():
    """λ distinct rows of 2²⁹ in O(λ) memory (a permutation would take
    4 GiB), in range, the same on every call."""
    cfg = TC.BigFCMConfig(n_clusters=5, sample_size=512, seed=7)
    n = 1 << 29
    tracemalloc.start()
    try:
        lam, idx, seed_idx = _draws(cfg, n, None, None)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 22, peak
    assert lam == 512 and idx.shape == (512,) and len(np.unique(idx)) == 512
    assert idx.min() >= 0 and idx.max() < n
    assert len(np.unique(seed_idx)) == 5 and seed_idx.max() < 512
    again = _draws(cfg, n, None, None)
    np.testing.assert_array_equal(idx, again[1])
    np.testing.assert_array_equal(seed_idx, again[2])


def test_bigfcm_store_rejects_mesh_args(blob_store):
    _, _, port = blob_store
    cfg = TC.BigFCMConfig(n_clusters=5)
    with pytest.raises(ValueError, match="point_weights"):
        TC.bigfcm_fit(port, cfg, point_weights=np.ones(port.n_rows), **CPU)
    with pytest.raises(ValueError, match="mesh"):
        TC.bigfcm_fit(port, cfg, mesh=object(), **CPU)


# ------------------------------------------------ baseline and scoring ---

def test_mr_fkm_matches_reference(blob_store):
    x, ref, port = blob_store
    kw = dict(m=2.0, eps=1e-6, max_iter=60)
    want, jobs_want, _ = RB.mr_fuzzy_kmeans_store(ref, jnp.asarray(x[:5]),
                                                  backend="jnp", **kw)
    got, jobs_got, _ = TB.mr_fuzzy_kmeans_store(port, x[:5], backend="torch",
                                                **kw, **CPU)
    mem, jobs_mem, _ = TB.mr_fuzzy_kmeans(x, x[:5], backend="torch", **kw,
                                          **CPU)
    assert jobs_got == jobs_want == jobs_mem == got.n_iter
    for res in (got, mem):
        np.testing.assert_allclose(res.centers.numpy(),
                                   np.asarray(want.centers), atol=1e-4)
    # a 1-rank mesh runs the single-device jobs (the 4-rank mesh is
    # tests/test_torch_mesh.py's)
    from torch_mesh_jobs import one_rank_mesh
    with one_rank_mesh() as mesh:
        on_mesh, jobs_mesh, _ = TB.mr_fuzzy_kmeans(x, x[:5], mesh=mesh,
                                                   backend="torch", **kw)
    assert jobs_mesh == jobs_mem
    assert torch.equal(on_mesh.centers, mem.centers)


def _soft64(x, v, m):
    """The exact memberships: float64, the direct ‖x − v‖²."""
    d2 = np.maximum(((x.astype(np.float64)[:, None]
                      - v.astype(np.float64)[None]) ** 2).sum(-1), 1e-12)
    r = np.exp(-(np.log(d2) - np.log(d2).min(-1, keepdims=True)) / (m - 1))
    return r / r.sum(-1, keepdims=True)


def test_assign_store_matches_reference(blob_store):
    """Hard labels equal the reference's (both on their f32 backends:
    "auto" may resolve the reference to its bf16 one on this host), and
    the store path equals the direct scorer, as tests/test_plane.py
    holds the reference (soft at 1e-6).  Across packages the soft
    memberships part by the d² expansion's f32 rounding (two BLAS dot
    orders; up to 5e-6 on these blobs, which lie up to 15 from the
    origin), so there the port is held to the exact float64 memberships,
    no farther than twice the reference's own distance."""
    x, ref, port = blob_store
    v = x[:5]
    hard = TSV.make_assigner(v, backend="torch", **CPU)
    got = np.concatenate(list(TSV.assign_store(port, v, assigner=hard,
                                               **CPU)))
    np.testing.assert_array_equal(
        got, np.concatenate(list(RSV.assign_store(ref, jnp.asarray(v),
                                                  backend="jnp"))))
    assert hard.traces == 1      # the padded tail chunk: one shape
    np.testing.assert_array_equal(hard(x).numpy(), got)
    assert hard.traces == 2      # a second shape
    soft = np.concatenate(list(TSV.assign_store(port, v, soft=True,
                                                backend="torch", **CPU)))
    np.testing.assert_allclose(
        soft, TSV.make_assigner(v, soft=True, backend="torch",
                                **CPU)(x).numpy(), atol=1e-6)
    want = np.concatenate(list(RSV.assign_store(
        ref, jnp.asarray(v), soft=True, backend="jnp")))
    exact = _soft64(x, v, 2.0)
    assert np.abs(soft - exact).max() <= \
        2 * np.abs(want - exact).max() + 1e-6


# ----------------------------------------------------------- checkpoints ---

NT = collections.namedtuple("NT", "centers weights")


def _tree(k):
    rng = np.random.default_rng(k)
    return {"b": NT(rng.normal(size=(3, 2)).astype(np.float32),
                    rng.uniform(size=3).astype(np.float32)),
            "a": [np.arange(4, dtype=np.int32) * k,
                  {"z": np.float32(k),
                   "y": rng.normal(size=(2,)).astype(np.float32)}],
            "none": None}


def _assert_tree_equal(got, want):
    ga = [np.asarray(v) for v in jax.tree_util.tree_leaves(got)]
    wa = [np.asarray(v) for v in jax.tree_util.tree_leaves(want)]
    assert len(ga) == len(wa)
    for g, w in zip(ga, wa):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_read(tmp_path, writer):
    ckpts = (RefCkpt, PortCkpt) if writer == "reference" else \
        (PortCkpt, RefCkpt)
    w = ckpts[0](str(tmp_path), keep=2, async_save=True)
    for step in (1, 2, 3):
        w.save(step, _tree(step))
    w.wait()
    r = ckpts[1](str(tmp_path))
    assert r.all_steps() == w.all_steps() == [2, 3]         # keep-last-k
    assert r.latest_step() == 3
    want = _tree(3)
    arrs = r.restore_arrays()
    assert sorted(arrs) == ["a/0", "a/1/y", "a/1/z", "b/centers",
                            "b/weights"]
    _assert_tree_equal([arrs[k] for k in sorted(arrs)],
                       [want["a"][0], want["a"][1]["y"], want["a"][1]["z"],
                        want["b"].centers, want["b"].weights])
    sub = r.restore_arrays(2, keys=("b/weights", "missing"))
    assert list(sub) == ["b/weights"]
    np.testing.assert_array_equal(sub["b/weights"], _tree(2)["b"].weights)
    got = r.restore(_tree(0))
    assert isinstance(got["b"], NT) and got["none"] is None
    _assert_tree_equal(got, want)


def test_port_checkpoint_tensors_and_async_snapshot(tmp_path):
    """A tensor leaf is snapshotted in `save`: mutating it after the call
    does not reach the checkpoint; `restore` gives tensors back in the
    template's dtype, and the reference reads the same values."""
    mgr = PortCkpt(str(tmp_path), async_save=True)
    state = {"centers": torch.arange(6, dtype=torch.float32).reshape(3, 2),
             "step": torch.tensor(7)}
    mgr.save(5, state)
    state["centers"].add_(100.0)
    mgr.wait()
    got = mgr.restore({"centers": torch.zeros(3, 2), "step": torch.tensor(0)})
    torch.testing.assert_close(got["centers"],
                               torch.arange(6.0).reshape(3, 2))
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 7
    ref = RefCkpt(str(tmp_path)).restore_arrays()
    np.testing.assert_array_equal(ref["centers"],
                                  np.arange(6, dtype=np.float32).reshape(3, 2))
    # a sharded restore (the LM trainer's) checks its placement tree
    # against the tree first (tests/test_torch_elastic.py restores one)
    with pytest.raises(ValueError, match="placement tree does not match"):
        mgr.restore(state, shardings=(None, {"centers": (None, None)}))


def test_interrupted_write_leaves_latest_good_checkpoint(tmp_path):
    """A ``.tmp`` directory left by a write that died is never listed or
    restored, by either package, and a later save of that step
    publishes over it."""
    mgr = PortCkpt(str(tmp_path), async_save=False)
    mgr.save(1, _tree(1))
    tmp = tmp_path / "step_0000000002.tmp"
    tmp.mkdir()
    np.save(tmp / "a__0.npy", np.zeros(4))          # no manifest yet
    for m in (mgr, RefCkpt(str(tmp_path))):
        assert m.all_steps() == [1] and m.latest_step() == 1
        _assert_tree_equal(m.restore(_tree(0)), _tree(1))
    mgr.save(2, _tree(2))
    assert mgr.all_steps() == [1, 2] and not tmp.exists()
    _assert_tree_equal(RefCkpt(str(tmp_path)).restore(_tree(0)), _tree(2))
    with pytest.raises(FileNotFoundError):
        PortCkpt(str(tmp_path / "empty")).restore_arrays()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tenant_checkpoint_cross_read_with_subset(tmp_path, writer):
    rng = np.random.default_rng(2)
    ids = [f"user{i}" for i in range(6)]
    kw = dict(versions=np.arange(6), objective=rng.uniform(size=6),
              n_iter=np.arange(6) + 3)
    centers = rng.normal(size=(6, 3, 4))
    weights = rng.uniform(size=(6, 3))
    wpkg, rpkg = (RT, TT) if writer == "reference" else (TT, RT)
    wck, rck = (RefCkpt, PortCkpt) if writer == "reference" else \
        (PortCkpt, RefCkpt)
    ts = wpkg.tenant_set(ids, centers, weights, **kw)
    wpkg.save_tenants(wck(str(tmp_path)), 4, ts)
    full = rpkg.load_tenants(rck(str(tmp_path)))
    sub = rpkg.load_tenants(rck(str(tmp_path)), 4,
                            tenants=["user5", "user1"])
    assert full.ids == ts.ids and sub.ids == ("user5", "user1")
    for f in ("centers", "weights", "versions", "objective", "n_iter"):
        np.testing.assert_array_equal(getattr(full, f), getattr(ts, f))
        np.testing.assert_array_equal(getattr(sub, f),
                                      getattr(ts, f)[[5, 1]])
        assert getattr(full, f).dtype == getattr(ts, f).dtype
    with pytest.raises(FileNotFoundError):
        TT.load_tenants(PortCkpt(str(tmp_path / "none")))
