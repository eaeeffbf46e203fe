"""The Hopper FCM kernels (single-model and tenant-stacked) on a card,
against their plain PyTorch versions on the same card.  Every test carries the ``cuda`` marker and skips on a
host without a card.  The file imports no jax, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (BigFCMConfig, StagingRing, bigfcm_fit,
                              ooc_accumulate)
from repro_torch.data import (ChunkStore, batched, make_blobs,
                              make_moving_blobs, replay_source,
                              stream_loader)
from repro_torch.engine import MergePlan, merge_summaries, summary
from repro_torch.kernels import fcm_update, ops
from repro_torch.kernels.fcm_update import (_batched_plan, _plan,
                                            fcm_accumulate_batched_cuda,
                                            fcm_accumulate_batched_ref,
                                            fcm_accumulate_cuda,
                                            fcm_accumulate_ref,
                                            fcm_sweep_batched_cuda,
                                            fcm_sweep_batched_ref,
                                            fcm_sweep_cuda, fcm_sweep_ref)
from repro_torch.serve import assign_stream
from repro_torch.stream import StreamConfig, StreamingBigFCM
from repro_torch.tenant import TenantFitConfig, fit_tenants

pytestmark = pytest.mark.cuda

SHAPES = [
    (64, 2, 2), (100, 130, 7), (257, 4, 3), (1000, 18, 10),
    (2048, 28, 50), (31, 41, 23), (512, 8, 129),
]
OFF_LANE_SHAPES = [
    (300, 130, 131), (200, 129, 140), (96, 257, 129), (513, 131, 200),
]
# C > 128 in the former first version's domain: the path the card
# measured faster (PERF.md §6)
WIDE_PAST_128 = "wide"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, c, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a).to(device) for a in (
        rng.normal(size=(n, d)).astype(np.float32),
        rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32),
        rng.normal(size=(c, d)).astype(np.float32))]


def _close(got, want, rtol, atol):
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=rtol, atol=atol)


@pytest.mark.parametrize("m", [1.05, 1.2, 2.0, 3.0])
@pytest.mark.parametrize("n,d,c", SHAPES + OFF_LANE_SHAPES)
def test_kernel_matches_plain(card, n, d, c, m):
    x, w, v = _inputs(n, d, c, n + d + c, card)
    before = fcm_sweep_cuda.launches
    _close(fcm_sweep_cuda(x, w, v, m), fcm_sweep_ref(x, w, v, m),
           3e-4, 3e-5 if (n, d, c) in SHAPES else 3e-4)
    _close(fcm_accumulate_cuda(x, w, v, m), fcm_accumulate_ref(x, w, v, m),
           3e-4, 3e-3)
    assert fcm_sweep_cuda.launches == before + 1


def _driver_case(case, d, c, card):
    """The kernel's inputs on the driver race (N(0, 1) records): the
    3184-row sample seeded with C of its rows; WFCMPB's last 2048-row
    block, its tail zero-weight phantoms; WFCMPB's first 2·C-point merge,
    its running half of zero mass, seeded with the block's centers."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3184, d))
    if case == "sample":
        arrs = x, np.ones(3184), x[:c]
    elif case == "last_block":
        xb, wb = np.zeros((2048, d)), np.zeros(2048)
        xb[:1136], wb[:1136] = x[2048:], 1.0
        arrs = xb, wb, rng.normal(size=(c, d))
    else:
        vb = rng.normal(size=(c, d))
        arrs = (np.concatenate([x[:c], vb]),
                np.concatenate([np.zeros(c), rng.uniform(1, 2048, c)]), vb)
    return [torch.as_tensor(np.asarray(a, np.float32), device=card)
            for a in arrs]


@pytest.mark.parametrize("case", ["sample", "last_block", "first_merge"])
@pytest.mark.parametrize("d,c,m", [(28, 2, 2.0), (41, 23, 1.2)])
def test_kernel_matches_plain_at_driver_inputs(card, case, d, c, m):
    """Centers and masses at the sweep tolerances.  In the merge, C records
    lie on centers, where the kernel's d² = ‖x‖² + ‖v‖² − 2x·v (the TPU
    kernel's formula) is rounding noise and the plain ‖x − v‖² is 0: q
    is held there to that expansion's f32 rounding bound."""
    x, w, v = _driver_case(case, d, c, card)
    q_atol = 0.0
    if case == "first_merge":
        q_atol = 2 * (d + 2) * 2.0 ** -24 * float(
            (w * ((x * x).sum(1) + (v * v).sum(1).max())).sum())
    for kern, plain, atol in ((fcm_sweep_cuda, fcm_sweep_ref, 3e-5),
                              (fcm_accumulate_cuda, fcm_accumulate_ref, 3e-3)):
        got, want = kern(x, w, v, m), plain(x, w, v, m)
        _close(got[:2], want[:2], 3e-4, atol)
        torch.testing.assert_close(got[2], want[2], rtol=3e-4,
                                   atol=atol + q_atol)


def test_kernel_bitwise_deterministic_and_chunk_additive(card):
    x, w, v = _inputs(50_000, 41, 23, 5, card)
    a = fcm_accumulate_cuda(x, w, v, 1.2)
    b = fcm_accumulate_cuda(x, w, v, 1.2)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    cuts = [0, 12_345, 30_000, 50_000]
    got = ops.accumulate_chunks([x[i:j] for i, j in zip(cuts, cuts[1:])],
                                [w[i:j] for i, j in zip(cuts, cuts[1:])],
                                v, 1.2)
    _close(got, fcm_sweep_cuda(x, w, v, 1.2), 1e-5, 1e-5)


def test_kernel_rejects_bad_inputs(card):
    x, w, v = _inputs(10, 3, 2, 0, card)
    with pytest.raises(ValueError, match="do not form"):
        fcm_sweep_cuda(x, w[:5], v)
    with pytest.raises(ValueError, match="x on"):
        fcm_sweep_cuda(x, w.cpu(), v)
    with pytest.raises(TypeError, match="floating"):
        fcm_sweep_cuda(x.to(torch.int32), w, v)
    # V (64 x 4000) fits no shared memory: the C-tiled kernel takes it.
    x, w = _inputs(10, 4000, 64, 0, card)[:2]
    v = _inputs(1, 4000, 64, 0, card)[2]
    before = fcm_sweep_cuda.shapes.copy()
    _close(fcm_sweep_cuda(x, w, v), fcm_sweep_ref(x, w, v), 3e-4, 3e-5)
    assert _launched_path(fcm_sweep_cuda, before) == "ctiled"
    _close(fcm_accumulate_cuda(x, w, v), fcm_accumulate_ref(x, w, v), 3e-4,
           3e-3)


def test_bigfcm_fit_through_kernel(card, monkeypatch, tmp_path):
    """"auto", the card default, runs the fit through a Hopper kernel
    (the race crowns only kernel backends on the card) and lands where
    the plain torch backend does from the same seeds."""
    from repro_torch.engine import resolve_backend
    from repro_torch.perf import calibrate
    monkeypatch.setenv(calibrate.ENV_DIR, str(tmp_path))
    calibrate.clear_memory_cache()
    x, _ = make_blobs(4000, 8, 4, seed=0)
    kw = dict(n_clusters=4, sample_size=512, use_driver=False)
    rng = np.random.default_rng(0)
    sample_idx = rng.choice(4000, 512, replace=False)
    seed_idx = rng.choice(512, 4, replace=False)
    try:
        assert resolve_backend("auto", device=card,
                               shape=(512, 4, 8)).kernel
        before = fcm_sweep_cuda.launches + fcm_accumulate_cuda.launches
        fits = [bigfcm_fit(x, BigFCMConfig(backend=b, **kw),
                           sample_idx=sample_idx, seed_idx=seed_idx,
                           device=card) for b in ("auto", "torch")]
        after = fcm_sweep_cuda.launches + fcm_accumulate_cuda.launches
    finally:
        calibrate.clear_memory_cache()
    assert after > before
    torch.testing.assert_close(fits[0].centers, fits[1].centers,
                               rtol=2e-3, atol=2e-4)
    assert fits[0].diagnostics.combiner_iters == \
        fits[1].diagnostics.combiner_iters


def _stack(t, n, d, c, seed, device, phantoms=2):
    """Tenant-stacked inputs: ragged rows padded by zero-weight phantom
    rows, then ``phantoms`` all-zero phantom tenants."""
    rng = np.random.default_rng(seed)
    x = np.zeros((t + phantoms, n, d), np.float32)
    w = np.zeros((t + phantoms, n), np.float32)
    v = np.zeros((t + phantoms, c, d), np.float32)
    for i in range(t):
        rows = int(rng.integers(max(1, n // 3), n + 1))
        x[i, :rows] = rng.normal(size=(rows, d))
        w[i, :rows] = rng.uniform(0.1, 3.0, size=rows)
        v[i] = rng.normal(size=(c, d))
    m = rng.choice([1.05, 1.2, 2.0, 3.0], size=t + phantoms).astype(
        np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, w, v, m)]


@pytest.mark.parametrize("scalar_m", [False, True])
@pytest.mark.parametrize("d,c", [(4, 3), (41, 23)])
@pytest.mark.parametrize("t", [1, 5, 64])
def test_batched_kernel_matches_plain(card, t, d, c, scalar_m):
    x, w, v, m = _stack(t, 300, d, c, t + d + c, card)
    m = 1.2 if scalar_m else m
    before = fcm_sweep_batched_cuda.launches
    got = fcm_sweep_batched_cuda(x, w, v, m)
    assert fcm_sweep_batched_cuda.launches == before + 1
    _close(got, fcm_sweep_batched_ref(x, w, v, m), 3e-4, 3e-5)
    acc = fcm_accumulate_batched_cuda(x, w, v, m)
    _close(acc, fcm_accumulate_batched_ref(x, w, v, m), 3e-4, 3e-3)
    for a, b in zip(acc, fcm_accumulate_batched_cuda(x, w, v, m)):
        assert torch.equal(a, b)                     # bit-identical rerun
    for out in got + acc:                            # phantom tenants
        assert not bool(out[t:].abs().any())


def test_batched_kernel_one_tenant_matches_single_model_kernel(card):
    x, w, v = _inputs(20_000, 41, 23, 3, card)
    for kb, k1, atol in ((fcm_sweep_batched_cuda, fcm_sweep_cuda, 3e-5),
                         (fcm_accumulate_batched_cuda, fcm_accumulate_cuda,
                          3e-3)):
        got = kb(x[None], w[None], v[None], 1.2)
        _close([g[0] for g in got], k1(x, w, v, 1.2), 3e-4, atol)


def test_batched_kernel_rejects_bad_inputs(card):
    x, w, v, m = _stack(3, 20, 4, 3, 0, card)
    with pytest.raises(ValueError, match="do not form"):
        fcm_sweep_batched_cuda(x, w[:, :5], v, m)
    with pytest.raises(ValueError, match="one fuzzifier per tenant"):
        fcm_sweep_batched_cuda(x, w, v, m[:2])
    # V_t (64 x 4000) fits no shared memory: the C-tiled kernel takes it.
    big = _stack(1, 10, 4000, 64, 0, card)
    before = fcm_sweep_batched_cuda.shapes.copy()
    _close(fcm_sweep_batched_cuda(*big), fcm_sweep_batched_ref(*big), 3e-4,
           3e-5)
    assert _launched_path(fcm_sweep_batched_cuda, before) == "ctiled"
    _close(fcm_accumulate_batched_cuda(*big),
           fcm_accumulate_batched_ref(*big), 3e-4, 3e-3)


def test_fit_tenants_through_kernel(card):
    """``hopper`` fits a cohort through the tenant-stacked kernel and lands
    where the plain torch backend does from the same seeds.  Iteration
    counts and centers are held on the tenants whose torch fit does not
    move when their records are scaled by 1 ± 2⁻²²: elsewhere the slow
    crossing of ε is set by rounding (PERF.md, section 6)."""
    rng = np.random.default_rng(1)
    data = [(rng.normal(size=(int(rng.integers(8, 60)), 4)) + 4.0 * (i % 5))
            .astype(np.float32) for i in range(200)]
    cfg = TenantFitConfig(n_clusters=3, row_base=16, backend="hopper")
    torch_cfg = TenantFitConfig(n_clusters=3, row_base=16, backend="torch")
    before = fcm_sweep_batched_cuda.launches
    hop = fit_tenants(data, cfg, device=card)
    assert fcm_sweep_batched_cuda.launches > before
    tor = fit_tenants(data, torch_cfg, device=card)
    fixed = np.ones(200, bool)
    for sign in (1, -1):
        nudged = fit_tenants([x * np.float32(1 + sign * 2.0 ** -22)
                              for x in data], torch_cfg, device=card)
        fixed &= nudged.n_iter == tor.n_iter
    gap = np.abs(hop.n_iter.astype(int) - tor.n_iter)
    assert fixed.sum() >= 150 and np.all(gap[fixed] <= 1)
    same = fixed & (gap == 0)
    np.testing.assert_allclose(hop.centers[same], tor.centers[same],
                               rtol=1e-4, atol=1e-4)


def _launched_path(kern, before):
    """The one path ``kern`` launched since its ``shapes`` were ``before``."""
    new = kern.shapes - before
    assert len(new) == 1, new
    return next(iter(new))[0]


# Both sides of each dispatch boundary of the single-model sweep: rows
# (d <= 32 at C = 2, d <= 4 at C <= 4) | tile (C <= 128) | wide (V and one
# record in shared memory: d <= 887 at C = 64) | C-tiled.
@pytest.mark.parametrize("n,d,c,path", [
    (3000, 32, 2, "rows"), (3000, 33, 2, "tile"),
    (3000, 4, 4, "rows"), (3000, 4, 9, "tile"),
    (3000, 41, 128, "tile"), (3000, 41, 129, WIDE_PAST_128),
    (3000, 256, 64, "wide"), (3000, 257, 64, "ctiled"),
    (3000, 887, 16, "wide"), (3000, 888, 64, "ctiled"),
    (3184, 2048, 64, "ctiled"), (2048, 2048, 64, "ctiled"),
    (2048, 41, 23, "tile"), (3184, 41, 23, "tile"),
    (2048, 28, 2, "rows"), (3184, 28, 2, "rows"),
    (200_000, 28, 2, "rows"), (200_000, 41, 23, "tile")])
@pytest.mark.parametrize("m", [1.2, 2.0])
def test_each_path_matches_plain_and_reruns_bit_identically(card, n, d, c,
                                                            path, m):
    x, w, v = _inputs(n, d, c, n + d + c, card)
    assert _plan(card.index or 0, n, d, c).path == path
    for kern, plain, atol in ((fcm_sweep_cuda, fcm_sweep_ref, 3e-5),
                              (fcm_accumulate_cuda, fcm_accumulate_ref,
                               3e-3)):
        before = kern.shapes.copy()
        got = kern(x, w, v, m)
        assert _launched_path(kern, before) == path
        _close(got, plain(x, w, v, m), 3e-4, atol)
        for a, b in zip(got, kern(x, w, v, m)):
            assert torch.equal(a, b)


# The wide kernel at the curriculum's shapes (d = 1536, C = 16: the full
# sweep, the driver's sample, WFCMPB's block, the 32- and 16-point merges),
# the other LM widths at C = 16, at d % 4 != 0 (887: 4-byte copies) and
# C = 128, and past 8 CTAs a cluster (C = 2, d = 16,385).
WIDE_SHAPES = [(65_536, 1536, 16), (32_604, 1536, 16), (2048, 1536, 16),
               (32, 1536, 16), (16, 1536, 16), (8192, 1024, 16),
               (8192, 3072, 16), (3000, 887, 16), (4096, 100, 128),
               (1000, 16_385, 2)]
@pytest.mark.parametrize("m", [1.2, 2.0])
@pytest.mark.parametrize("n,d,c", WIDE_SHAPES)
def test_wide_matches_plain_and_reruns_bit_identically(card, n, d, c, m):
    """K1 and K2 on the wide path against their plain versions at the
    test_kernels.py tolerances, with half the rows zero-weight phantoms
    and with C records on the centers (q to the expansion's rounding
    bound); reruns bit-identical; all-phantom records give exact zeros."""
    x, w, v = _inputs(n, d, c, n + d + c, card)
    assert _plan(card.index or 0, n, d, c).path == "wide"
    half = w.clone()
    half[n // 2:] = 0.0
    on = x[:c].clone()
    q_on = 2 * (d + 2) * 2.0 ** -24 * float(
        (w * ((x * x).sum(1) + (on * on).sum(1).max())).sum())
    for kern, plain, atol in ((fcm_sweep_cuda, fcm_sweep_ref, 3e-5),
                              (fcm_accumulate_cuda, fcm_accumulate_ref,
                               3e-3)):
        for ws, vs, q_atol in ((w, v, 0.0), (half, v, 0.0), (w, on, q_on)):
            before = kern.shapes.copy()
            got = kern(x, ws, vs, m)
            assert _launched_path(kern, before) == "wide"
            want = plain(x, ws, vs, m)
            _close(got[:2], want[:2], 3e-4, atol)
            torch.testing.assert_close(got[2], want[2], rtol=3e-4,
                                       atol=atol + q_atol)
            for a, b in zip(got, kern(x, ws, vs, m)):
                assert torch.equal(a, b)
        for out in kern(x, torch.zeros_like(w), v, m):
            assert not bool(out.abs().any())


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n,d,c", [(3000, 887, 64), (65_536, 384, 32),
                                   (2048, 443, 128)])
def test_forced_wide_matches_plain_where_the_plan_takes_ctiled(card, n, d,
                                                               c, normalize):
    """Where the plan sends a shape of the wide domain to the C-tiled
    kernel (measured faster there), the wide kernel forced onto it
    (`fcm_sweep_wide`, as scripts/compare_kernels.py times it) still
    matches the plain version, d % 4 != 0 included, and reruns bit for
    bit."""
    x, w, v = _inputs(n, d, c, n + d + c, card)
    assert _plan(card.index or 0, n, d, c).path == "ctiled"
    plain = fcm_sweep_ref if normalize else fcm_accumulate_ref
    got = fcm_update.fcm_sweep_wide(x, w, v, 1.2, normalize)
    _close(got, plain(x, w, v, 1.2), 3e-4, 3e-5 if normalize else 3e-3)
    for a, b in zip(got, fcm_update.fcm_sweep_wide(x, w, v, 1.2, normalize)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, 63])
@pytest.mark.parametrize("scalar_m", [False, True])
def test_ctiled_row_chunks_and_tenant_groups_add_up(card, monkeypatch,
                                                     scalar_m, n):
    """A scratch budget of 1.2 MB makes the C-tiled wrapper walk two
    tenant groups and four row chunks at (T, N, d, C) = (3 + 2 phantoms,
    1000, 2048, 64), and three tenant groups with d split in two at
    N = 63: raw sums add across chunks, the sweep normalizes once at the
    last, phantoms stay 0, reruns are bit-identical, and one tenant
    agrees with the single-model wrapper on the same budget."""
    monkeypatch.setattr(fcm_update, "CTILED_SCRATCH_BYTES", 1_200_000)
    fcm_update._plan.cache_clear()
    fcm_update._batched_plan.cache_clear()
    try:
        x, w, v, m = _stack(3, n, 2048, 64, 11, card)
        m = 1.2 if scalar_m else m
        plan = _batched_plan(card.index or 0, 5, n, 2048, 64)
        assert plan.path == "ctiled" and plan.scratch <= 1_200_000
        assert len(fcm_update.ctiled_chunks(plan, 5, n)) > 2
        assert (plan.dsplits > 1) == (n == 63)
        for kern, plain, atol in ((fcm_sweep_batched_cuda,
                                   fcm_sweep_batched_ref, 3e-5),
                                  (fcm_accumulate_batched_cuda,
                                   fcm_accumulate_batched_ref, 3e-3)):
            got = kern(x, w, v, m)
            _close(got, plain(x, w, v, m), 3e-4, atol)
            for a, b in zip(got, kern(x, w, v, m)):
                assert torch.equal(a, b)
            for out in got:
                assert not bool(out[3:].abs().any())
        mt = 1.2 if scalar_m else float(m[0])
        _close(fcm_sweep_cuda(x[0], w[0], v[0], mt),
               fcm_sweep_ref(x[0], w[0], v[0], mt), 3e-4, 3e-5)
    finally:
        fcm_update._plan.cache_clear()
        fcm_update._batched_plan.cache_clear()


# The C-tiled kernel at router_fit's small shapes, where the plan splits
# d across CTAs (N = 1, 63, 128, 2048 at d = 2048, C = 64), and at an odd
# width (d = 2047, C = 65: 4-byte copies, a ragged center tile).
@pytest.mark.parametrize("phantoms", [False, True])
@pytest.mark.parametrize("n,d,c", [(1, 2048, 64), (63, 2048, 64),
                                   (128, 2048, 64), (2048, 2048, 64),
                                   (2048, 2047, 65)])
def test_ctiled_dsplit_matches_plain(card, n, d, c, phantoms):
    """K1, K2 and K3 on the C-tiled path against their plain versions at
    the test_kernels.py tolerances (with half the rows zero-weight
    phantoms, or none), reruns bit-identical, K3's all-zero phantom
    tenant exactly 0."""
    x, w, v = _inputs(n, d, c, n + d + c, card)
    if phantoms:
        w[n // 2:] = 0.0
    plan = _plan(card.index or 0, n, d, c)
    assert plan.path == "ctiled"
    assert plan.dsplits > 1 or n == 2048 and d == 2047
    for kern, plain, atol in ((fcm_sweep_cuda, fcm_sweep_ref, 3e-5),
                              (fcm_accumulate_cuda, fcm_accumulate_ref,
                               3e-3)):
        before = kern.shapes.copy()
        got = kern(x, w, v, 1.2)
        assert _launched_path(kern, before) == "ctiled"
        _close(got, plain(x, w, v, 1.2), 3e-4, atol)
        for a, b in zip(got, kern(x, w, v, 1.2)):
            assert torch.equal(a, b)
    xs, ws, vs, m = _stack(2, n, d, c, n + d + c + 1, card, phantoms=1)
    if phantoms:
        ws[:, n // 2:] = 0.0
    for kern, plain, atol in ((fcm_sweep_batched_cuda, fcm_sweep_batched_ref,
                               3e-5),
                              (fcm_accumulate_batched_cuda,
                               fcm_accumulate_batched_ref, 3e-3)):
        before = kern.shapes.copy()
        got = kern(xs, ws, vs, m)
        assert _launched_path(kern, before) == "ctiled"
        _close(got, plain(xs, ws, vs, m), 3e-4, atol)
        for a, b in zip(got, kern(xs, ws, vs, m)):
            assert torch.equal(a, b)
        for out in got:
            assert not bool(out[2:].abs().any())


@pytest.mark.parametrize("t,n,d,c,path", [
    (700, 32, 4, 3, "rows"), (700, 512, 4, 3, "rows"),
    (700, 4096, 4, 3, "rows"), (5, 512, 4, 3, "rows"),
    (5, 300, 4, 8, "rows"), (5, 300, 4, 9, "tile"),
    (66, 300, 41, 23, "tile"), (300, 300, 41, 23, "tile"),
    (5, 300, 445, 64, "ctiled"), (5, 300, 446, 64, "ctiled"),
    (1024, 32, 8, 129, "ctiled"),
    (3, 1000, 2048, 64, "ctiled")])
@pytest.mark.parametrize("scalar_m", [False, True])
def test_batched_paths_match_plain_with_phantoms(card, t, n, d, c, path,
                                                 scalar_m):
    """K3 at N_b in {32, 512, 4096}: one-warp teams (many tenants of at
    most 1024 records), whole-CTA teams, row splits (few tenants), and
    both sides of the rows path's C limit; the tile kernel's tenant axis
    with row splits (66 tenants) and one CTA per tenant, trailing
    zero-weight rows skipped (300); past its micro-tiles the C-tiled
    kernel, also for many tenants of few records at small d; per-tenant
    or scalar m; two all-zero phantom tenants stay exactly 0; reruns are
    bit-identical."""
    x, w, v, m = _stack(t, n, d, c, t + n + d + c, card)
    m = 1.2 if scalar_m else m
    plan = _batched_plan(card.index or 0, t + 2, n, d, c)
    assert plan.path == path
    for kern, plain, atol in ((fcm_sweep_batched_cuda, fcm_sweep_batched_ref,
                               3e-5),
                              (fcm_accumulate_batched_cuda,
                               fcm_accumulate_batched_ref, 3e-3)):
        before = kern.shapes.copy()
        got = kern(x, w, v, m)
        assert _launched_path(kern, before) == path
        _close(got, plain(x, w, v, m), 3e-4, atol)
        for a, b in zip(got, kern(x, w, v, m)):
            assert torch.equal(a, b)
        for out in got:
            assert not bool(out[t:].abs().any())


@pytest.mark.parametrize("d,c,m", [(28, 2, 2.0), (41, 23, 1.2)])
def test_kernel_at_a_padded_batch(card, d, c, m):
    """K1 at an out-of-core tail batch: 40,000 records and 25,536
    zero-weight phantom rows of zeros, against the plain version and
    against K1 on the 40,000 records alone (phantoms add nothing)."""
    x, w, v = _inputs(65_536, d, c, d + c, card)
    x[40_000:] = 0.0
    w[40_000:] = 0.0
    got = fcm_accumulate_cuda(x, w, v, m)
    _close(got, fcm_accumulate_ref(x, w, v, m), 3e-4, 3e-3)
    _close(got, fcm_accumulate_cuda(x[:40_000], w[:40_000], v, m), 1e-5,
           1e-3)


def test_staging_ring_pass_equals_one_launch(card, tmp_path):
    """`ooc_accumulate` over an on-disk store (memmap batches through the
    pinned two-slot ring, the tail batch padded) equals one K1 launch
    over the whole array within f32 summation order, is bit-identical on
    a rerun and through a shared ring, and counts its staging."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(200_000, 41)).astype(np.float32)
    store = ChunkStore.ingest(x, chunk_rows=65_536, cache_dir=str(tmp_path))
    v = torch.from_numpy(x[:23]).to(card)
    ring = StagingRing(card, timing=True)

    def one_pass(r=None):
        return ooc_accumulate(batched(store.iter_chunks(), 65_536), v, 1.2,
                              backend="hopper_accumulate", ring=r,
                              device=card)

    before = fcm_accumulate_cuda.launches
    got = one_pass(ring)
    assert fcm_accumulate_cuda.launches == before + 4
    xd = torch.from_numpy(x).to(card)
    want = fcm_accumulate_cuda(xd, torch.ones(200_000, device=card), v, 1.2)
    _close(got, want, 1e-5, 1e-2)
    for again in (one_pass(), one_pass(ring)):
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert ring.batches == 8 and ring.h2d_bytes == 8 * 65_536 * 42 * 4
    assert ring.h2d_seconds() > 0


@pytest.mark.parametrize("topology", ["windowed", "pairwise"])
@pytest.mark.parametrize("d,c,m", [(28, 8, 2.0), (41, 23, 1.2)])
def test_merge_topologies_through_kernel(card, topology, d, c, m):
    """The window merges through ``hopper`` (K1 at C points per slot, or
    K2 at 2·C per pair) land where the ``torch`` backend does, phantom
    slot included; windowed launches K1 once per slot per sweep."""
    rng = np.random.default_rng(d + c)
    truth = rng.normal(0, 5, size=(c, d))
    cent = (truth[None] + rng.normal(0, 0.3, size=(8, c, d))).astype(
        np.float32)
    mass = rng.uniform(1, 20, size=(8, c)).astype(np.float32)
    mass[3] = 0.0
    s = summary(cent, mass, device=card)
    plan = MergePlan(topology, m=m, eps=1e-9, max_iter=200)
    before = fcm_accumulate_cuda.launches
    got = merge_summaries(s, plan, backend="hopper")
    if topology == "windowed":
        assert fcm_accumulate_cuda.launches - before == 8 * (got.n_iter + 1)
    want = merge_summaries(s, plan, backend="torch")
    scale = float(np.abs(cent).max())
    torch.testing.assert_close(got.summary.centers, want.summary.centers,
                               rtol=0, atol=1e-4 * scale)
    assert abs(got.n_iter - want.n_iter) <= 2


def test_stream_through_kernels_matches_torch_twin(card, monkeypatch):
    """A short drifting stream through ``hopper`` (K2 in the combiner, K1
    in the window merge) fed by `stream_loader` (pinned staging, a
    phantom-padded tail batch): step-locked against a ``torch`` twin on
    the card started from each pre-ingest state — the same decisions,
    centers within 1e-4 of the data's RMS, combiner sweeps ±2 — with the
    driver race pinned to its FCM branch; then `assign_stream` scores the
    stream's real rows alone."""
    from repro_torch.core import fcm
    from repro_torch.stream import streaming

    def fcm_branch(x_sample, cfg, *, seed_idx, device):
        seeds = x_sample[torch.as_tensor(seed_idx, device=x_sample.device)]
        return fcm(x_sample, seeds, m=cfg.m, eps=cfg.driver_eps,
                   max_iter=cfg.max_iter, backend=cfg.backend,
                   device=device).centers, True, 0.0, 0.0

    monkeypatch.setattr(streaming, "run_driver", fcm_branch)
    chunks = [x for x, _ in make_moving_blobs(6, 3000, 8, 4, drift_at=3,
                                              shift=10.0, seed=5)]
    x = np.concatenate(chunks)[:17_000]
    scale = float(np.sqrt(np.mean(x * x)))
    cfg = StreamConfig(n_clusters=4, window=3, decay=0.8, driver_sample=256,
                       backend="hopper")
    model = StreamingBigFCM(cfg, device=card)
    assert model.backend.name == "hopper"
    k1, k2 = fcm_accumulate_cuda.launches, fcm_sweep_cuda.launches
    reseeds = 0
    for bx, bw in stream_loader(replay_source(x, 3000), 3000, device=card):
        pre = None if model.state is None else model.state_dict()
        rep = model.ingest(bx, bw)
        twin = StreamingBigFCM(dataclasses.replace(cfg, backend="torch"),
                               device=card)
        if pre is not None:
            twin.load_state_arrays(pre)
        trep = twin.ingest(bx, bw)
        for f in ("drifted", "reason", "born", "died", "n_centers"):
            assert getattr(rep, f) == getattr(trep, f), (f, rep, trep)
        torch.testing.assert_close(model.state.centers, twin.state.centers,
                                   rtol=0, atol=1e-4 * scale)
        assert abs(int(rep.combiner_iters[0])
                   - int(trep.combiner_iters[0])) <= 2
        reseeds += rep.reseeded
    assert reseeds == 1 and float(bw.sum()) == 2000
    assert fcm_accumulate_cuda.launches > k1
    assert fcm_sweep_cuda.launches > k2
    outs = list(assign_stream(model, stream_loader(
        replay_source(x, 3000), 3000, device=card), update=False))
    assert [o.shape[0] for o, _ in outs] == [3000] * 5 + [2000]


# ---------------------------------------- torch_bf16, tuned plans, serve --

@pytest.mark.parametrize("n,d,c", [(4096, 28, 2), (4096, 41, 23),
                                   (2048, 2048, 64)])
def test_torch_bf16_on_the_card(card, n, d, c):
    """bf16 tensor-core contractions with f32 outputs: every accumulator
    f32 and within 2e-2 of the f32 sweep (the race's parity gate), the
    tenant-stacked entry equal to the single-model one per tenant."""
    from repro_torch.engine import get_backend
    x, w, v = _inputs(n, d, c, 7, card)
    bf16, f32 = get_backend("torch_bf16"), get_backend("torch")
    got, want = bf16.sweep(x, w, v, 2.0), f32.sweep(x, w, v, 2.0)
    for g, e in zip(got, want):
        assert g.dtype == torch.float32
        scale = float(e.abs().max()) or 1.0
        assert float((g - e).abs().max()) <= 2e-2 * scale
    xb, wb, vb = (torch.stack([a, a.flip(0)]) for a in (x, w, v))
    batched = bf16.batched_accumulate(xb, wb, vb, 2.0)
    for t in range(2):
        one = bf16.accumulate(xb[t], wb[t], vb[t], 2.0)
        for g, e in zip(batched, one):
            torch.testing.assert_close(g[t], e, rtol=1e-5, atol=1e-4)


def test_calibrated_auto_on_the_card(card, monkeypatch, tmp_path):
    """"auto" on the card races every backend at the caller's bucket,
    records each one's time and parity, crowns a kernel backend, and
    answers from the memo after."""
    from repro_torch.engine import available_backends, resolve_backend
    from repro_torch.perf import calibrate
    monkeypatch.setenv(calibrate.ENV_DIR, str(tmp_path))
    calibrate.clear_memory_cache()
    try:
        be = resolve_backend("auto", device=card, shape=(4096, 23, 41))
        entry = calibrate.load_calibration(device=card)["winners"][
            "n4096_c32_d64"]
        assert entry["winner"] == be.name and be.kernel
        assert set(entry["times_us"]) == set(available_backends())
        assert all(entry["parity"][k] for k in
                   ("torch", "hopper", "hopper_accumulate"))
        assert resolve_backend(None, device=card,
                               shape=(3000, 20, 40)) is be
    finally:
        calibrate.clear_memory_cache()


@pytest.mark.parametrize("shape,tenants", [((4096, 2, 28), None),
                                           ((4096, 23, 41), None),
                                           ((4096, 64, 2048), None),
                                           ((512, 3, 4), 64),
                                           ((512, 23, 41), 300)])
def test_tuned_plans_match_plain(card, monkeypatch, tmp_path, shape,
                                 tenants):
    """Every plan the autotuner tries at a bucket launches and agrees with
    the plain version at tests/test_kernels.py's tolerances (a tuned plan
    changes the order of the sums, not the math); after tuning, a launch
    in the bucket takes the tuned plan."""
    from repro_torch.perf import autotune, calibrate
    monkeypatch.setenv(calibrate.ENV_DIR, str(tmp_path))
    calibrate.clear_memory_cache()
    try:
        cfg = autotune.tune_sweep_blocks(shape, tenants=tenants, device=card,
                                         iters=1)
        n, c, d = shape
        if tenants is None:
            x, w, v = _inputs(n, d, c, 3, card)
            sweep, ref = fcm_sweep_cuda, fcm_sweep_ref
            plan = fcm_update.launch_plan(card, n, d, c)
        else:
            x, w, v, _ = _stack(tenants, n, d, c, 3, card)
            sweep, ref = fcm_sweep_batched_cuda, fcm_sweep_batched_ref
            plan = fcm_update.launch_plan(card, n, d, c, x.shape[0])
        assert plan.path == cfg["plan"]["path"]
        want = ref(x, w, v, 2.0)
        launch = (fcm_update._launch if tenants is None
                  else fcm_update._launch_batched)
        for choice in autotune.choice_grid(plan.path):
            _close(launch(x, w, v, 2.0, True, choice)[0], want, 3e-4, 3e-5)
        _close(sweep(x, w, v, 2.0), want, 3e-4, 3e-5)
    finally:
        calibrate.clear_memory_cache()


def test_swap_during_dispatch_on_the_card(card):
    """Replicas on the card scoring while another thread swaps the
    snapshot: every response is one version's labels (against
    `make_assigner` at that version on the card, up to rows whose two
    centers' d² differ by less than the f32 rounding of the expansion
    x² + v² − 2x·vᵀ, 1e-5 of x² + v²), and the next dispatch after the
    last swap sees it."""
    import threading
    import time as _time
    from repro_torch.serve import (CenterSnapshot, Scorer, ScoringService,
                                   ServiceConfig, make_assigner)
    rng = np.random.default_rng(0)
    base = (rng.normal(size=(6, 8)) * 4).astype(np.float32)
    versions = {v: np.roll(base, v, axis=0) for v in range(4)}
    reqs = [rng.normal(size=(int(k), 8)).astype(np.float32) * 4
            for k in rng.integers(4, 600, size=150)]
    svc = ScoringService(
        [Scorer(CenterSnapshot(0, base), backend="hopper", replica=f"r{i}",
                device=card) for i in range(2)],
        ServiceConfig(max_batch_rows=1024, bucket_base=64))
    stop = threading.Event()

    def swapper():
        v = 0
        while not stop.is_set():
            v = (v + 1) % 4
            svc.swap(v, versions[v])
            _time.sleep(0.0005)

    th = threading.Thread(target=swapper)
    th.start()
    try:
        results = [f.result(60) for f in [svc.submit(r) for r in reqs]]
    finally:
        stop.set()
        th.join()
    seen = set()
    for r, res in zip(reqs, results):
        seen.add(res.version)
        want = make_assigner(versions[res.version], backend="hopper",
                             device=card)(r).cpu().numpy()
        bad = np.flatnonzero(res.assignments != want)
        if bad.size:
            xs = r[bad].astype(np.float64)
            v = versions[res.version].astype(np.float64)
            d2 = ((xs[:, None, :] - v[None]) ** 2).sum(-1)
            rows = np.arange(bad.size)
            gap = np.abs(d2[rows, res.assignments[bad]] - d2[rows, want[bad]])
            scale = (xs * xs).sum(1) + (v * v).sum(1).max()
            assert np.all(gap <= 1e-5 * scale)
    assert len(seen) > 1
    svc.swap(99, versions[1])
    assert svc.score(reqs[0], timeout=60).version == 99
    assert svc.compile_counts()["r0"] <= len(svc.buckets) * 1
    svc.close()


# ------------------------------------------------------------- the fleet --

def test_fleet_on_the_card(card, tmp_path):
    """A 2-host threaded fleet through ``hopper`` on the card: every host's
    batches launch K1 (its count exact across the two threads: one per
    ``engine.sweep`` span), the gathered stack merges on the card (K2 at
    the 2·C-point merge shape), and the fit agrees with the ``torch``
    backend's from the same seeds."""
    from repro_torch import obs
    from repro_torch.fleet import FleetConfig, MailboxTransport, fleet_fit
    x, _ = make_blobs(40_000, 6, 5, seed=3)
    store = ChunkStore.ingest(x, chunk_rows=4096, cache_dir=str(tmp_path))
    cfg = BigFCMConfig(n_clusters=5, use_driver=False, sample_size=512,
                       seed=0, backend="hopper")
    seeds = x[np.random.default_rng(0).choice(len(x), 5, replace=False)]
    fleet = FleetConfig(n_hosts=2, shards_per_host=2)
    obs.set_enabled(True)
    obs.reset_all()
    fcm_update.reset_counts()
    try:
        res = fleet_fit(store, cfg, fleet, transport=MailboxTransport(),
                        v_init=seeds, device=card)
        sweeps = obs.metrics_snapshot()["histograms"]["span.engine.sweep"][
            "count"]
    finally:
        obs.reset_all()
        obs.set_enabled(None)
    assert res.live == (0, 1) and res.n_rows == 40_000
    assert set(fcm_accumulate_cuda.shapes) == {("rows", 4096, 5)}
    assert fcm_accumulate_cuda.launches == sweeps > 0
    assert set(fcm_sweep_cuda.shapes) == {("rows", 10, 5)}
    assert fcm_sweep_cuda.launches > 0 and fcm_sweep_cuda.launches % 2 == 0
    twin = fleet_fit(store, dataclasses.replace(cfg, backend="torch"), fleet,
                     v_init=seeds, device=card)
    scale = float(np.sqrt(np.mean(x * x)))
    np.testing.assert_allclose(res.centers, twin.centers, rtol=0,
                               atol=1e-4 * scale)
    assert abs(res.objective - twin.objective) / twin.objective < 1e-5


def test_bmm_f32_backward_on_the_card(card):
    """`attention._bmm_f32` on bf16 operands on the card (its `_BmmF32`
    autograd function: torch gives ``bmm``'s ``out_dtype`` form no
    backward) against the f32 product of the same operands: the result
    within 1e-5 of its largest value, each gradient in the operand's dtype
    within 2⁻⁷ of its largest (the f32 cotangent rounded to bf16, then a
    bf16 product accumulated in f32)."""
    from repro_torch.models.attention import _bmm_f32
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn(6, 48, 32, generator=gen, device=card).to(torch.bfloat16)
    b = torch.randn(6, 32, 40, generator=gen, device=card).to(torch.bfloat16)
    g = torch.randn(6, 48, 40, generator=gen, device=card)
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = _bmm_f32(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    a32 = a.detach().float().requires_grad_(True)
    b32 = b.detach().float().requires_grad_(True)
    want = torch.bmm(a32, b32)
    want.backward(g)
    scale = float(want.detach().abs().max())
    assert float((out.detach() - want.detach()).abs().max()) <= 1e-5 * scale
    for got, ref in ((a.grad, a32.grad), (b.grad, b32.grad)):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - ref).abs().max())
        assert err <= 2 ** -7 * float(ref.abs().max()), err


def test_train_step_on_the_card(card):
    """One training step of reduced qwen2 and olmoe in bf16 on the card
    (remat, the chunked loss, the MoE dispatch under autograd) against
    the same step on the CPU: losses within 2⁻⁶, finite parameters."""
    import dataclasses as dc
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import build
    for arch in ("qwen2-1.5b", "olmoe-1b-7b"):
        cfg = dc.replace(reduced(get_config(arch)), param_dtype="bfloat16",
                         compute_dtype="bfloat16")
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(
            np.int32), "labels": rng.integers(0, cfg.vocab, (4, 32))
            .astype(np.int32)}
        losses = []
        for dev in (card, torch.device("cpu")):
            state, step = build(cfg, seed=0, device=card, warmup=2,
                                total_steps=4)
            if dev.type == "cpu":
                state.params.to(dev)
                state, step = build(cfg, device=dev, warmup=2,
                                    total_steps=4, params=state.params)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            assert all(bool(torch.isfinite(p).all())
                       for p in state.params.parameters())
        assert abs(losses[0] - losses[1]) <= 2 ** -6 * abs(losses[1]), losses
