"""`repro_torch.kernels` against `repro.kernels`: the plain versions of the
Hopper FCM kernel, and the wrappers on CPU tensors.  The kernel itself is
tested on a card by tests/test_torch_cuda.py.  Also the kernels' launch
plan (a pure function of the shape and the card's SM count, resident
CTAs per SM and shared memory) and the build's source hash.

Inputs come from numpy seeds and go to both packages.  Tolerances are
those of tests/test_kernels.py."""
import collections
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fcm_update import fcm_sweep_pallas
from repro.kernels.ops import accumulate_chunks as ref_accumulate_chunks
from repro.kernels.ref import fcm_accumulate_ref as jnp_accumulate_ref
from repro.kernels.ref import fcm_sweep_ref as jnp_sweep_ref
from repro_torch.kernels import build, fcm_update, ops
from repro_torch.kernels.fcm_update import (first_layout_floats,
                                            fcm_accumulate_cuda,
                                            fcm_accumulate_ref,
                                            fcm_sweep_cuda, fcm_sweep_ref,
                                            plan_batched, plan_sweep)

SHAPES = [
    (64, 2, 2), (100, 130, 7), (257, 4, 3), (1000, 18, 10),
    (2048, 28, 50), (31, 41, 23), (512, 8, 129),
]
OFF_LANE_SHAPES = [
    (300, 130, 131), (200, 129, 140), (96, 257, 129), (513, 131, 200),
]
M_SWEEP = [1.05, 1.2, 2.0, 3.0]


def _inputs(n, d, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, rtol, atol):
    for g, e in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.cpu()), np.asarray(e),
                                   rtol=rtol, atol=atol)


# -------------------------------------------------- plain vs reference ---

@pytest.mark.parametrize("n,d,c", [(64, 2, 2), (100, 130, 7), (31, 41, 23),
                                   (300, 130, 131)])
def test_plain_sweep_matches_pallas_interpret(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    want = fcm_sweep_pallas(*_j(x, w, v), 2.0, interpret=True)
    _close(fcm_sweep_ref(*_t(x, w, v), 2.0), want, 3e-4, 3e-5)


@pytest.mark.parametrize("n,d,c", SHAPES)
def test_plain_sweep_matches_ref_shapes(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    _close(fcm_sweep_ref(*_t(x, w, v), 2.0), jnp_sweep_ref(*_j(x, w, v), 2.0),
           3e-4, 3e-5)


@pytest.mark.parametrize("n,d,c", OFF_LANE_SHAPES)
def test_plain_sweep_matches_ref_off_lane(n, d, c):
    x, w, v = _inputs(n, d, c, n * 7 + d + c)
    _close(fcm_sweep_ref(*_t(x, w, v), 2.0), jnp_sweep_ref(*_j(x, w, v), 2.0),
           3e-4, 3e-4)


@pytest.mark.parametrize("n,d,c", SHAPES + OFF_LANE_SHAPES)
def test_plain_accumulate_matches_ref(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    _close(fcm_accumulate_ref(*_t(x, w, v), 2.0),
           jnp_accumulate_ref(*_j(x, w, v), 2.0), 3e-4, 3e-3)


@pytest.mark.parametrize("n,d,c", [(64, 900, 64), (64, 2048, 64),
                                   (16, 7168, 384)])
def test_plain_matches_ref_at_router_widths(n, d, c):
    """The widths the C-tiled kernel serves, at test_kernels.py's
    tolerances (the sweep's and the raw accumulators')."""
    x, w, v = _inputs(n, d, c, n + d + c)
    _close(fcm_sweep_ref(*_t(x, w, v), 2.0), jnp_sweep_ref(*_j(x, w, v), 2.0),
           3e-4, 3e-5)
    _close(fcm_accumulate_ref(*_t(x, w, v), 1.2),
           jnp_accumulate_ref(*_j(x, w, v), 1.2), 3e-4, 3e-3)


@pytest.mark.parametrize("m", M_SWEEP)
def test_plain_sweep_matches_ref_m(m):
    x, w, v = _inputs(500, 12, 6, 7)
    _close(fcm_sweep_ref(*_t(x, w, v), m), jnp_sweep_ref(*_j(x, w, v), m),
           5e-4, 5e-5)


def test_accumulate_chunks_equals_single_sweep():
    """Raw accumulators from chunk slices sum to the whole; the port's
    chunked sweep also matches the reference's."""
    x, w, v = _inputs(900, 11, 5, 17)
    cuts = [0, 250, 600, 900]
    xt, wt, vt = _t(x, w, v)
    got = ops.accumulate_chunks([xt[a:b] for a, b in zip(cuts, cuts[1:])],
                                [wt[a:b] for a, b in zip(cuts, cuts[1:])],
                                vt, 2.0)
    _close(got, [e.numpy() for e in ops.fcm_sweep_kernel(xt, wt, vt, 2.0)],
           1e-5, 1e-5)
    xj, wj, vj = _j(x, w, v)
    want = ref_accumulate_chunks([xj[a:b] for a, b in zip(cuts, cuts[1:])],
                                 [wj[a:b] for a, b in zip(cuts, cuts[1:])],
                                 vj, 2.0, accumulate_fn=lambda *a, **k:
                                 jnp_accumulate_ref(*a[:4]))
    _close(got, want, 1e-5, 1e-5)


def test_wrappers_on_cpu_take_plain_path_and_launch_nothing():
    x, w, v = _t(*_inputs(300, 13, 6, 3))
    fcm_accumulate_cuda.launches = fcm_sweep_cuda.launches = 0
    for got, want in ((fcm_sweep_cuda(x, w, v, 1.2), fcm_sweep_ref(x, w, v, 1.2)),
                      (fcm_accumulate_cuda(x, w, v, 1.2),
                       fcm_accumulate_ref(x, w, v, 1.2))):
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    assert fcm_accumulate_cuda.launches == 0
    assert fcm_sweep_cuda.launches == 0
    assert not fcm_accumulate_cuda.shapes and not fcm_sweep_cuda.shapes


def test_launches_by_path_sums_each_wrappers_shapes():
    """`launches_by_path`: each wrapper's counted launches by plan path,
    summed over shapes; empty after `reset_counts`."""
    fcm_update.reset_counts()
    try:
        for key in (("tile", 4096, 23), ("tile", 2048, 23),
                    ("rows", 2048, 2)):
            fcm_update._count(fcm_sweep_cuda, key)
        fcm_update._count(fcm_update.fcm_sweep_batched_cuda, ("rows", 8, 32))
        got = fcm_update.launches_by_path()
        assert got["fcm_sweep_cuda"] == {"tile": 2, "rows": 1}
        assert got["fcm_sweep_batched_cuda"] == {"rows": 1}
        assert got["fcm_accumulate_cuda"] == {}
    finally:
        fcm_update.reset_counts()
    assert all(v == {} for v in fcm_update.launches_by_path().values())


# ------------------------------------------------------------ launch plan --

# an H100 SXM's SM count and shared memory per block
H100 = dict(sms=132, ctas_per_sm=2, smem_limit=232448)
PLAN_SHAPES = [(11_000_000, 28, 2), (4_898_431, 41, 23), (3184, 41, 23),
               (2048, 41, 23), (3184, 28, 2), (2048, 28, 2), (46, 41, 23),
               (4, 28, 2), (1, 5, 3), (50_000, 41, 23)] + SHAPES + \
    OFF_LANE_SHAPES


def _cdiv(a, b):
    return -(-a // b)


def _covers(plan, n, tenants=1, d=None, c=None):
    assert plan.smem <= H100["smem_limit"]
    if plan.path == "wide":
        # clusters of dsplits CTAs of WIDE_BLOCK threads, each a whole
        # 8-dim step of d, none empty; at most one cluster per tile; the
        # micro-tiles fit a CTA
        assert plan.block == fcm_update.WIDE_BLOCK
        s, ds = plan.dsplits, plan.kper
        assert 1 <= s <= fcm_update.WIDE_MAX_CLUSTER and ds % 8 == 0
        assert d is not None and s * ds >= d > (s - 1) * ds
        assert plan.grid % s == 0
        assert 1 <= plan.grid // s <= _cdiv(n, plan.rows)
        assert plan.rows in (1, 2, 4, 8, 16, 32, 64)
        assert plan.ag * plan.dg <= plan.block
        assert plan.dg * 16 // plan.cm == ds
        assert plan.smem == 4 * fcm_update.wide_layout_floats(ds, c,
                                                              plan.rows, s)
        assert 1 <= plan.slices <= plan.grid
        return
    assert plan.block % 32 == 0 and 32 <= plan.block <= 256
    if plan.path == "ctiled":
        # row chunks and tenant groups within the launch limits
        assert 1 <= plan.group <= min(tenants, 65_535)
        assert 1 <= plan.rows and (plan.rows >= min(n, 64))
        assert 1 <= plan.splits <= 65_535
        assert plan.tile in fcm_update.CT_TILES and plan.dsplits >= 1
        assert plan.grid == (_cdiv(min(plan.rows, n), plan.tile)
                             * plan.dsplits * plan.group)
        return
    if plan.path == "rows":
        # every record in exactly one split, no split empty
        assert plan.splits * plan.rows >= n > (plan.splits - 1) * plan.rows
        teams = plan.block // (32 * plan.team_warps)
        assert plan.grid * teams >= tenants * plan.splits
        assert plan.splits == 1 or teams == 1
    else:
        # a persistent walk over tiles b, b + walkers, ...: all of them
        tiles = _cdiv(n, plan.rows)
        walkers = plan.splits if tenants > 1 or plan.splits > 1 else plan.grid
        assert plan.grid == tenants * plan.splits or tenants == 1
        assert 1 <= walkers <= max(tiles, 1)
    assert 0 <= plan.slices <= plan.grid


@pytest.mark.parametrize("n,d,c", PLAN_SHAPES)
def test_plan_sweep_covers_every_record(n, d, c):
    plan = plan_sweep(n, d, c, **H100)
    _covers(plan, n, d=d, c=c)
    if plan.path == "tile":
        assert plan.rc * plan.cg >= c and 32 % plan.cg == 0
        assert plan.ag * plan.dg * plan.rs <= 256


@pytest.mark.parametrize("t,n,d,c", [(65_536, 512, 4, 3), (1024, 32, 4, 3),
                                     (66, 300, 4, 3), (3, 300, 4, 3),
                                     (1, 20_000, 4, 3), (700, 4096, 4, 3),
                                     (66, 300, 41, 23), (3, 300, 41, 23)])
def test_plan_batched_covers_every_record(t, n, d, c):
    _covers(plan_batched(t, n, d, c, **H100), n, t)


@pytest.mark.parametrize("n", [2048, 3184])
@pytest.mark.parametrize("d,c", [(41, 23), (28, 2)])
def test_plan_fills_the_card_at_the_driver_shapes(n, d, c):
    assert plan_sweep(n, d, c, **H100).grid >= 132


def test_plan_takes_the_fast_paths():
    for n in (11_000_000, 3184, 2048, 4):
        assert plan_sweep(n, 28, 2, **H100).path == "rows"
    for n in (4_898_431, 3184, 2048, 46):
        assert plan_sweep(n, 41, 23, **H100).path == "tile"
    for t, n in ((65_536, 512), (1024, 32)):
        plan = plan_batched(t, n, 4, 3, **H100)
        assert (plan.path, plan.dm, plan.cm, plan.team_warps) == \
            ("rows", 4, 3, 1)
    assert plan_batched(66, 300, 41, 23, **H100).path == "tile"
    assert plan_sweep(512, 8, 129, **H100).path == WIDE_PAST_128
    # both sides of each boundary
    assert plan_sweep(1000, 32, 2, **H100).path == "rows"
    assert plan_sweep(1000, 33, 2, **H100).path == "tile"
    assert plan_sweep(1000, 41, 128, **H100).path == "tile"
    assert plan_sweep(1000, 41, 129, **H100).path == WIDE_PAST_128
    assert plan_batched(5, 300, 4, 8, **H100).path == "rows"
    assert plan_batched(5, 300, 4, 9, **H100).path == "tile"


def _tile_domain(d, c, n=1):
    """Whether the tile kernel's micro-tiles and a tile of n records fit
    (d, C) on an H100."""
    return fcm_update._tile_plan(n, d, c, H100["sms"], H100["ctas_per_sm"],
                                 H100["smem_limit"]) is not None


@pytest.mark.parametrize("plan,kernel", [(plan_sweep, "fcm_accumulate"),
                                         (plan_batched, "fcm_batched")])
def test_plan_raises_exactly_where_shared_memory_runs_out(plan, kernel):
    """Past the micro-tiles, single-model (d = 512 at C = 16), the wide
    kernel takes d while V and one record fit shared memory, and the
    C-tiled kernel exactly past that; tenant-stacked (C = 64), the tile
    kernel takes d up to its micro-tiles' limit (d = 128) and the C-tiled
    kernel exactly past it.  The plan raises nowhere."""
    if kernel == "fcm_batched":
        c = 64
        d_max = max(d for d in range(1, 4000) if _tile_domain(d, c))
        assert d_max == 128
        args = (3, 100, d_max, c)
    else:
        c = 16
        d_max = max(d for d in range(1, 4000)
                    if 4 * first_layout_floats(d, c, 1) <= H100["smem_limit"])
        args = (100, d_max, c)
    inside = plan(*args, **H100)
    assert inside.path == ("tile" if kernel == "fcm_batched" else "wide")
    wider = plan(*args[:-2], d_max + 1, c, **H100)
    assert wider.path == "ctiled"
    _covers(inside, 100, 3 if kernel == "fcm_batched" else 1, d=d_max, c=c)
    _covers(wider, 100, 3 if kernel == "fcm_batched" else 1)


# Past the tile kernel's micro-tiles the C-tiled kernel takes every
# tenant-stacked shape, including those where V_t and one record fit
# shared memory (the first tenant-stacked version's former domain).
@pytest.mark.parametrize("t,n,d,c", [
    (4096, 32, 8, 129), (256, 128, 8, 200), (1024, 512, 16, 160),
    (4096, 128, 32, 129), (4096, 16, 64, 160), (1024, 32, 129, 64),
    (66, 300, 8, 129), (256, 128, 32, 129), (1024, 512, 32, 200),
    (4096, 32, 64, 160), (4096, 128, 129, 64), (1024, 32, 192, 64),
    (4096, 16, 445, 64), (4096, 16, 446, 64)])
def test_plan_batched_past_the_micro_tiles(t, n, d, c):
    plan = plan_batched(t, n, d, c, **H100)
    assert plan.path == "ctiled"
    _covers(plan, n, t, d=d, c=c)


@pytest.mark.parametrize("t,n,d,c", [
    (66, 300, 41, 23), (5, 300, 4, 9), (4096, 512, 41, 23),
    (1024, 512, 41, 23), (3, 300, 128, 64), (264, 301, 41, 23),
    (2, 20_000, 41, 23), (7, 9, 41, 23), (200, 513, 8, 100)])
def test_tile_tenant_plan_covers_each_row_once_in_balanced_tiles(t, n, d,
                                                                 c):
    """Every "tile" tenant plan walks each (tenant, row) exactly once, in
    tiles of at most ``plan.rows`` records within one record of each
    other, every split of a tenant walking at least one tile; with one
    split per tenant the walk stops at each tenant's last live row."""
    plan = plan_batched(t, n, d, c, **H100)
    assert plan.path == "tile"
    _covers(plan, n, t, d=d, c=c)
    splits = plan.grid // t
    assert plan.splits == splits and plan.slices == int(splits > 1)
    assert splits == (1 if t >= 264 else min(_cdiv(264, t), _cdiv(n,
                                                                plan.rows)))
    rng = np.random.default_rng(t + n)
    lives = [None, rng.integers(0, n + 1, size=t)]
    for live in lives:
        walk = fcm_update.tile_walk(plan, t, n, live)
        seen = np.zeros((t, n), np.int64)
        sizes = collections.defaultdict(list)
        used = collections.defaultdict(set)
        for tenant, split, r0, r1 in walk:
            assert 0 <= split < splits and 1 <= r1 - r0 <= plan.rows
            seen[tenant, r0:r1] += 1
            sizes[tenant].append(r1 - r0)
            used[tenant].add(split)
        ends = np.full(t, n) if live is None or splits > 1 else live
        for tenant in range(t):
            assert np.all(seen[tenant, :ends[tenant]] == 1)
            assert np.all(seen[tenant, ends[tenant]:] == 0)
            if ends[tenant]:
                assert max(sizes[tenant]) - min(sizes[tenant]) <= 1
                assert len(used[tenant]) == min(
                    splits, len(sizes[tenant]))
        assert len(used) == int(np.count_nonzero(ends))


# The wide path: past the tile kernel's micro-tiles while V and one record
# fit shared memory, where the card measured it faster than the C-tiled
# kernel (the LM configs' d_model at C = 16: Whisper-medium 1024,
# Qwen2-1.5B 1536, OLMoE 2048, Gemma-7B 3072; 3399, the last d at C = 16).
# Elsewhere the plan keeps its tile or C-tiled path.  C > 128 in the
# former first version's domain goes to WIDE_PAST_128 (PERF.md §6).
WIDE_PAST_128 = "wide"
WIDE_DS = [100, 887, 1024, 1536, 2048, 3072, 3399]
WIDE_CS = [16, 64, 128]


def _expected_single_path(n, d, c):
    """The single-model path by the plan's rule: tile where its
    micro-tiles and a tile fit; wide while V and one record fit and the
    card measured it faster (C ≤ 16, C > 128, C ≤ 24 with C·d ≤ 12,288,
    or N ≤ 4096 with C·d ≤ 16,384); else C-tiled."""
    if fcm_update._tile_plan(n, d, c, H100["sms"], H100["ctas_per_sm"],
                             H100["smem_limit"]) is not None:
        return "tile"
    if 4 * first_layout_floats(d, c, 1) <= H100["smem_limit"] and (
            c <= 16 or c > 128 or (c <= 24 and c * d <= 12_288)
            or (n <= 4096 and c * d <= 16_384)):
        return "wide"
    return "ctiled"


@pytest.mark.parametrize("n", [65_536, 4096, 32])
@pytest.mark.parametrize("c", WIDE_CS)
@pytest.mark.parametrize("d", WIDE_DS)
def test_wide_plan_fits_and_covers_where_the_domain_reaches(n, d, c):
    """Inside the wide domain the plan is "wide", within an H100's shared
    memory, covering every record, dim and tile; outside it the plan
    keeps its tile or C-tiled path."""
    plan = plan_sweep(n, d, c, **H100)
    assert plan.path == _expected_single_path(n, d, c)
    _covers(plan, n, d=d, c=c)


@pytest.mark.parametrize("n", [16, 32, 2048, 32_604, 65_536])
def test_wide_plan_covers_the_sms_at_the_curriculum_shapes(n):
    """At the curriculum's d = 1536, C = 16 the wide grid reaches the
    card's 132 SMs by tiles from N = 2048 up; at the 16- and 32-point
    merges it halves the tile (not below 2 records) and splits d across
    more CTAs until they cover half the SMs, which the card measured
    faster than covering all of them with emptier CTAs."""
    plan = plan_sweep(n, 1536, 16, **H100)
    assert plan.path == "wide"
    _covers(plan, n, d=1536, c=16)
    if n >= 2048:
        assert plan.grid >= 132
        assert plan.rows == 32 and plan.dsplits == 3
    else:
        assert 132 // 2 <= plan.grid < 132 and plan.rows == 2


@pytest.mark.parametrize("n,d,c,path,micro,slices", [
    # the tile kernel's micro-tiles end at ⌈C/4⌉·⌈d/8⌉ = 256
    (4096, 512, 16, "tile", None, None), (4096, 513, 16, "wide", 8, 2),
    (4096, 2048, 4, "tile", None, None), (4096, 2049, 4, "wide", 4, 2),
    (4096, 64, 128, "tile", None, None), (4096, 65, 128, "wide", 8, 2),
    # V and one record in shared memory
    (4096, 3399, 16, "wide", 8, 7), (4096, 3400, 16, "ctiled", None, None),
    # the measured crossover to the C-tiled kernel (`wide_wins`)
    (65_536, 1024, 16, "wide", 8, 2), (65_536, 1024, 17, "ctiled", None, None),
    (4096, 256, 64, "wide", 8, 2), (4096, 257, 64, "ctiled", None, None),
    (4097, 256, 64, "ctiled", None, None),
    (65_536, 100, 128, "ctiled", None, None), (65_536, 100, 129, "wide", 8, 2),
    (65_536, 512, 24, "wide", 8, 2), (65_536, 513, 24, "ctiled", None, None),
    # a small N: tiles of two records, d split until half the SMs are busy
    (32, 1536, 16, "wide", 8, 5), (16, 1536, 16, "wide", 8, 9),
    # the micro-tile's 4 × 8 / 8 × 4 split at C = 4 / 5
    (4096, 8192, 4, "wide", 4, 4), (4096, 8192, 5, "wide", 8, 8),
    # past 8 CTAs a cluster is the card's non-portable size
    (4096, 16384, 2, "wide", 4, 8), (4096, 16385, 2, "wide", 4, 9)])
def test_wide_plan_both_sides_of_each_boundary(n, d, c, path, micro,
                                               slices):
    plan = plan_sweep(n, d, c, **H100)
    assert plan.path == path
    _covers(plan, n, d=d, c=c)
    if path == "wide":
        assert (plan.cm, plan.dsplits) == (micro, slices)


@pytest.mark.parametrize("held,path", [(40, "wide"), (1, "wide"),
                                       (0, "ctiled")])
def test_wide_grid_is_what_the_card_holds_at_once(held, path):
    """The ticketed final reduce waits for every CTA, so the grid is at
    most the clusters the card's occupancy query says it holds at once;
    where it holds none, the C-tiled path takes the shape."""
    plan = plan_sweep(65_536, 1536, 16, clusters=lambda draft: held,
                      **H100)
    assert plan.path == path
    if path == "wide":
        assert plan.grid == held * plan.dsplits


@pytest.mark.parametrize("tile,dsplit", [(0.25, 1.0), (2.0, 1.0),
                                         (1.0, 0.25), (1.0, 4.0),
                                         (0.5, 2.0)])
@pytest.mark.parametrize("n", [65_536, 2048, 32])
def test_wide_plan_takes_the_tuned_scales(n, tile, dsplit):
    """``PlanChoice.tile`` scales the records per tile by a power of 2,
    ``dsplit`` the CTAs d is split across (never below what the
    registers need nor above a cluster); the path and coverage stay."""
    base = plan_sweep(n, 1536, 16, **H100)
    plan = plan_sweep(n, 1536, 16, choice=fcm_update.PlanChoice(
        tile=tile, dsplit=dsplit), **H100)
    assert plan.path == "wide"
    _covers(plan, n, d=1536, c=16)
    assert 3 <= plan.dsplits <= fcm_update.WIDE_MAX_CLUSTER
    if tile < 1.0:
        assert plan.rows <= base.rows
    if dsplit > 1.0:
        assert plan.dsplits > base.dsplits


def test_wide_layout_at_the_curriculum_shape():
    """fcm_wide_kernel's shared memory at d = 1536, C = 16: three 512-dim
    slices, 32-record tiles (516-float rows): V 8256, |v|² 32, two tiles
    of 16,512 + 32, two receive buffers of three 544-float posts, sixteen
    k-groups' 544, wum and log d² 512 each, a float per warp."""
    assert fcm_update.wide_layout_floats(512, 16, 32, 3) == (
        8256 + 32 + 2 * (16_512 + 32) + 2 * 3 * 544 + 16 * 544 + 2 * 512
        + 16)


ROUTER_WIDTHS = [(900, 64), (2048, 64), (7168, 384)]


@pytest.mark.parametrize("d,c", ROUTER_WIDTHS)
@pytest.mark.parametrize("tenants,n", [(1, 262_144), (1, 3184), (1, 1),
                                       (3, 1000), (65_536, 512)])
def test_plan_covers_router_widths_within_the_scratch_bound(tenants, n, d,
                                                            c):
    """OLMoE's and Kimi-K2's d_model × n_experts (and d = 900): both plans
    take the C-tiled kernel, its scratch within CTILED_SCRATCH_BYTES."""
    plan = (plan_sweep(n, d, c, **H100) if tenants == 1
            else plan_batched(tenants, n, d, c, **H100))
    assert plan.path == "ctiled"
    assert plan.scratch <= fcm_update.CTILED_SCRATCH_BYTES
    _covers(plan, n, tenants)


def _ctiled_scratch(plan, d, c):
    """The C-tiled wrapper's scratch in bytes for ``plan``, counted from
    its buffers: wum (round4(C) floats a row) and q per row, the
    contraction's split partials and, with d-splits, the membership's
    partial x·vᵀ and |x|² per (split, row) and |v|² per (split, tile)."""
    ldc = (c + 3) & ~3
    floats = plan.rows * (ldc + 1) + plan.splits * (c * d + c + 1)
    if plan.dsplits > 1:
        floats += plan.dsplits * (plan.rows * (ldc + 1)
                                  + _cdiv(plan.rows, plan.tile) * ldc)
    return 4 * plan.group * floats


@pytest.mark.parametrize("budget", [None, 1_200_000, 600_000])
@pytest.mark.parametrize("tenants,n,d,c", [(1, 262_144, 2048, 64),
                                           (5, 1000, 2048, 64),
                                           (3, 1, 7168, 384),
                                           (1, 0, 4000, 64),
                                           (700, 300, 900, 64),
                                           (1, 128, 2048, 64),
                                           (1, 2048, 2047, 65),
                                           (5, 63, 2048, 64)])
def test_ctiled_chunks_cover_every_row_once(monkeypatch, budget, tenants, n,
                                            d, c):
    """Every (tenant, row) falls in one chunk and, within it, in one
    contraction split; every 32-dim chunk of d in one d-split; the plan's
    scratch counts every buffer, the d-split partials too, and stays
    within a cut budget wherever one partial and one 64-row tile fit."""
    if budget is not None:
        monkeypatch.setattr(fcm_update, "CTILED_SCRATCH_BYTES", budget)
    plan = fcm_update.plan_ctiled(tenants, n, d, c, sms=132,
                                  smem_limit=H100["smem_limit"])
    chunks = fcm_update.ctiled_chunks(plan, tenants, n)
    seen = np.zeros((tenants, max(n, 1)), np.int64)
    for t0, t1, r0, r1 in chunks:
        assert 0 < t1 - t0 <= plan.group and 0 <= r1 - r0 <= plan.rows
        seen[t0:t1, r0:r1] += 1
        # the contraction kernel's row splits of this chunk
        rows, per = r1 - r0, _cdiv(r1 - r0, plan.splits)
        split_of = np.zeros(rows, np.int64)
        for sp in range(plan.splits):
            ra = min(rows, sp * per)
            split_of[ra:min(rows, ra + per)] += 1
        assert (split_of == 1).all()
    assert (seen == (1 if n else 0)).all()
    # each tenant group starts its sums once and finishes once
    firsts = [(t0, r0) for t0, _, r0, _ in chunks if r0 == 0]
    assert len(firsts) == _cdiv(tenants, plan.group)
    # the membership's d-splits: whole 32-dim chunks, none empty
    n_chunks = _cdiv(d, fcm_update.CT_CHUNK)
    owner = [k // plan.kper for k in range(n_chunks)]
    assert owner == sorted(owner)
    assert sorted(set(owner)) == list(range(plan.dsplits))
    assert plan.dsplits == 1 or plan.kper >= fcm_update.CT_MIN_CHUNKS
    assert plan.scratch == _ctiled_scratch(plan, d, c)
    if budget is not None and 4 * (c * d + c + 1 + 64 * (c + 1)) <= budget:
        assert plan.scratch <= budget


# router_fit's shapes (its reducer, merges, blocks and full size) and
# Kimi-K2's width.
CTILED_CARD_SHAPES = [(64, 2048, 64), (128, 2048, 64), (2048, 2048, 64),
                      (262_144, 2048, 64), (1024, 7168, 384)]


@pytest.mark.parametrize("n,d,c", CTILED_CARD_SHAPES)
def test_ctiled_splits_fill_the_card(n, d, c):
    """The membership splits d until row tiles × d-splits reach about
    CT_CTAS_PER_SM CTAs per SM (no split under CT_MIN_CHUNKS chunks), and
    the contraction's row splits fill the card once at
    CT_CONTRACT_CTAS_PER_SM CTAs per SM; the full size keeps
    one d-split, its 128-record tiles filling the card alone."""
    sms = H100["sms"]
    slots = fcm_update.CT_CTAS_PER_SM * sms
    plan = plan_sweep(n, d, c, **H100)
    assert plan.path == "ctiled"
    tiles = _cdiv(min(plan.rows, n), plan.tile)
    most = tiles * _cdiv(_cdiv(d, fcm_update.CT_CHUNK),
                         fcm_update.CT_MIN_CHUNKS)
    assert plan.grid == tiles * plan.dsplits
    assert plan.grid >= min(sms, most)
    assert plan.dsplits == 1 or plan.grid < 2 * slots
    assert (plan.dsplits == 1) == (tiles >= slots)
    blocks = (_cdiv(c, fcm_update.CT_OUT_C)
              * _cdiv(d, fcm_update.CT_OUT_D))
    assert blocks * plan.splits >= min(
        sms, blocks * _cdiv(n, fcm_update.MIN_SPLIT_ROWS))
    assert plan.splits == 1 or n // plan.splits >= min(
        fcm_update.MIN_SPLIT_ROWS, fcm_update.SMALL_SPLIT_ROWS)
    assert plan.splits == 1 or blocks * plan.splits <= (
        fcm_update.CT_CONTRACT_CTAS_PER_SM * sms)
    if n == 262_144:
        assert (plan.tile, plan.dsplits, plan.grid) == (128, 1, 2048)
    if n <= 2048 and d == 2048:
        assert plan.tile == 64 and plan.dsplits > 1


def test_ctiled_plan_is_a_pure_function_of_shape_and_card():
    """The same shape and card give the same plan whatever was planned
    before; a card with half the SMs splits d less."""
    shapes = [(1, n, d, c) for n, d, c in CTILED_CARD_SHAPES]
    shapes += [(3, 1000, 2048, 64), (5, 1000, 2047, 65)]
    card = dict(sms=132, smem_limit=H100["smem_limit"])
    first = [fcm_update.plan_ctiled(*s, **card) for s in shapes]
    for s in reversed(shapes):
        fcm_update.plan_ctiled(*s, sms=66, smem_limit=101_376)
    assert [fcm_update.plan_ctiled(*s, **card) for s in shapes] == first
    half = fcm_update.plan_ctiled(1, 2048, 2048, 64, sms=66,
                                  smem_limit=H100["smem_limit"])
    assert 1 < half.dsplits < first[2].dsplits


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header changes the library's name, so a stale build is
    never loaded; the sources list follows the includes."""
    shutil.copytree(build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    names = ("fcm_accumulate", "fcm_batched", "fcm_ctiled")
    for name in names:
        assert [p.name for p in build.sources(name)] == [
            f"{name}.cu", "fcm_common.cuh"]
    before = {name: build.library_path(name) for name in names}
    assert before == {name: build.library_path(name) for name in names}
    header = tmp_path / "csrc" / "fcm_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in names}
    assert all(after[name] != before[name] for name in names)
