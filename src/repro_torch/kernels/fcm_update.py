"""The Hopper FCM accumulation kernels' wrappers, their launch plan and
their plain versions.

Counterpart of `repro.kernels.fcm_update` (the Pallas TPU kernel) and
`repro.kernels.ref` (its oracles).  The kernels are CUDA C++ for
``sm_90a`` in ``csrc/``: the single-model sweep's register-blocked tile
kernel and its wide kernel (d split across a cluster of CTAs) in
``fcm_accumulate.cu``, the tenant-stacked
sweep (the reference's ``jax.vmap`` of the Pallas kernel) in
``fcm_batched.cu``'s register-resident rows kernel (which the
single-model sweep also runs, at T = 1, for small C·d) and, past it, in
the tile kernel's tenant axis, and the C-tiled sweep of both (any C·d, V streamed through shared memory)
in ``fcm_ctiled.cu``; each source note says what it replaces, what bounds
it and how it is laid out.

* ``fcm_accumulate_cuda`` / ``fcm_sweep_cuda`` — the single-model
  wrappers, x (N, d), w (N,), centers (C, d).
* ``fcm_accumulate_batched_cuda`` / ``fcm_sweep_batched_cuda`` — the
  tenant-stacked wrappers, x (T, N, d), w (T, N), centers (T, C, d), m
  a scalar or one fuzzifier per tenant (T,).

Which kernel runs, with what tile, splits and grid, is `plan_sweep` /
`plan_batched`: pure functions of the shape, of three numbers the card
supplies (SM count, resident CTAs per SM, shared memory per block) and
of an optional `PlanChoice`, the free choices autotuning may set
(`repro_torch.perf.autotune`).  A wrapper looks the choice for its
shape's bucket up with the cached-only ``tuned_blocks`` (never a search)
and passes it in; a bucket never tuned runs the untuned plan.  A choice
never changes the path: the path decides which kernel can hold V.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version.  The plan covers every (d, C): past the shared memory of
the wide kernel's domain and of the tile kernel's micro-tiles, the
C-tiled path walks the rows in chunks whose scratch
stays within ``CTILED_SCRATCH_BYTES`` (`plan_ctiled`, `ctiled_chunks`).  Each wrapper counts its kernel launches in its
``launches`` attribute, and in ``shapes`` per (path, N, C) (single-model)
or (path, T, N) (tenant-stacked), under one lock (host threads launch
at once in a threaded fleet); `reset_counts` zeroes both.
``fcm_accumulate_ref`` / ``fcm_sweep_ref`` and
``fcm_accumulate_batched_ref`` / ``fcm_sweep_batched_ref`` are the plain
PyTorch versions, written as `repro.kernels.ref` writes its oracles (the
direct ‖x−v‖², not the kernels' expansion).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
import threading
from typing import Callable, Optional, Union

import torch

from . import build

_D2_FLOOR = 1e-12
_P = ctypes.c_void_p
_I = ctypes.c_int


def fcm_accumulate_ref(x, w, centers, m: float = 2.0):
    """Plain raw accumulators (v_num, w_i, q)."""
    x = x.float()
    w = w.float()
    v = centers.float()
    d2 = torch.clamp(torch.sum((x[:, None, :] - v[None, :, :]) ** 2, dim=-1),
                     min=_D2_FLOOR)
    expo = 1.0 / (m - 1.0)
    logd = torch.log(d2)
    lmin = torch.min(logd, dim=-1, keepdim=True).values
    r = torch.exp(-expo * (logd - lmin))
    u = r / torch.sum(r, dim=-1, keepdim=True)
    wum = torch.pow(u, m) * w[:, None]
    return wum.T @ x, torch.sum(wum, dim=0), torch.sum(wum * d2)


def fcm_sweep_ref(x, w, centers, m: float = 2.0):
    """Plain Alg.-1 sweep (v_new, w_i, q): the accumulate version plus
    the one deferred normalization."""
    v_num, w_i, q = fcm_accumulate_ref(x, w, centers, m)
    return v_num / torch.clamp(w_i, min=_D2_FLOOR)[:, None], w_i, q


def _fuzzifiers(m, tenants: int, device) -> torch.Tensor:
    """``m`` (a number, or one value per tenant) as a (T,) f32 tensor."""
    m = torch.as_tensor(m, dtype=torch.float32, device=device)
    if m.dim() == 0:
        return m.expand(tenants)
    if m.shape != (tenants,):
        raise ValueError(f"m has shape {tuple(m.shape)}; expected a scalar "
                         f"or one fuzzifier per tenant ({tenants},)")
    return m


def fcm_accumulate_batched_ref(x, w, centers, m=2.0):
    """Plain raw accumulators per tenant: (v_num (T, C, d), w_i (T, C),
    q (T,)) for x (T, N, d), w (T, N), centers (T, C, d), m a scalar or
    (T,)."""
    x = x.float()
    w = w.float()
    v = centers.float()
    mt = _fuzzifiers(m, x.shape[0], x.device)[:, None, None]
    d2 = torch.clamp(
        torch.sum((x[:, :, None, :] - v[:, None, :, :]) ** 2, dim=-1),
        min=_D2_FLOOR)                                    # (T, N, C)
    expo = 1.0 / (mt - 1.0)
    logd = torch.log(d2)
    lmin = torch.min(logd, dim=-1, keepdim=True).values
    r = torch.exp(-expo * (logd - lmin))
    u = r / torch.sum(r, dim=-1, keepdim=True)
    wum = torch.pow(u, mt) * w[:, :, None]
    return (wum.transpose(1, 2) @ x, torch.sum(wum, dim=1),
            torch.sum(wum * d2, dim=(1, 2)))


def fcm_sweep_batched_ref(x, w, centers, m=2.0):
    """Plain tenant-stacked sweep (v_new, w_i, q), each with leading T."""
    v_num, w_i, q = fcm_accumulate_batched_ref(x, w, centers, m)
    return v_num / torch.clamp(w_i, min=_D2_FLOOR)[..., None], w_i, q



# ------------------------------------------------------------ launch plan --

# fcm_rows_kernel's (d, C) instantiations, and its records per thread
ROWS_VARIANTS = ((4, 3), (4, 4), (8, 8), (16, 4), (32, 2))
ROWS_PER_THREAD = 8
WARP_TEAM_ROWS = 1024  # most records per tenant that one warp walks alone
WARP_TEAM_BLOCK = 128  # threads per CTA of one-warp teams
MIN_ROWS = 8  # fewest records per CTA when a small N is spread over the SMs
# fcm_tile_kernel's threads and micro-tiles (d2: TILE_RM records; v_num:
# TILE_AC centers x TILE_AD dims)
TILE_BLOCK, TILE_RM, TILE_AC, TILE_AD = 256, 4, 4, 8
# Fewest records per tile the tenant-stacked tile plan shrinks a tile to
# for more row splits when the tenants alone do not fill the card
TENANT_MIN_TILE = 64
# The ticketed final reduce: partial floats one of its CTAs reads at most,
# and how many CTAs may share it (far below the card's resident CTAs)
SLICE_FLOATS = 1024
MAX_SLICES = 64
# The C-tiled kernels (csrc/fcm_ctiled.cu): CT_THREADS threads a CTA;
# the membership's ring of CT_STAGES stages of CT_BK dims ([row][dim]
# tiles CT_LDK floats a row); membership tiles of CT_TILES records x
# CT_CENTERS centers, d split across CTAs in whole CT_CHUNK-dim chunks,
# at least CT_MIN_CHUNKS a split; contraction blocks of CT_OUT_C centers
# x CT_OUT_D dims; the CTAs per SM the plan aims the membership
# (CT_CTAS_PER_SM) and the contraction (CT_CONTRACT_CTAS_PER_SM) at; the
# scratch bound
CT_THREADS, CT_STAGES, CT_BK, CT_LDK = 128, 3, 32, 36
CT_TILES, CT_CENTERS, CT_CHUNK, CT_MIN_CHUNKS = (64, 128), 64, 32, 4
CT_OUT_C, CT_OUT_D = 64, 128
CT_CTAS_PER_SM = 2
CT_CONTRACT_CTAS_PER_SM = 4
CTILED_SCRATCH_BYTES = 256 << 20
# Records per contraction split: at least MIN_SPLIT_ROWS, except that a
# small N takes up to SMALL_SPLITS splits of at least SMALL_SPLIT_ROWS (its
# 16-record stages wait on memory more than they compute)
MIN_SPLIT_ROWS, SMALL_SPLITS, SMALL_SPLIT_ROWS = 128, 4, 32
# The wide kernel (fcm_wide_kernel<MC, MD>): WIDE_BLOCK threads a CTA; a
# cluster of at most WIDE_MAX_CLUSTER CTAs (past 8 the card's non-portable
# size) shares each tile of at most WIDE_MAX_ROWS records (a power of 2),
# each CTA a d-slice of a multiple of WIDE_DIM_STEP dims; x·vᵀ in 4 × 4
# micro-tiles, v_num in MC × MD = 16 registers a thread for the whole walk
# (`wide_micro`)
WIDE_BLOCK, WIDE_MAX_CLUSTER, WIDE_MAX_ROWS, WIDE_DIM_STEP = 512, 16, 64, 8
# Where both the wide and the C-tiled kernel can run, the wide one takes
# C <= WIDE_C, C > 128 (the C-tiled kernel's second 64-center tile mostly
# empty), C <= WIDE_MID_C with C*d <= WIDE_MID_CD, and N <= WIDE_SMALL_N
# with C*d <= WIDE_SMALL_CD; the C-tiled one the rest (`wide_wins`:
# scripts/compare_kernels.py --set route on an H100; PERF.md §6)
WIDE_C, WIDE_MID_C, WIDE_MID_CD = 16, 24, 12288
WIDE_SMALL_N, WIDE_SMALL_CD = 4096, 16384
# At small N the wide grid aims at WIDE_FILL of the SMs (tiles halved down
# to WIDE_MIN_ROWS records, then d split further): filling every SM there
# was measured slower (more, emptier CTAs, more partials to sum)
WIDE_FILL, WIDE_MIN_ROWS = 0.5, 2


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """The free choices of a launch plan, each a scale of the plan's own
    pick (1.0 everywhere: the untuned plan).  ``split`` scales the rows
    path's records per split; ``tile`` the tile path's records per tile,
    and on the C-tiled path moves the membership's record tile up (> 1)
    or down (< 1) between ``CT_TILES``; ``dsplit`` scales the C-tiled
    membership's d-splits.  Scales, not counts, so that one choice
    serves every shape of a bucket."""
    split: float = 1.0
    tile: float = 1.0
    dsplit: float = 1.0


UNTUNED = PlanChoice()


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch: ``path`` is "rows" (register-resident records), "tile"
    (register-blocked tiles), "wide" (d split across a cluster of CTAs)
    or "ctiled" (V streamed through shared memory); ``grid`` CTAs of
    ``block`` threads; ``rows`` records per split (rows) or at most per
    tile (tile, wide);
    ``splits`` row splits per tenant (tile, one model: every CTA a
    split); ``smem`` bytes of dynamic shared memory; ``slices`` CTAs that
    share the ticketed final reduce (0: the CTAs write the outputs
    themselves).  ``dm`` /
    ``cm`` name the rows kernel's instantiation and ``team_warps`` the
    warps that own one (tenant, split); ``cg``, ``rc``,
    ``ag``, ``dg``, ``rs`` the tile kernel's micro-tiles; ``group``,
    ``resident``, ``scratch``, ``tile``, ``dsplits`` and ``kper`` the
    C-tiled kernel's tenants per launch, d² block in shared memory,
    scratch bytes, records per membership tile, d-splits and 32-dim
    chunks per d-split.  On the wide path ``dsplits`` is the cluster's
    CTAs, ``kper`` the dims of each one's slice, ``cm`` the centers and
    ``ag`` × ``dg`` the groups of its v_num micro-tiles."""
    path: str
    block: int
    grid: int
    rows: int
    splits: int = 1
    smem: int = 0
    slices: int = 0
    dm: int = 0
    cm: int = 0
    team_warps: int = 0
    cg: int = 0
    rc: int = 0
    ag: int = 0
    dg: int = 0
    rs: int = 0
    group: int = 0
    resident: bool = False
    scratch: int = 0
    tile: int = 0
    dsplits: int = 1
    kper: int = 0


CtasPerSm = Union[int, Callable[[LaunchPlan], int]]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2ceil(a: int) -> int:
    return 1 << max(0, a - 1).bit_length()


def _per_sm(ctas_per_sm: CtasPerSm, plan: LaunchPlan) -> int:
    k = ctas_per_sm(plan) if callable(ctas_per_sm) else ctas_per_sm
    return max(1, int(k))


def rows_variant(d: int, c: int) -> Optional[tuple]:
    """The rows kernel's (DM, CM) instantiation for (d, C), or None when
    C·d is too large for its registers."""
    for dm, cm in ROWS_VARIANTS:
        if d <= dm and c <= cm:
            return dm, cm
    return None


def _split_rows(t: int, n: int, cap: int, sms: int) -> int:
    """Records per split for t tenants of n records on a card holding
    ``cap`` resident CTAs: enough splits to fill the card, no split below
    a full block's worth of records unless it takes that to give every SM
    a CTA (at least ``MIN_ROWS`` records each), and never more splits in
    all than the card holds at once (no tail wave)."""
    if t >= cap:
        return n
    fill = min(_cdiv(cap, t), _cdiv(n, 256 * ROWS_PER_THREAD))
    floor_total = min(sms, _cdiv(t * n, MIN_ROWS))
    want = max(1, fill, _cdiv(floor_total, t))
    chunk = _cdiv(n, want)
    if t * _cdiv(n, chunk) < floor_total:
        chunk = max(1, n // want)
    return chunk


def _slices(grid: int, p_len: int) -> int:
    return max(1, min(grid, MAX_SLICES, _cdiv(grid * p_len, SLICE_FLOATS)))


def _rows_plan(t, n, d, c, sms, ctas_per_sm, tenant_slices: bool,
               choice: PlanChoice = UNTUNED):
    dm, cm = rows_variant(d, c)
    draft = LaunchPlan("rows", 256, 0, n, dm=dm, cm=cm, team_warps=8)
    chunk = _split_rows(t, n, sms * _per_sm(ctas_per_sm, draft), sms)
    if choice.split != 1.0:
        chunk = max(min(MIN_ROWS, n), min(n, round(chunk * choice.split)))
    splits = _cdiv(n, chunk)
    if splits == 1 and n <= WARP_TEAM_ROWS:
        # One warp per tenant, several tenants per CTA.
        per_cta = WARP_TEAM_BLOCK // 32
        return LaunchPlan("rows", WARP_TEAM_BLOCK, _cdiv(t, per_cta), n,
                          dm=dm, cm=cm, team_warps=1)
    # One CTA per (tenant, split); with splits, at least four warps to sum
    # the partials at the end.
    block = min(256, max(128 if splits > 1 else 32,
                         _pow2ceil(_cdiv(chunk, ROWS_PER_THREAD))))
    slices = 0
    if splits > 1:
        # Several tenants: the last split of each sums alone (no CTA waits).
        slices = 1 if tenant_slices else _slices(splits, c * d + c + 1)
    return LaunchPlan("rows", block, t * splits, chunk, splits, 0, slices,
                      dm=dm, cm=cm, team_warps=block // 32)


def _round4(a: int) -> int:
    return (a + 3) & ~3


def tile_layout_floats(d, c, tr, rs, ag, dg) -> int:
    """fcm_tile_kernel's shared memory in floats (csrc/fcm_accumulate.cu,
    `tile_layout`)."""
    ldv, ldx, ldc = d | 1, _round4(d) | 4, _round4(c)
    tiles = 2 * (tr * ldx + 8 + _round4(tr))
    scratch = rs * ag * dg * TILE_AC * TILE_AD + rs * ag * TILE_AC
    head = _round4(c * ldv + c)
    return _round4(head + max(tiles, scratch)) + tr * ldc + TILE_BLOCK // 32


def _tile_geometry(d: int, c: int) -> Optional[tuple]:
    """The tile kernel's (cg, rc, ag, dg, rs) for (d, C): cg center groups
    of rc centers in the d² micro-tile, ag × dg v_num micro-tiles over rs
    record subsets; None past its micro-tiles (C > 128 or ⌈C/4⌉·⌈d/8⌉ >
    256)."""
    cg = _pow2ceil(_cdiv(c, TILE_AC))
    ag, dg = _cdiv(c, TILE_AC), _cdiv(d, TILE_AD)
    if cg > 32 or ag * dg > TILE_BLOCK:
        return None
    return cg, _cdiv(c, cg), ag, dg, TILE_BLOCK // (ag * dg)


def _tile_fit(d, c, tr, geo, smem_limit) -> int:
    """The largest tile of at most ``tr`` records whose shared memory lets
    two CTAs share an SM, else one (while that keeps at least
    min(tr, 32) records), or 0 where not one record fits."""
    _, _, ag, dg, rs = geo
    for budget in (smem_limit // 2, smem_limit):
        fit = tr
        while fit > 0 and (4 * tile_layout_floats(d, c, fit, rs, ag, dg)
                           > budget):
            fit -= 1
        if fit >= min(tr, 32):
            break
    return fit


def _tile_draft(d, c, tr, geo) -> LaunchPlan:
    cg, rc, ag, dg, rs = geo
    return LaunchPlan("tile", TILE_BLOCK, 0, tr,
                      smem=4 * tile_layout_floats(d, c, tr, rs, ag, dg),
                      cg=cg, rc=rc, ag=ag, dg=dg, rs=rs)


def _tile_plan(n, d, c, sms, ctas_per_sm, smem_limit,
               choice: PlanChoice = UNTUNED):
    geo = _tile_geometry(d, c)
    if geo is None:
        return None
    # Full tiles give each thread TILE_RM records of the d² micro-tile; a
    # small N gets tiles of N // SMs records (at least MIN_ROWS), so that
    # every SM has one.
    cap = TILE_RM * (TILE_BLOCK // geo[0])
    tr = max(1, min(cap, max(MIN_ROWS, n // sms), n))
    if choice.tile != 1.0:
        tr = max(1, min(cap, n, round(tr * choice.tile)))
    tr = _tile_fit(d, c, tr, geo, smem_limit)
    if tr == 0:
        return None
    draft = _tile_draft(d, c, tr, geo)
    grid = min(_cdiv(n, tr), sms * _per_sm(ctas_per_sm, draft))
    return dataclasses.replace(draft, grid=grid,
                               slices=_slices(grid, c * d + c + 1))


def _tile_batched_plan(t, n, d, c, sms, ctas_per_sm, smem_limit,
                       choice: PlanChoice = UNTUNED):
    """The tile kernel's launch for T > 1 tenants of n records: each
    tenant's rows in equal tiles of at most the cap (``choice.tile``
    scales it), one CTA per tenant where the tenants alone fill the card
    (the CTA writes the tenant's outputs), else up to enough row splits
    per tenant to fill it, one a tile, the tiles shrunk for that down to
    TENANT_MIN_TILE records (not below: a split's fixed cost, its V_t,
    partial and share of the final sum, outweighs a smaller tile's
    work), each tenant's last CTA summing its partials (one slice: no
    CTA waits)."""
    geo = _tile_geometry(d, c)
    if geo is None:
        return None
    cap = TILE_RM * (TILE_BLOCK // geo[0])
    if choice.tile != 1.0:
        cap = max(1, min(cap, round(cap * choice.tile)))
    cap = _tile_fit(d, c, min(cap, n), geo, smem_limit)
    if cap == 0:
        return None
    slots = sms * _per_sm(ctas_per_sm, _tile_draft(d, c, cap, geo))
    want = 1 if t >= slots else _cdiv(slots, t)
    tiles = max(_cdiv(n, cap), min(want, _cdiv(n, TENANT_MIN_TILE)))
    tr = _cdiv(n, tiles)
    splits = min(want, tiles)
    return dataclasses.replace(_tile_draft(d, c, tr, geo), grid=t * splits,
                               splits=splits, slices=int(splits > 1))


def tile_walk(plan: LaunchPlan, tenants: int, n: int, live=None) -> list:
    """The (tenant, split, r0, r1) row ranges fcm_tile_tenants_kernel
    walks on a tenant-stacked "tile" ``plan`` (csrc/fcm_accumulate.cu):
    tenant t's n_eff rows in tiles = ⌈n_eff / rows⌉ tiles of
    n_eff // tiles rows, the first n_eff % tiles of them one more, split
    s walking tiles s, s + splits, ...; n_eff is n, or with one split per
    tenant (T > 1) ``live[t]``, one past the tenant's last nonzero
    weight."""
    splits = plan.grid // tenants
    out = []
    for t in range(tenants):
        ne = live[t] if live is not None and tenants > 1 and splits == 1 \
            else n
        tiles = _cdiv(ne, plan.rows)
        per, extra = divmod(ne, tiles) if tiles else (0, 0)
        out += [(t, k % splits, k * per + min(k, extra),
                 (k + 1) * per + min(k + 1, extra)) for k in range(tiles)]
    return out


def first_layout_floats(d, c, t, block=256) -> int:
    """Shared memory in floats of a block that holds V, a t-record tile,
    its norms, weights, d² and wum, and a reduction buffer of ``block``
    floats: at one record, the bound of the wide path's domain
    (`plan_sweep`), kept where the single-model sweep's first version
    ran, so that no C-tiled shape changed its path."""
    ldv = ldx = d | 1
    ldc = c | 1
    return c * ldv + c + t * ldx + 2 * t + 2 * t * ldc + block


def _d2_ld(c: int) -> int:
    return (c + 22) // 32 * 32 + 9


def ctiled_member_floats(c: int, tile: int, resident: bool) -> int:
    """The C-tiled membership kernel's shared memory in floats
    (csrc/fcm_ctiled.cu, `member_layout`): the ring, |x|² and w of the
    tile's records, |v|² of a center tile, and the tile's d² block when it
    is resident (over the ring when C ≤ 64 and it fits there)."""
    ring = CT_STAGES * (tile + CT_CENTERS) * CT_LDK
    total = ring + 2 * tile + CT_CENTERS
    if resident and (c > CT_CENTERS or tile * _d2_ld(c) > ring):
        total += tile * _d2_ld(c)
    return total


def _dsplit_floats(rows: int, c: int, tile: int, dsplits: int) -> int:
    """Floats per tenant of the d-split partials: x·vᵀ and |x|² per
    (split, row), |v|² per (split, row tile)."""
    if dsplits == 1:
        return 0
    ldc = _round4(c)
    return dsplits * (rows * (ldc + 1) + _cdiv(rows, tile) * ldc)


def _ctiled_choice(choice: PlanChoice, tile: int, kper: int, chunks: int,
                   rows: int):
    """(tile, kper) of the C-tiled membership under ``choice``: the
    record tile moved between ``CT_TILES`` (the larger one only where a
    chunk holds it), the d-splits scaled, each split at least
    ``CT_MIN_CHUNKS`` chunks where d has that many."""
    if choice.tile > 1.0 and rows >= CT_TILES[1]:
        tile = CT_TILES[1]
    elif choice.tile < 1.0:
        tile = CT_TILES[0]
    splits = _cdiv(chunks, min(kper, chunks))
    splits = max(1, min(chunks, round(splits * choice.dsplit)))
    return tile, max(min(CT_MIN_CHUNKS, chunks), _cdiv(chunks, splits))


def plan_ctiled(tenants: int, n: int, d: int, c: int, *, sms: int,
                smem_limit: int, choice: PlanChoice = UNTUNED
                ) -> LaunchPlan:
    """The C-tiled sweep's launch for x (T, n, d) and C centers (T = 1 for
    the single-model sweep).

    Its scratch (the chunk's wum block and per-record q terms, the
    contraction's split partials and the membership's d-split partials)
    stays within ``CTILED_SCRATCH_BYTES`` whenever one tenant's partial
    (C·d + C + 1 floats) and one 64-row tile of wum fit in it: ``group``
    tenants per launch, then enough row splits for the contraction's
    blocks to fill the card once at ``CT_CONTRACT_CTAS_PER_SM`` CTAs per
    SM (each split at least ``MIN_SPLIT_ROWS`` records, or up to
    ``SMALL_SPLITS`` of ``SMALL_SPLIT_ROWS``; the partials within half
    the budget), then as many records per chunk as the rest holds (whole
    tiles).  The membership takes 128-record tiles where they alone fill
    the card (and a chunk holds one), else 64-record tiles and
    ``dsplits`` d-splits of ``kper`` whole 32-dim chunks (at least
    ``CT_MIN_CHUNKS``), enough for tiles × splits × tenants to reach
    ``CT_CTAS_PER_SM`` CTAs per SM; fewer where their partials do not fit
    the rest of the budget.  Its d² block is resident in shared memory
    where that keeps the membership within half the card's shared memory
    per block (two CTAs per SM).  ``choice`` may move the record tile and
    scale the d-splits (`_ctiled_choice`) before the budget check."""
    budget = CTILED_SCRATCH_BYTES
    out = c * d + c + 1
    ldc = _round4(c)
    group = max(1, min(tenants, 65535,
                       budget // (4 * (out + CT_TILES[0] * (ldc + 1)))))
    slots = CT_CTAS_PER_SM * sms
    blocks = _cdiv(c, CT_OUT_C) * _cdiv(d, CT_OUT_D)
    splits = max(1, min(CT_CONTRACT_CTAS_PER_SM * sms // (blocks * group),
                        max(_cdiv(n, MIN_SPLIT_ROWS),
                            min(SMALL_SPLITS, _cdiv(n, SMALL_SPLIT_ROWS))),
                        budget // 2 // (4 * out * group), 65535))
    rows = (budget - 4 * out * group * splits) // (4 * (ldc + 1) * group)
    rows = max(1, min(n, rows))
    if CT_TILES[0] <= rows < n:
        rows -= rows % CT_TILES[0]
    chunks = _cdiv(d, CT_CHUNK)
    kper = chunks
    tile = CT_TILES[1]
    if min(rows, n) < tile or _cdiv(min(rows, n), tile) * group < slots:
        tile = CT_TILES[0]
        tiles = _cdiv(min(rows, n), tile) * group
        if 0 < tiles < slots:
            kper = max(CT_MIN_CHUNKS, _cdiv(chunks, _cdiv(slots, tiles)))
    if choice != UNTUNED:
        tile, kper = _ctiled_choice(choice, tile, kper, chunks, min(rows, n))
    avail = (budget - 4 * out * group * splits
             - 4 * (ldc + 1) * group * rows)
    while kper < chunks and 4 * group * _dsplit_floats(
            rows, c, tile, _cdiv(chunks, kper)) > avail:
        kper *= 2
    kper = min(kper, chunks)
    dsplits = _cdiv(chunks, kper)
    resident = 4 * ctiled_member_floats(c, tile, True) <= smem_limit // 2
    return LaunchPlan(
        "ctiled", CT_THREADS, _cdiv(min(rows, n), tile) * dsplits * group,
        rows, splits, 4 * ctiled_member_floats(c, tile, resident),
        group=group, resident=resident,
        scratch=4 * group * (rows * (ldc + 1) + splits * out
                             + _dsplit_floats(rows, c, tile, dsplits)),
        tile=tile, dsplits=dsplits, kper=kper)


def ctiled_chunks(plan: LaunchPlan, tenants: int, n: int) -> list:
    """The C-tiled wrapper's launches: (t0, t1, r0, r1) for tenants
    [t0, t1) and records [r0, r1), tenant groups outer, row chunks inner
    (in order, so raw sums add chunk after chunk); n = 0 gives one empty
    chunk per group, which writes zeros."""
    return [(t0, min(tenants, t0 + plan.group), r0, min(n, r0 + plan.rows))
            for t0 in range(0, tenants, plan.group)
            for r0 in (range(0, n, plan.rows) if n else (0,))]


def wide_micro(c: int) -> tuple:
    """The wide kernel's v_num micro-tile (MC centers, MD dims) a thread:
    4 × 4 for C ≤ 4, else 8 × 2."""
    return (4, 4) if c <= 4 else (8, 2)


def wide_layout_floats(ds: int, c: int, r: int, s: int) -> int:
    """The wide kernel's shared memory in floats for a ds-dim slice, C
    centers, r-record tiles and clusters of s CTAs
    (csrc/fcm_accumulate.cu, `wide_layout`): V's slice and |v|² twice, two
    x and w tile buffers, two receive buffers of the s CTAs' posts (the
    tile's partial x·vᵀ and |x|²), the k-groups' partials, wum and log d²,
    and a float per warp."""
    mc, _ = wide_micro(c)
    cp, ldw, ldx = _round4(c), _cdiv(c, mc) * mc, ((ds + 31) & ~31) + 4
    ks = WIDE_BLOCK // (max(1, r // 4) * (cp // 4))
    ex = r * cp + r
    o = cp * ldx + 2 * cp + 2 * (r * ldx + _round4(r)) + (2 * s + ks) * ex
    return _round4(o) + 2 * r * ldw + WIDE_BLOCK // 32


def wide_wins(n: int, d: int, c: int) -> bool:
    """Whether the wide kernel, not the C-tiled one, takes an (n, d, C)
    that both can run: at C <= 16 it was faster at every measured shape,
    at 24 <= C <= 128 slower past small N and C·d (its d-slices shrink as
    C grows, so its membership, formed on every CTA of a cluster, weighs
    more), at C > 128 faster."""
    return (c <= WIDE_C or c > 128
            or (c <= WIDE_MID_C and c * d <= WIDE_MID_CD)
            or (n <= WIDE_SMALL_N and c * d <= WIDE_SMALL_CD))


def _wide_split(d: int, s: int) -> tuple:
    """(CTAs, dims each) for d split s ways in WIDE_DIM_STEP-dim steps,
    no CTA empty."""
    ds = _cdiv(_cdiv(d, s), WIDE_DIM_STEP) * WIDE_DIM_STEP
    return _cdiv(d, ds), ds


def _wide_plan(n, d, c, sms, ctas_per_sm, smem_limit, choice=UNTUNED,
               clusters=None):
    """The wide kernel's launch, or None where d needs more than
    WIDE_MAX_CLUSTER slices.  The fewest slices whose v_num micro-tiles
    fit the CTA's threads, the largest tile (WIDE_MAX_ROWS down, halving)
    that fits shared memory; where tiles × slices cover less than
    WIDE_FILL of the SMs (a small N), the tile halves down to
    WIDE_MIN_ROWS records, then d splits further;
    ``choice.tile`` / ``choice.dsplit`` scale the tile (by powers of 2)
    and the slices.  ``clusters`` (the card's occupancy query on the draft
    plan) caps the grid at the clusters the card holds at once, since the
    ticketed final reduce waits for every CTA; by default the SMs ×
    resident CTAs (within shared memory) over the cluster size."""
    mc, md = wide_micro(c)
    ag = _cdiv(c, mc)
    cap = WIDE_BLOCK // ag * md // WIDE_DIM_STEP * WIDE_DIM_STEP
    if cap < WIDE_DIM_STEP or _cdiv(d, cap) > WIDE_MAX_CLUSTER:
        return None
    s_min = _cdiv(d, cap)
    s_most = min(WIDE_MAX_CLUSTER, _cdiv(d, WIDE_DIM_STEP))

    def fits(r, s, ds):
        return (max(1, r // 4) * (_round4(c) // 4) <= WIDE_BLOCK
                and 4 * wide_layout_floats(ds, c, r, s) <= smem_limit)

    def tile(r, s, ds):
        while r > 1 and not fits(r, s, ds):
            r //= 2
        return r if fits(r, s, ds) else 0

    s, ds = _wide_split(d, s_min)
    r = tile(WIDE_MAX_ROWS, s, ds)
    if r == 0:
        return None
    aim = sms * WIDE_FILL
    while r > WIDE_MIN_ROWS and _cdiv(n, r) * s < aim:
        r //= 2
    want = s
    while _cdiv(n, r) * s < aim and want < s_most:
        want += 1
        s, ds = _wide_split(d, want)
    if choice.dsplit != 1.0:
        s, ds = _wide_split(d, max(s_min, min(s_most,
                                               round(s * choice.dsplit))))
    if choice.tile != 1.0:
        scaled = 1 << max(0, round(math.log2(max(1.0, r * choice.tile))))
        r = min(scaled, WIDE_MAX_ROWS)
    r = tile(r, s, ds)
    if r == 0:
        return None
    smem = 4 * wide_layout_floats(ds, c, r, s)
    draft = LaunchPlan("wide", WIDE_BLOCK, 0, r, smem=smem, dsplits=s,
                       kper=ds, cm=mc, ag=ag, dg=ds // md)
    if clusters is None:
        per_sm = min(_per_sm(ctas_per_sm, draft), smem_limit // smem)
        held = sms * per_sm // s
    else:
        held = clusters(draft)
    if held < 1:
        return None
    grid = s * max(1, min(_cdiv(n, r), held))
    return dataclasses.replace(draft, grid=grid,
                               slices=_slices(grid, c * d + c + 1))


def plan_sweep(n: int, d: int, c: int, *, sms: int, ctas_per_sm: CtasPerSm,
               smem_limit: int, choice: Optional[PlanChoice] = None,
               clusters: Optional[Callable[[LaunchPlan], int]] = None
               ) -> LaunchPlan:
    """The single-model sweep's launch for x (n, d) and C centers on a card
    with ``sms`` SMs, ``smem_limit`` bytes of shared memory per block and
    ``ctas_per_sm`` resident CTAs per SM (a number, or a function of the
    draft plan, as the card's occupancy query is); ``clusters``, the
    clusters of a draft wide plan the card holds at once (`_wide_plan`).

    * "rows" — small C·d (`rows_variant`): the rows kernel at T = 1, the
      records split so that the card fills (`_split_rows`);
    * "tile" — C ≤ 128 and ⌈C/4⌉·⌈d/8⌉ ≤ 256 with a tile that fits shared
      memory: the register-blocked tile kernel;
    * "wide" — the rest while V and one record fit one block's shared
      memory (`first_layout_floats` at one record: where the first
      version ran, so that no C-tiled shape changes its path) and the
      card measured it faster there (`wide_wins`): the wide kernel
      (`_wide_plan`), d split across a cluster;
    * "ctiled" — beyond that, and at N = 0: the C-tiled kernel
      (`plan_ctiled`).

    ``choice`` (`PlanChoice`) sets the path's free choices.
    """
    choice = choice or UNTUNED
    if n > 0 and rows_variant(d, c) is not None:
        return _rows_plan(1, n, d, c, sms, ctas_per_sm, False, choice)
    plan = (_tile_plan(n, d, c, sms, ctas_per_sm, smem_limit, choice)
            if n > 0 else None)
    if plan is None and n > 0 and wide_wins(n, d, c) and \
            4 * first_layout_floats(d, c, 1) <= smem_limit:
        plan = _wide_plan(n, d, c, sms, ctas_per_sm, smem_limit, choice,
                          clusters)
    if plan is not None:
        return plan
    return plan_ctiled(1, n, d, c, sms=sms, smem_limit=smem_limit,
                       choice=choice)


def plan_batched(tenants: int, n: int, d: int, c: int, *, sms: int,
                 ctas_per_sm: CtasPerSm, smem_limit: int,
                 choice: Optional[PlanChoice] = None) -> LaunchPlan:
    """The tenant-stacked sweep's launch for x (T, n, d) and C centers (see
    `plan_sweep` for the card's three numbers).

    * "rows" — small C·d (`rows_variant`): one CTA per (tenant, split),
      one split per tenant once the tenants alone fill the card;
    * "tile" — where the tile kernel's micro-tiles and a tile fit (C ≤
      128, ⌈C/4⌉·⌈d/8⌉ ≤ 256; such as d = 41, C = 23): at T = 1 the
      single-model launch, else `_tile_batched_plan`;
    * "ctiled" — the rest: the C-tiled kernel (`plan_ctiled`).

    ``choice`` as in `plan_sweep`.
    """
    choice = choice or UNTUNED
    if rows_variant(d, c) is not None:
        return _rows_plan(tenants, n, d, c, sms, ctas_per_sm, True, choice)
    if tenants == 1:
        plan = _tile_plan(n, d, c, sms, ctas_per_sm, smem_limit, choice)
    else:
        plan = _tile_batched_plan(tenants, n, d, c, sms, ctas_per_sm,
                                  smem_limit, choice)
    if plan is not None:
        return plan
    return plan_ctiled(tenants, n, d, c, sms=sms, smem_limit=smem_limit,
                       choice=choice)


# --------------------------------------------------------- the libraries --

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fcm_accumulate")
    lib.fcm_error_string.argtypes = [_I]
    lib.fcm_error_string.restype = ctypes.c_char_p
    lib.fcm_device.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.fcm_device.restype = _I
    lib.fcm_tile_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.fcm_tile_occupancy.restype = _I
    lib.fcm_wide_clusters.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.fcm_wide_clusters.restype = _I
    lib.fcm_tile_sweep.argtypes = [
        _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float, ctypes.c_float,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]
    lib.fcm_tile_sweep.restype = _I
    lib.fcm_tile_tenants_sweep.argtypes = [
        _P, _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float,
        ctypes.c_float, _I, _I, _I, _I, _I, _I, ctypes.c_longlong, _I, _I,
        _I, _I, _P, _P, _P, _P, _P, _I, _P]
    lib.fcm_tile_tenants_sweep.restype = _I
    lib.fcm_wide_sweep.argtypes = [
        _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float, ctypes.c_float,
        _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]
    lib.fcm_wide_sweep.restype = _I
    return lib


@functools.cache
def _batched_lib() -> ctypes.CDLL:
    lib = build.load("fcm_batched")
    lib.fcm_batched_error_string.argtypes = [_I]
    lib.fcm_batched_error_string.restype = ctypes.c_char_p
    lib.fcm_batched_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.fcm_batched_occupancy.restype = _I
    lib.fcm_rows_sweep.argtypes = [
        _P, _P, _P, _P, ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong,
        _I, _I, _I, _I, ctypes.c_longlong, _I, _I, _I, _I, _I, _P, _P, _P,
        _P, _P, _I, _P]
    lib.fcm_rows_sweep.restype = _I
    return lib


@functools.cache
def _ctiled_lib() -> ctypes.CDLL:
    lib = build.load("fcm_ctiled")
    lib.fcm_ctiled_error_string.argtypes = [_I]
    lib.fcm_ctiled_error_string.restype = ctypes.c_char_p
    lib.fcm_ctiled_chunk.argtypes = [
        _P, _P, _P, _P, ctypes.c_float, ctypes.c_longlong, _I, _I, _I, _I,
        ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
        _P, _I, _I, _P]
    lib.fcm_ctiled_chunk.restype = _I
    lib.fcm_ctiled_stage.argtypes = [_I, *lib.fcm_ctiled_chunk.argtypes]
    lib.fcm_ctiled_stage.restype = _I
    return lib


_LIBS = {"fcm_accumulate": _lib, "fcm_batched": _batched_lib,
         "fcm_ctiled": _ctiled_lib}


def _check(err: int, what: str, kernel: str = "fcm_accumulate") -> None:
    if err:
        lib = _LIBS[kernel]()
        msg = getattr(lib, f"{kernel}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} kernel: {what} failed with CUDA "
                           f"error {err} ({msg})")


@functools.cache
def _card(device_index: int):
    """(SM count, shared memory per block) of the current card."""
    sms, smem = _I(0), _I(0)
    _check(_lib().fcm_device(ctypes.byref(sms), ctypes.byref(smem)),
           "fcm_device")
    return sms.value, smem.value


def _occupancy(plan: LaunchPlan) -> int:
    """Resident CTAs per SM of the kernel ``plan`` launches (the rows or
    the tile kernel)."""
    k = _I(0)
    if plan.path == "tile":
        _check(_lib().fcm_tile_occupancy(plan.rc, plan.smem,
                                         ctypes.byref(k)),
               "fcm_tile_occupancy")
    else:
        _check(_batched_lib().fcm_batched_occupancy(
            plan.dm, plan.cm, plan.block, ctypes.byref(k)),
            "fcm_batched_occupancy", "fcm_batched")
    return k.value


def _wide_clusters(plan: LaunchPlan) -> int:
    """Clusters of ``plan.dsplits`` wide-kernel CTAs the card holds at
    once (the occupancy query)."""
    k = _I(0)
    _check(_lib().fcm_wide_clusters(plan.cm, plan.dsplits, plan.smem,
                                    ctypes.byref(k)), "fcm_wide_clusters")
    return k.value


@functools.lru_cache(maxsize=256)
def wide_plan(device: torch.device, n: int, d: int,
              c: int) -> Optional[LaunchPlan]:
    """The wide kernel's launch at (n, d, C) on ``device``'s card whatever
    path `plan_sweep` takes there (None outside its domain): for holding
    and timing the kernel against the C-tiled one at the same shape."""
    sms, smem = _card(device.index)
    return _wide_plan(n, d, c, sms, _occupancy, smem,
                      clusters=_wide_clusters)


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, n: int, d: int, c: int,
          choice: Optional[PlanChoice] = None) -> LaunchPlan:
    sms, smem = _card(device_index)
    return plan_sweep(n, d, c, sms=sms, smem_limit=smem, choice=choice,
                      ctas_per_sm=_occupancy, clusters=_wide_clusters)


@functools.lru_cache(maxsize=256)
def _batched_plan(device_index: int, tenants: int, n: int, d: int,
                  c: int, choice: Optional[PlanChoice] = None) -> LaunchPlan:
    sms, smem = _card(device_index)
    return plan_batched(tenants, n, d, c, sms=sms, smem_limit=smem,
                        choice=choice, ctas_per_sm=_occupancy)


_TUNED: dict = {}   # (device, n, d, c, tenants) -> (generation, choice)


@functools.cache
def _autotune():
    from ..perf import autotune     # not at import: perf imports this module
    return autotune


def tuned_choice(device: torch.device, n: int, d: int, c: int,
                 tenants: Optional[int] = None) -> Optional[PlanChoice]:
    """The autotuned `PlanChoice` of this shape's bucket on ``device``,
    or None where the bucket was never tuned: a cached lookup
    (`repro_torch.perf.autotune.tuned_blocks`), never a search.  Kept
    per shape until the tuning memo changes (its ``generation``), so a
    launch pays one dictionary lookup."""
    autotune = _autotune()
    key = (device.type, device.index, n, d, c, tenants)
    hit = _TUNED.get(key)
    if hit is not None and hit[0] == autotune.generation:
        return hit[1]
    gen = autotune.generation
    cfg = autotune.tuned_blocks((n, c, d), tenants=tenants, device=device)
    choice = None if cfg is None else PlanChoice(**cfg["choice"])
    _TUNED[key] = (gen, choice)
    return choice


def launch_plan(device: torch.device, n: int, d: int, c: int,
                tenants: Optional[int] = None) -> LaunchPlan:
    """The plan a launch at this shape takes on ``device`` now: the
    single-model plan (``tenants`` None) or the tenant-stacked one, on
    its bucket's tuned choice where there is one."""
    choice = tuned_choice(device, n, d, c, tenants)
    if tenants is None:
        return _plan(device.index, n, d, c, choice)
    return _batched_plan(device.index, tenants, n, d, c, choice)


_TICKETS: dict = {}


def _tickets(dev: torch.device, stream: int, groups: int) -> torch.Tensor:
    """The ticketed final reduce's counters (2 int32 per group) for one
    stream: zeroed once, left zero by every launch.  One array per stream,
    since launches on a stream run in order."""
    t = _TICKETS.get((dev.index, stream))
    if t is None or t.numel() < 2 * groups:
        t = torch.zeros(2 * max(groups, 64), dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = t
    return t


def _check_inputs(kernel: str, x, w, centers, dims) -> None:
    """Device, type and rank checks shared by both kernels' wrappers."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel: x on {x.device}, not CUDA")
    for name, a, dim in zip(("x", "w", "centers"), (x, w, centers), dims):
        if a.device != x.device:
            raise ValueError(f"{kernel} kernel: {name} on {a.device}, "
                             f"x on {x.device}")
        if not a.is_floating_point():
            raise TypeError(f"{kernel} kernel: {name} has dtype "
                            f"{a.dtype}, expected a floating type")
        if a.dim() != dim:
            raise ValueError(f"{kernel} kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {dim} dims")


def _rows_launch(plan, x, w, v, m_ptr, m, tenants, n, d, c, normalize, dev,
                 stream, out):
    """fcm_rows_kernel on ``plan`` (the single-model sweep's small-C·d path
    too, at T = 1)."""
    out_v, out_w, out_q = out
    part = tickets = None
    if plan.splits > 1:
        part = torch.empty((plan.grid, c * d + c + 1), dtype=torch.float32,
                           device=dev)
        tickets = _tickets(dev, stream, tenants)
    return _batched_lib().fcm_rows_sweep(
        x.data_ptr(), w.data_ptr(), v.data_ptr(), m_ptr, m, tenants, n, d, c,
        plan.dm, plan.cm, plan.rows, plan.splits, plan.team_warps,
        plan.slices, plan.block, plan.grid,
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out_v.data_ptr(),
        out_w.data_ptr(), out_q.data_ptr(), int(normalize), stream)


def _tile_launch(plan, x, w, v, m_ptr, m, tenants, n, d, c, normalize, dev,
                 stream, out):
    """fcm_tile_tenants_kernel on ``plan`` (``plan.grid`` CTAs: T = 1 a
    single-model plan, every CTA a split; else ``plan.splits`` a tenant);
    one split per tenant writes the outputs itself and skips each
    tenant's trailing zero-weight rows."""
    splits = plan.grid // tenants
    part = tickets = None
    if splits > 1:
        part = torch.empty((plan.grid, c * d + c + 1), dtype=torch.float32,
                           device=dev)
        tickets = _tickets(dev, stream, tenants)
    return _lib().fcm_tile_tenants_sweep(
        x.data_ptr(), w.data_ptr(), v.data_ptr(), m_ptr, n, d, c, m,
        1.0 / (m - 1.0) if m_ptr is None else 0.0, plan.rows, plan.cg,
        plan.rc, plan.ag, plan.dg, plan.rs, tenants, splits, plan.slices,
        int(tenants > 1 and splits == 1), plan.smem,
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        *(o.data_ptr() for o in out), int(normalize), stream)


def _wide_launch(plan, x, w, v, m, n, d, c, normalize, dev, stream, out):
    """fcm_wide_kernel on ``plan`` (a "wide" `LaunchPlan`); the cluster
    partials come from `torch.empty`."""
    part = torch.empty((plan.grid // plan.dsplits, c * d + c + 1),
                       dtype=torch.float32, device=dev)
    return _lib().fcm_wide_sweep(
        x.data_ptr(), w.data_ptr(), v.data_ptr(), n, d, c, m, 1.0 / (m - 1.0),
        plan.rows, plan.dsplits, plan.kper, plan.grid, plan.slices,
        plan.smem, part.data_ptr(), _tickets(dev, stream, 1).data_ptr(),
        *(o.data_ptr() for o in out), int(normalize), stream)


def _ctiled_launch(plan, x, w, v, m_ptr, m, tenants, n, d, c, normalize,
                   dev, stream, out):
    """The C-tiled kernel over `ctiled_chunks` (x (T, n, d) contiguous, T
    = 1 for the single-model sweep); the scratch comes from `torch.empty`
    and is at most ``plan.scratch`` bytes.  Returns the first failed
    launch's error, else 0."""
    lib = _ctiled_lib()
    g, rows = plan.group, plan.rows
    f32 = dict(dtype=torch.float32, device=dev)
    wum = torch.empty((g * rows * _round4(c),), **f32)
    qrow = torch.empty((g * rows,), **f32)
    part = torch.empty((g * plan.splits * (c * d + c + 1),), **f32)
    dpart = None
    if plan.dsplits > 1:
        dpart = torch.empty(
            (g * _dsplit_floats(rows, c, plan.tile, plan.dsplits),), **f32)
    out_v, out_w, out_q = out
    for t0, t1, r0, r1 in ctiled_chunks(plan, tenants, n):
        err = lib.fcm_ctiled_chunk(
            x.data_ptr(), w.data_ptr(), v.data_ptr(), m_ptr, m, n, d, c, t0,
            t1 - t0, r0, r1 - r0, rows, plan.splits, plan.tile, plan.kper,
            int(plan.resident), wum.data_ptr(), qrow.data_ptr(),
            None if dpart is None else dpart.data_ptr(), part.data_ptr(),
            out_v.data_ptr(), out_w.data_ptr(), out_q.data_ptr(),
            int(r0 == 0), int(normalize and r1 == n), stream)
        if err:
            return err
    return 0


def _launch(x, w, centers, m: float, normalize: bool,
            choice: Optional[PlanChoice] = None, wide: bool = False):
    """Launch the single-model sweep on ``choice`` (None: the tuned one
    of its bucket, if any; autotuning times its candidates through it),
    or with ``wide`` on the wide kernel whatever the plan's path
    (`wide_plan`); returns ((v, w_i, q), path).  Counts nothing: the
    wrappers count."""
    _check_inputs("fcm_accumulate", x, w, centers, (2, 1, 2))
    n, d = x.shape
    c = centers.shape[0]
    if w.shape[0] != n or centers.shape[1] != d or c == 0 or d == 0:
        raise ValueError(
            "fcm_accumulate kernel: shapes x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, centers "
            f"{tuple(centers.shape)} do not form (N, d), (N,), (C, d)")
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    v = centers.to(torch.float32).contiguous()
    dev = x.device
    m = float(m)
    with torch.cuda.device(dev):
        if wide:
            plan = wide_plan(dev, n, d, c)
            if plan is None:
                raise ValueError(f"fcm_accumulate kernel: ({n}, {d}, {c}) is "
                                 "outside the wide kernel's domain")
        else:
            if choice is None:
                choice = tuned_choice(dev, n, d, c)
            plan = _plan(dev.index, n, d, c, choice)
        out = (torch.empty((c, d), dtype=torch.float32, device=dev),
               torch.empty((c,), dtype=torch.float32, device=dev),
               torch.empty((), dtype=torch.float32, device=dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel = "fcm_accumulate"
        if plan.path == "rows":
            kernel = "fcm_batched"
            err = _rows_launch(plan, x, w, v, None, m, 1, n, d, c, normalize,
                               dev, stream, out)
        elif plan.path == "ctiled":
            kernel = "fcm_ctiled"
            err = _ctiled_launch(plan, x, w, v, None, m, 1, n, d, c,
                                 normalize, dev, stream, out)
        elif plan.path == "tile":
            part = torch.empty((plan.grid, c * d + c + 1),
                               dtype=torch.float32, device=dev)
            err = _lib().fcm_tile_sweep(
                x.data_ptr(), w.data_ptr(), v.data_ptr(), n, d, c, m,
                1.0 / (m - 1.0), plan.rows, plan.cg, plan.rc, plan.ag,
                plan.dg, plan.rs, plan.grid, plan.slices, plan.smem,
                part.data_ptr(), _tickets(dev, stream, 1).data_ptr(),
                *(o.data_ptr() for o in out), int(normalize), stream)
        else:
            err = _wide_launch(plan, x, w, v, m, n, d, c, normalize, dev,
                               stream, out)
    _check(err, "launch", kernel)
    return out, plan.path


_COUNT_LOCK = threading.Lock()


def _count(fn, key) -> None:
    """One launch of ``fn`` at ``key``: under a lock, so the counts stay
    exact when host threads (a threaded fleet) launch at once."""
    with _COUNT_LOCK:
        fn.launches += 1
        fn.shapes[key] += 1


def fcm_accumulate_cuda(x, w, centers, m: float = 2.0):
    """Raw Alg.-1 accumulators (v_num (C, d), w_i (C,), q ()) — the
    streaming entry, normalization deferred so partials from chunks add.

    x: (N, d), w: (N,), centers: (C, d), any float type (cast to f32)."""
    if x.device.type == "cpu":
        return fcm_accumulate_ref(x, w, centers, m)
    out, path = _launch(x, w, centers, m, False)
    _count(fcm_accumulate_cuda, (path, x.shape[0], centers.shape[0]))
    return out


def fcm_sweep_wide(x, w, centers, m: float = 2.0, normalize: bool = True):
    """The single-model sweep (or, with ``normalize`` false, its raw
    accumulators) on the wide kernel whatever path the plan takes at this
    shape (`wide_plan`), to hold and time it against the C-tiled kernel;
    CUDA tensors only, counts nothing."""
    return _launch(x, w, centers, m, normalize, wide=True)[0]


def fcm_sweep_cuda(x, w, centers, m: float = 2.0):
    """Alg.-1 sweep (v_new, w_i, q): the accumulate entry with the
    normalization v_num / max(w_i, 1e-12) fused into its final reduce."""
    if x.device.type == "cpu":
        return fcm_sweep_ref(x, w, centers, m)
    out, path = _launch(x, w, centers, m, True)
    _count(fcm_sweep_cuda, (path, x.shape[0], centers.shape[0]))
    return out


def _launch_batched(x, w, centers, m, normalize: bool,
                    choice: Optional[PlanChoice] = None):
    """Launch the tenant-stacked sweep on ``choice`` (as `_launch`);
    returns ((v, w_i, q), path)."""
    _check_inputs("fcm_batched", x, w, centers, (3, 2, 3))
    tenants, n, d = x.shape
    c = centers.shape[1]
    if (tuple(w.shape) != (tenants, n) or centers.shape[0] != tenants
            or centers.shape[2] != d or min(tenants, n, c, d) == 0):
        raise ValueError(
            "fcm_batched kernel: shapes x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, centers "
            f"{tuple(centers.shape)} do not form (T, N, d), (T, N), "
            "(T, C, d) with T, N, C, d >= 1")
    dev = x.device
    scalar_m = isinstance(m, (int, float))
    mt = None if scalar_m else _fuzzifiers(m, tenants, dev).contiguous()
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    v = centers.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        if choice is None:
            choice = tuned_choice(dev, n, d, c, tenants)
        plan = _batched_plan(dev.index, tenants, n, d, c, choice)
        if plan.grid >= 2 ** 31:
            raise ValueError(f"fcm_batched kernel: {plan.grid} CTAs exceed "
                             "the grid's 2^31 - 1")
        out = (torch.empty((tenants, c, d), dtype=torch.float32, device=dev),
               torch.empty((tenants, c), dtype=torch.float32, device=dev),
               torch.empty((tenants,), dtype=torch.float32, device=dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch, kernel = {"rows": (_rows_launch, "fcm_batched"),
                          "tile": (_tile_launch, "fcm_accumulate"),
                          "ctiled": (_ctiled_launch, "fcm_ctiled")}[plan.path]
        err = launch(plan, x, w, v, None if mt is None else mt.data_ptr(),
                     float(m) if scalar_m else 0.0, tenants, n, d, c,
                     normalize, dev, stream, out)
    _check(err, "launch", kernel)
    return out, plan.path


def fcm_accumulate_batched_cuda(x, w, centers, m=2.0):
    """Raw accumulators per tenant (v_num (T, C, d), w_i (T, C), q (T,))
    in one launch.  x: (T, N, d), w: (T, N) with zeros on phantom rows,
    centers: (T, C, d), m: a scalar or (T,)."""
    if x.device.type == "cpu":
        return fcm_accumulate_batched_ref(x, w, centers, m)
    out, path = _launch_batched(x, w, centers, m, False)
    _count(fcm_accumulate_batched_cuda, (path,) + tuple(x.shape[:2]))
    return out


def fcm_sweep_batched_cuda(x, w, centers, m=2.0):
    """Tenant-stacked sweep (v_new, w_i, q) in one launch, the per-tenant
    normalization fused into the kernel."""
    if x.device.type == "cpu":
        return fcm_sweep_batched_ref(x, w, centers, m)
    out, path = _launch_batched(x, w, centers, m, True)
    _count(fcm_sweep_batched_cuda, (path,) + tuple(x.shape[:2]))
    return out


WRAPPERS = (fcm_accumulate_cuda, fcm_sweep_cuda, fcm_accumulate_batched_cuda,
            fcm_sweep_batched_cuda)


def reset_counts() -> None:
    """Zero every wrapper's ``launches`` and ``shapes``."""
    with _COUNT_LOCK:
        for fn in WRAPPERS:
            fn.launches = 0
            fn.shapes = collections.Counter()


reset_counts()
