"""BigFCM (paper Algorithm 3) on one device or a device mesh — the
port's main path.

Counterpart of `repro.core.bigfcm`: the in-memory fit on one device or on
a `repro_torch.mesh` device mesh, and the out-of-core path:

  Driver   — sample λ records (Parker–Hall), run plain FCM *and* WFCMPB
             on the sample, time both, keep the faster one's centers
             (Flag).
  Combiner — (weighted) FCM over all records from those seeds.
  Reducer  — with one combiner summary, the reducer WFCM is a polish of
             the local sketch against itself, as in the reference; its
             objective is what ``BigFCMResult.objective`` holds there too.

**Out of core**: passing a `repro_torch.data.cache.ChunkStore` instead
of an array — or calling `bigfcm_fit_store` directly — runs the same
structure over a dataset that need not fit on the card.  Combiners
consume chunk shards from a deterministic
`repro_torch.data.plane.PartitionPlan`; each local fit is the
multi-pass `repro_torch.core.outofcore.ooc_fcm` when the driver race
picks FCM, or the single-pass `wfcmpb_store` progression when it picks
WFCMPB; the reducer is the flat merge plan over the shard summaries,
then one chunk pass gives the global objective.  Batches reach the card
through one `StagingRing` per fit (pinned host buffers, ``non_blocking``
copies).

The sweep implementation is ``cfg.backend`` (a `SweepBackend` name, or
"auto": ``hopper`` on a CUDA device, ``torch`` on the CPU), resolved once
and threaded to the driver, combiner and reducer.

Randomness: the reference draws the sample and the seeds from
`jax.random`.  Here both come from ``np.random.default_rng(cfg.seed)``
(`choice(n, λ)` then `choice(λ, C)`, O(λ) memory however large n is)
unless the caller injects them (``sample_idx=``, ``seed_idx=``), which is
how the tests hand both packages the same draws; the in-memory and the
store fit of the same data draw the same rows.

Instrumentation (`repro_torch.obs`, the reference's names): an
``engine.fit`` span over the in-memory fit or ``engine.fit_store`` over
the store fit (never both), ``engine.combiner`` and ``engine.merge``
spans inside the latter, and ``engine.driver_race`` /
``engine.fit.done`` events.  The spans read the host clock only; each
ends after its fit's sweeps have read ΔV² back from the card.

**On a mesh** (``mesh=``, a `repro_torch.mesh.make_mesh` mesh of more
than one rank; every rank calls `bigfcm_fit` with the same arguments):
each rank holds the global ``x`` in host memory, as the reference's
``device_put`` receives it, and moves only its ``P(data_axes)`` row block
(and its ``point_weights`` block) to its device.  The decisions that pick
a branch are rank 0's, broadcast: "auto"'s backend and the driver race
(timed on the wall clock, it could go either way on two ranks).  Each
rank's combiner converges with no collective inside its loop; then the
(P·C) centers and masses are gathered and every rank runs the reducer
plan over them (``cfg.hierarchical`` with a ``"pod"`` axis: within each
pod first, seeded with the rank's own local centers, then across pods —
ranks then hold different answers, and rank 0's, the one the reference
returns from its first device, is broadcast).  The global objective is
K1's q on each block, the partials added in rank order.  A 1-rank mesh
takes the single-device branch, as the reference does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..data.cache import ChunkStore
from ..data.plane import PartitionPlan, batched, plan_partitions, \
    shard_batches
from ..device import (as_real, copy_real, real_dtype, resolve_device,
                      synchronize)
from ..engine import MergePlan, Summary, merge_summaries, resolve_backend
from ..mesh import (agreed_backend, all_gather, broadcast_first, is_first,
                    mesh_size, psum, rank_device, shard_rows)
from .fcm import fcm
from .outofcore import StagingRing, make_accumulator, ooc_accumulate, \
    ooc_fcm
from .sampling import parker_hall_sample_size
from .wfcmpb import wfcmpb, wfcmpb_store


@dataclasses.dataclass(frozen=True)
class BigFCMConfig:
    n_clusters: int
    m: float = 2.0
    driver_eps: float = 5e-11      # Table 2: tight driver ε ⇒ 6× total win
    combiner_eps: float = 1e-8
    reducer_eps: float = 5e-11
    max_iter: int = 1000
    alpha: float = 0.05            # Parker–Hall confidence
    r: float = 0.10                # Parker–Hall relative class difference
    sample_size: Optional[int] = None   # override Eq. (4) if set
    block_size: int = 2048         # WFCMPB block size
    hierarchical: bool = False     # two-level reduce over ('data') then ('pod')
    backend: str = "auto"          # engine sweep backend (torch/hopper/...)
    use_driver: bool = True        # False = random seeds (Table 2 baseline)
    seed: int = 0

    def reducer_plan(self) -> MergePlan:
        """The reducer's merge plan (paper line 13 seeds with V_1)."""
        return MergePlan("flat", seed="first", m=self.m,
                         eps=self.reducer_eps, max_iter=self.max_iter)


class BigFCMDiagnostics(NamedTuple):
    flag: bool                 # True ⇒ plain FCM won the driver race
    t_fcm_driver: float        # seconds — driver FCM on the sample
    t_wfcmpb_driver: float     # seconds — driver WFCMPB on the sample
    sample_size: int
    combiner_iters: Tuple[int, ...]  # per-combiner local iteration counts
                                     # (on a mesh: gathered, block order)
    reducer_iters: int


class BigFCMResult(NamedTuple):
    centers: torch.Tensor         # (C, d) — V_final
    center_weights: torch.Tensor  # (C,)
    objective: torch.Tensor       # () one shard: the reducer's objective;
                                  # several, or a mesh: the global one
    diagnostics: BigFCMDiagnostics


# ---------------------------------------------------------------- driver ---

def _rows(x, idx):
    """Rows ``idx`` (any integer array-like) of a tensor, or of a host
    array (a memmap reads only those rows)."""
    idx = np.asarray(idx, dtype=np.int64)
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device)]
    return x[idx]


def _timed(device, f):
    """Wall time of ``f()`` with the card synchronized on both sides."""
    synchronize(device)
    t0 = time.perf_counter()
    res = f()
    synchronize(device)
    return res, time.perf_counter() - t0


def run_driver(x_sample, cfg: BigFCMConfig, *, seed_idx=None,
               device: Union[str, torch.device] = "cuda"):
    """Pre-cluster the sample; race FCM vs WFCMPB (paper lines 1–6).

    ``seed_idx`` (C,) picks the seed rows of the sample; by default they
    are drawn from ``np.random.default_rng(cfg.seed)``.  Returns
    ``(v_init, flag, t_fcm, t_wfcmpb)``."""
    dev = resolve_device(device)
    x_sample = as_real(x_sample, dev)
    c = cfg.n_clusters
    if seed_idx is None:
        seed_idx = np.random.default_rng(cfg.seed).choice(
            x_sample.shape[0], c, replace=False)
    seeds = _rows(x_sample, seed_idx)
    be = resolve_backend(cfg.backend, device=dev,
                         shape=(x_sample.shape[0], c, x_sample.shape[1]))

    def f_fcm():
        return fcm(x_sample, seeds, m=cfg.m, eps=cfg.driver_eps,
                   max_iter=cfg.max_iter, backend=be, device=dev)

    def f_pb():
        return wfcmpb(x_sample, seeds, m=cfg.m, eps=cfg.driver_eps,
                      max_iter=cfg.max_iter, block_size=cfg.block_size,
                      backend=be, device=dev)

    # Warm up outside the race (Hadoop's JVM is warm too).
    _timed(dev, f_fcm)
    _timed(dev, f_pb)
    res_fcm, t_s = _timed(dev, f_fcm)
    res_pb, t_f = _timed(dev, f_pb)

    flag = t_f - t_s > 0         # paper line 6: Flag=1 ⇒ FCM to the cache
    obs.event("engine.driver_race", flag=bool(flag), t_fcm=t_s,
              t_wfcmpb=t_f, backend=be.name,
              sample_rows=int(x_sample.shape[0]))
    v_init = res_fcm.centers if flag else res_pb.centers
    return v_init, flag, t_s, t_f


def _draws(cfg: BigFCMConfig, n: int, sample_idx, seed_idx):
    """(λ, sample_idx, seed_idx): the injected draws, or the missing ones
    from ``np.random.default_rng(cfg.seed)`` — the sample first, then the
    seed rows within it.  `Generator.choice` without replacement draws
    λ ≪ n indices in O(λ) memory, so a store of any size is sampled
    without an O(n) permutation."""
    lam = cfg.sample_size or parker_hall_sample_size(
        cfg.n_clusters, cfg.r, cfg.alpha)
    lam = min(lam, n)
    rng = np.random.default_rng(cfg.seed)
    if sample_idx is None:
        sample_idx = rng.choice(n, lam, replace=False)
    if seed_idx is None:
        seed_idx = rng.choice(lam, cfg.n_clusters, replace=False)
    return lam, np.asarray(sample_idx, np.int64), np.asarray(seed_idx,
                                                             np.int64)


def _initial_centers(x_sample, cfg: BigFCMConfig, seed_idx, dev):
    """Driver race (lines 1–6), or the Table-2 random-seed ablation —
    shared by the in-memory and out-of-core fits."""
    if cfg.use_driver:
        return run_driver(x_sample, cfg, seed_idx=seed_idx, device=dev)
    return _rows(x_sample, seed_idx), True, 0.0, 0.0


def driver_seeds(store: ChunkStore, cfg: BigFCMConfig, *, sample_idx=None,
                 seed_idx=None,
                 device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """The driver's seed centers from a store with zero coordination —
    the fleet entry point.

    Every fleet host calls this independently and must land on the same
    seeds, so the wall-clock race of `run_driver` cannot apply: the race
    is pinned to Flag=1 (plain FCM pre-clustering of the sample, the
    paper's common case) — same sample (`store.take` of the same
    indices), same seeds, same sweeps.  With ``cfg.use_driver=False``
    this is the Table-2 random-seed ablation.  Draws as `bigfcm_fit`."""
    dev = resolve_device(device)
    _, sample_idx, seed_idx = _draws(cfg, store.n_rows, sample_idx,
                                     seed_idx)
    x_sample = as_real(store.take(sample_idx), dev)
    seeds = _rows(x_sample, seed_idx)
    if not cfg.use_driver:
        return seeds.cpu().numpy()
    be = resolve_backend(cfg.backend, device=dev,
                         shape=(x_sample.shape[0], cfg.n_clusters,
                                store.dim))
    res = fcm(x_sample, seeds, m=cfg.m, eps=cfg.driver_eps,
              max_iter=cfg.max_iter, backend=be, device=dev)
    return res.centers.cpu().numpy()


# ------------------------------------------------------------------ fit ---

def bigfcm_fit(
    x,
    cfg: BigFCMConfig,
    *,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    point_weights=None,
    sample_idx=None,
    seed_idx=None,
    device: Union[str, torch.device] = "cuda",
) -> BigFCMResult:
    """Cluster ``x`` (N, d) with BigFCM on one device or on ``mesh``.

    ``sample_idx`` (λ,) and ``seed_idx`` (C,) inject the driver sample's
    row indices and the seed rows within the sample; by default both are
    drawn from ``np.random.default_rng(cfg.seed)``.

    On a mesh of several ranks (module note) ``x`` and ``point_weights``
    are the global arrays, split into ``P(data_axes)`` row blocks (N must
    divide), and the fit runs on each rank's device (`rank_device`);
    ``device`` is not read.

    ``x`` may also be a `ChunkStore`, in which case the fit runs the
    out-of-core path (`bigfcm_fit_store`, one shard)."""
    if isinstance(x, ChunkStore):
        if mesh is not None or point_weights is not None:
            raise ValueError(
                "bigfcm_fit over a ChunkStore is the out-of-core path: "
                "mesh/point_weights are not supported — materialize the "
                "store for the in-memory path, or call bigfcm_fit_store "
                "for shard-planned control")
        return bigfcm_fit_store(x, cfg, sample_idx=sample_idx,
                                seed_idx=seed_idx, device=device)
    # The whole in-memory fit is one `engine.fit` span (the store
    # delegation above gets its own `engine.fit_store`: never both).
    with obs.span("engine.fit", rows=int(x.shape[0])):
        if mesh is not None and mesh_size(mesh) > 1:
            return _fit_mesh(x, cfg, mesh, tuple(data_axes), point_weights,
                             sample_idx, seed_idx)
        if mesh is not None:            # 1 rank ≡ the single-device branch
            device = rank_device(mesh)
        return _fit_array(x, cfg, point_weights, sample_idx, seed_idx,
                          device)


def _fit_array(x, cfg: BigFCMConfig, point_weights, sample_idx, seed_idx,
               device) -> BigFCMResult:
    dev = resolve_device(device)
    x = as_real(x, dev)
    n = x.shape[0]
    be = resolve_backend(cfg.backend, device=dev,
                         shape=(n, cfg.n_clusters, x.shape[1]))

    lam, sample_idx, seed_idx = _draws(cfg, n, sample_idx, seed_idx)
    x_sample = _rows(x, sample_idx)
    v_init, flag, t_s, t_f = _initial_centers(x_sample, cfg, seed_idx, dev)

    w = (torch.ones((n,), dtype=x.dtype, device=dev)
         if point_weights is None else as_real(point_weights, dev))
    local = fcm(x, v_init, m=cfg.m, eps=cfg.combiner_eps,
                max_iter=cfg.max_iter, point_weights=w, backend=be,
                device=dev)
    # Degenerate reduce (one combiner summary): the reducer WFCM is just a
    # polish of the local sketch against itself.
    red = fcm(local.centers, local.centers, m=cfg.m, eps=cfg.reducer_eps,
              max_iter=cfg.max_iter, point_weights=local.center_weights,
              backend=be, device=dev)
    diag = BigFCMDiagnostics(bool(flag), t_s, t_f, lam, (local.n_iter,),
                             red.n_iter)
    if obs.enabled():
        obs.event("engine.fit.done", backend=be.name, path="memory",
                  flag=bool(flag), objective=float(red.objective),
                  combiner_iters=int(local.n_iter),
                  reducer_iters=int(red.n_iter))
    return BigFCMResult(red.centers, red.center_weights, red.objective, diag)


def _combine_reduce(x_l, w_l, v_init, *, cfg: BigFCMConfig, flag: bool, be,
                    mesh, data_axes, dev):
    """One rank's share of the job: its combiner, then the gathered
    summaries through the reducer plan (once, or per hierarchy level);
    returns (centers, masses, the local combiner's sweeps, reducer
    sweeps).  Under the hierarchy the result is rank 0's, broadcast."""
    if flag:
        local = fcm(x_l, v_init, m=cfg.m, eps=cfg.combiner_eps,
                    max_iter=cfg.max_iter, point_weights=w_l, backend=be,
                    device=dev)
    else:
        local = wfcmpb(x_l, v_init, m=cfg.m, eps=cfg.combiner_eps,
                       max_iter=cfg.max_iter, block_size=cfg.block_size,
                       point_weights=w_l, backend=be, device=dev)
    plan = cfg.reducer_plan()

    def gather_merge(summary: Summary, axes, init):
        gathered = Summary(all_gather(summary.centers, mesh, axes),
                           all_gather(summary.masses, mesh, axes))
        # ``init`` carries the hierarchy level's explicit seed; the flat
        # plan's seed="first" (V_1, paper line 13) applies when None.
        return merge_summaries(gathered, plan, backend=be, init=init)

    local_sum = Summary(local.centers, local.center_weights)
    pod_axis = "pod" if "pod" in mesh.mesh_dim_names else None
    if cfg.hierarchical and pod_axis is not None:
        inner_axes = tuple(a for a in data_axes if a != pod_axis)
        mid = gather_merge(local_sum, inner_axes, local.centers)
        red = gather_merge(mid.summary, (pod_axis,), mid.summary.centers)
        return (broadcast_first(red.summary.centers, mesh),
                broadcast_first(red.summary.masses, mesh), local.n_iter,
                broadcast_first(int(red.n_iter), mesh))
    red = gather_merge(local_sum, data_axes, None)
    return red.summary.centers, red.summary.masses, local.n_iter, red.n_iter


def _fit_mesh(x, cfg: BigFCMConfig, mesh, data_axes, point_weights,
              sample_idx, seed_idx) -> BigFCMResult:
    dev = rank_device(mesh)
    n, d, c = int(x.shape[0]), int(x.shape[1]), cfg.n_clusters
    x_l = copy_real(shard_rows(x, mesh, data_axes), dev)
    w_l = (torch.ones((x_l.shape[0],), dtype=x_l.dtype, device=dev)
           if point_weights is None
           else copy_real(shard_rows(point_weights, mesh, data_axes), dev))
    lam, sample_idx, seed_idx = _draws(cfg, n, sample_idx, seed_idx)
    # The decisions that pick a branch are rank 0's, broadcast: "auto"'s
    # backend and the driver's wall-clock race.
    be = agreed_backend(cfg.backend, mesh, shape=(n, c, d))
    v_init = torch.empty((c, d), dtype=real_dtype(), device=dev)
    race = None
    if is_first(mesh):
        x_sample = copy_real(_rows(x, sample_idx), dev)
        v_init, flag, t_s, t_f = _initial_centers(x_sample, cfg, seed_idx,
                                                  dev)
        race = (bool(flag), float(t_s), float(t_f))
    v_init = broadcast_first(v_init.contiguous(), mesh)
    flag, t_s, t_f = broadcast_first(race, mesh)

    centers, masses, it, r_it = _combine_reduce(
        x_l, w_l, v_init, cfg=cfg, flag=flag, be=be, mesh=mesh,
        data_axes=data_axes, dev=dev)
    # Global objective of the final centers over the full dataset — the
    # accumulate entry's q output (Σ w·u^m·d²), added in rank order.
    _, _, q_l = be.accumulate(x_l, w_l, centers, cfg.m)
    q = psum(q_l, mesh, data_axes)
    iters = tuple(int(i) for i in all_gather(
        torch.tensor(it, device=dev), mesh, data_axes).tolist())
    if obs.enabled():
        obs.event("engine.fit.done", backend=be.name, path="mesh",
                  flag=bool(flag), objective=float(q),
                  reducer_iters=int(r_it))
    diag = BigFCMDiagnostics(bool(flag), t_s, t_f, lam, iters, int(r_it))
    return BigFCMResult(centers, masses, q, diag)


# ------------------------------------------------------- out-of-core fit ---

def bigfcm_fit_store(
    store: ChunkStore,
    cfg: BigFCMConfig,
    *,
    n_shards: int = 1,
    plan: Optional[PartitionPlan] = None,
    batch_rows: Optional[int] = None,
    sample_idx=None,
    seed_idx=None,
    device: Union[str, torch.device] = "cuda",
) -> BigFCMResult:
    """BigFCM over a `ChunkStore` that need not fit on the card.

    The paper's structure, host-orchestrated over the chunk cache:

      Driver   — the Parker–Hall sample gathered by global row index
                 (`store.take`), the same draws, race and seeds as the
                 in-memory `bigfcm_fit`.
      Combiner — one per `PartitionPlan` shard (default: one shard = the
                 whole store).  Multi-pass `ooc_fcm` when the race picks
                 FCM — every iteration streams the shard's chunks
                 through the backend's raw-accumulate entry and
                 normalizes once — or single-pass `wfcmpb_store` when it
                 picks WFCMPB.
      Reducer  — the flat merge plan over the shard summaries (the
                 degenerate self-polish for one shard), then, with
                 several shards, one chunk pass for the global objective.

    ``batch_rows`` (default: the store's chunk size) is the device
    working set: peak device memory is O(batch_rows·d + C·d) however
    large the store is (two staged batches, `StagingRing`).  One shard
    mirrors the in-memory single-device branch exactly — the multi-pass
    FCM combiner *whatever the flag* (that branch ignores the race too)
    plus the same degenerate self-polish, whose objective it returns —
    so a store that *does* fit reproduces `bigfcm_fit` on the
    materialized array to float32 summation order; the WFCMPB combiner
    applies on multi-shard plans, which return the global objective.
    """
    with obs.span("engine.fit_store", rows=int(store.n_rows)):
        return _fit_store(store, cfg, n_shards, plan, batch_rows,
                          sample_idx, seed_idx, device)


def _fit_store(store: ChunkStore, cfg: BigFCMConfig, n_shards, plan,
               batch_rows, sample_idx, seed_idx, device) -> BigFCMResult:
    dev = resolve_device(device)
    n = store.n_rows
    be = resolve_backend(cfg.backend, device=dev,
                         shape=(n, cfg.n_clusters, store.dim))
    lam, sample_idx, seed_idx = _draws(cfg, n, sample_idx, seed_idx)
    x_sample = as_real(store.take(sample_idx), dev)
    v_init, flag, t_s, t_f = _initial_centers(x_sample, cfg, seed_idx, dev)

    if plan is None:
        # more shards than chunks would leave empty combiners — clamp
        plan = plan_partitions(store, min(n_shards, store.n_chunks))
    rows = int(batch_rows or store.chunk_rows)
    shards = [s for s in range(plan.n_shards) if plan.shard_rows[s] > 0]
    if not shards:
        raise ValueError("bigfcm_fit_store: partition plan has no "
                         "non-empty shard")
    acc = make_accumulator(be, cfg.m)  # one dispatch for every shard/pass
    ring = StagingRing(dev) if dev.type == "cuda" else None
    locals_ = []
    for s in shards:                   # empty shards contribute nothing
        with obs.span("engine.combiner", shard=s):
            if flag or len(shards) == 1:  # 1 shard ≡ single-device branch
                loc = ooc_fcm(
                    lambda s=s: shard_batches(store, plan, s, rows),
                    v_init, m=cfg.m, eps=cfg.combiner_eps,
                    max_iter=cfg.max_iter, backend=be, acc=acc, ring=ring,
                    device=dev)
            else:
                loc = wfcmpb_store(store, v_init, m=cfg.m,
                                   eps=cfg.combiner_eps,
                                   max_iter=cfg.max_iter, batch_rows=rows,
                                   backend=be, plan=plan, shard=s,
                                   with_objective=False, ring=ring,
                                   device=dev)
        locals_.append(loc)
    iters = tuple(loc.n_iter for loc in locals_)

    if len(locals_) == 1:
        # Degenerate reduce (one combiner summary): the reducer WFCM is a
        # polish of the local sketch against itself — identical to the
        # in-memory single-device branch.
        local = locals_[0]
        with obs.span("engine.merge", shards=1):
            red = fcm(local.centers, local.centers, m=cfg.m,
                      eps=cfg.reducer_eps, max_iter=cfg.max_iter,
                      point_weights=local.center_weights, backend=be,
                      device=dev)
        if obs.enabled():
            obs.event("engine.fit.done", backend=be.name, path="store",
                      flag=bool(flag), objective=float(red.objective),
                      reducer_iters=int(red.n_iter))
        diag = BigFCMDiagnostics(bool(flag), t_s, t_f, lam, iters,
                                 red.n_iter)
        return BigFCMResult(red.centers, red.center_weights, red.objective,
                            diag)

    stacked = Summary(torch.stack([loc.centers for loc in locals_]),
                      torch.stack([loc.center_weights for loc in locals_]))
    with obs.span("engine.merge", shards=len(locals_)):
        red = merge_summaries(stacked, cfg.reducer_plan(), backend=be)
    # Global objective of the merged centers over the full store — one
    # more chunk pass through the raw accumulate entry (the q output).
    _, _, q = ooc_accumulate(batched(store.iter_chunks(), rows),
                             red.summary.centers, cfg.m, acc=acc, ring=ring,
                             device=dev)
    if obs.enabled():
        obs.event("engine.fit.done", backend=be.name, path="store",
                  flag=bool(flag), objective=float(q),
                  reducer_iters=int(red.n_iter))
    diag = BigFCMDiagnostics(bool(flag), t_s, t_f, lam, iters, red.n_iter)
    return BigFCMResult(red.summary.centers, red.summary.masses, q, diag)
