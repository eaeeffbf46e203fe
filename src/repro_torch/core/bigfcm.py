"""BigFCM (paper Algorithm 3), single device — the port's main path.

Counterpart of `repro.core.bigfcm`, in-memory single-device branch and
out-of-core path:

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

Not in this slice: the device mesh (multi-GPU combiners), which raises
`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..data.cache import ChunkStore
from ..data.plane import PartitionPlan, batched, plan_partitions, \
    shard_batches
from ..device import as_real, resolve_device, synchronize
from ..engine import MergePlan, Summary, merge_summaries, resolve_backend
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
    reducer_iters: int


class BigFCMResult(NamedTuple):
    centers: torch.Tensor         # (C, d) — V_final
    center_weights: torch.Tensor  # (C,)
    objective: torch.Tensor       # () one shard: the reducer's objective;
                                  # several: the global one (module doc)
    diagnostics: BigFCMDiagnostics


# ---------------------------------------------------------------- driver ---

def _rows(x: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` (any integer array-like, host or numpy) of ``x``."""
    return x[torch.as_tensor(np.array(idx, dtype=np.int64), device=x.device)]


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
    point_weights=None,
    sample_idx=None,
    seed_idx=None,
    device: Union[str, torch.device] = "cuda",
) -> BigFCMResult:
    """Cluster ``x`` (N, d) with BigFCM on one device.

    ``sample_idx`` (λ,) and ``seed_idx`` (C,) inject the driver sample's
    row indices and the seed rows within the sample; by default both are
    drawn from ``np.random.default_rng(cfg.seed)``.

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
    if mesh is not None:
        raise NotImplementedError(
            "bigfcm_fit on a device mesh (multi-GPU combiners) is not "
            "ported yet; it comes with the multi-GPU slice")
    # The whole in-memory fit is one `engine.fit` span (the store
    # delegation above gets its own `engine.fit_store`: never both).
    with obs.span("engine.fit", rows=int(x.shape[0])):
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
