"""BigFCM (paper Algorithm 3), single device — the port's main path.

Counterpart of `repro.core.bigfcm`, in-memory single-device branch:

  Driver   — sample λ records (Parker–Hall), run plain FCM *and* WFCMPB
             on the sample, time both, keep the faster one's centers
             (Flag).
  Combiner — (weighted) FCM over all records from those seeds.
  Reducer  — with one combiner summary, the reducer WFCM is a polish of
             the local sketch against itself, as in the reference; its
             objective is what ``BigFCMResult.objective`` holds there too.

The sweep implementation is ``cfg.backend`` (a `SweepBackend` name, or
"auto": ``hopper`` on a CUDA device, ``torch`` on the CPU), resolved once
and threaded to the driver, combiner and reducer.

Randomness: the reference draws the sample and the seeds from
`jax.random`.  Here both come from ``np.random.default_rng(cfg.seed)``
unless the caller injects them (``sample_idx=``, ``seed_idx=``), which is
how the tests hand both packages the same draws.

Not in this slice: the device mesh (multi-GPU combiners) and the
out-of-core `ChunkStore` input; both raise `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..device import as_f32, resolve_device, synchronize
from ..engine import resolve_backend
from .fcm import fcm
from .sampling import parker_hall_sample_size
from .wfcmpb import wfcmpb


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
    objective: torch.Tensor       # () the reducer's objective (see module doc)
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
    x_sample = as_f32(x_sample, dev)
    c = cfg.n_clusters
    if seed_idx is None:
        seed_idx = np.random.default_rng(cfg.seed).choice(
            x_sample.shape[0], c, replace=False)
    seeds = _rows(x_sample, seed_idx)
    be = resolve_backend(cfg.backend, device=dev)

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
    v_init = res_fcm.centers if flag else res_pb.centers
    return v_init, flag, t_s, t_f


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
    drawn from ``np.random.default_rng(cfg.seed)``."""
    if mesh is not None:
        raise NotImplementedError(
            "bigfcm_fit on a device mesh (multi-GPU combiners) is not "
            "ported yet; it comes with the multi-GPU slice")
    if hasattr(x, "iter_chunks"):
        raise NotImplementedError(
            "bigfcm_fit over a ChunkStore (the out-of-core path) is not "
            "ported yet; it comes with the out-of-core slice")
    dev = resolve_device(device)
    x = as_f32(x, dev)
    n = x.shape[0]
    be = resolve_backend(cfg.backend, device=dev)

    lam = cfg.sample_size or parker_hall_sample_size(
        cfg.n_clusters, cfg.r, cfg.alpha)
    lam = min(lam, n)
    rng = np.random.default_rng(cfg.seed)
    if sample_idx is None:
        sample_idx = rng.choice(n, lam, replace=False)
    if seed_idx is None:
        seed_idx = rng.choice(lam, cfg.n_clusters, replace=False)
    x_sample = _rows(x, sample_idx)

    if cfg.use_driver:
        v_init, flag, t_s, t_f = run_driver(x_sample, cfg, seed_idx=seed_idx,
                                            device=dev)
    else:
        v_init = _rows(x_sample, seed_idx)
        flag, t_s, t_f = True, 0.0, 0.0

    w = (torch.ones((n,), dtype=torch.float32, device=dev)
         if point_weights is None else as_f32(point_weights, dev))
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
    return BigFCMResult(red.centers, red.center_weights, red.objective, diag)
