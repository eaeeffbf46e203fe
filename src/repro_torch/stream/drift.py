"""Distribution-drift detection for the streaming clustering loop.

The port's own copy of `repro.stream.drift` (numpy-only; `repro_torch`
imports nothing of `repro`): the same statistics, thresholds and
checkpoint arrays.

Two cheap statistics, both already computed (or nearly free) on the
ingest path, each tracked against its own EWMA exactly like
`repro.ft.elastic.StragglerMonitor` tracks step times:

  * **objective excess** — the fuzzy objective of the *current* global
    centers evaluated on the incoming batch, normalized per unit record
    mass.  Under a stationary stream this hovers around a constant; when
    the generating distribution moves, the stale centers mis-fit the new
    batch and the statistic jumps immediately (before any re-fit).
  * **center shift** — how far the freshly merged windowed centers moved
    from the previous global centers (max per-center L2).  Stationary
    streams jitter at the sampling-noise scale; a regime change drags
    the merge toward the new mass and the shift spikes.

A batch is flagged as drift when either statistic exceeds
``threshold × EWMA`` after ``min_batches`` of warm-up.  Flagged batches
do NOT update the EWMAs (one drift must not mask the next), mirroring
the straggler monitor's outlier-exclusion rule.

A third statistic separates *partial* from *global* regime change (the
cluster-birth path): the **residual scale** — the median over the batch
of each record's min squared distance to the current centers — gets its
own EWMA.  Records whose residual exceeds ``resid_ratio ×`` that EWMA
are *outliers* (mass the current model cannot explain); when the
outlier mass fraction is small the right response is to spawn ONE new
center from those records (`StreamingBigFCM` birth), and only when most
of the batch is outlying (``> reseed_frac``) does an objective-drift
flag escalate to the full driver re-seed.

Detector state is four scalars, exported as arrays so it checkpoints
inside the `repro_torch.stream.StreamingBigFCM` state tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    alpha: float = 0.2           # EWMA smoothing
    q_threshold: float = 2.0     # objective-excess ratio that flags drift
    shift_threshold: float = 5.0  # center-shift ratio that flags drift
    min_batches: int = 3         # EWMA warm-up before flagging
    shift_floor: float = 1e-6    # ignore shift ratios off a ~zero EWMA
    resid_ratio: float = 8.0     # outlier = residual > ratio × EWMA median
    birth_min_frac: float = 0.04  # outlier mass fraction that births a center
    reseed_frac: float = 0.5     # outlier fraction above which drift → reseed


class DriftDetector:
    """Host-side ratio detector over (objective, center-shift) streams."""

    def __init__(self, cfg: DriftConfig = DriftConfig()):
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        self.ewma_q: Optional[float] = None
        self.ewma_shift: Optional[float] = None
        self.ewma_resid: Optional[float] = None
        self.n = 0

    # ------------------------------------------------------------ checks --
    def objective_drifted(self, q_norm: float) -> bool:
        return (self.n >= self.cfg.min_batches
                and self.ewma_q is not None
                and math.isfinite(q_norm)
                and q_norm > self.cfg.q_threshold * self.ewma_q)

    def shift_drifted(self, shift: float) -> bool:
        return (self.n >= self.cfg.min_batches
                and self.ewma_shift is not None
                and shift > self.cfg.shift_threshold
                * max(self.ewma_shift, self.cfg.shift_floor))

    def outlier_threshold(self) -> Optional[float]:
        """Residual above which a record is an outlier (mass the current
        centers cannot explain); None until the residual EWMA warms up."""
        if self.n < self.cfg.min_batches or self.ewma_resid is None:
            return None
        return self.cfg.resid_ratio * self.ewma_resid

    # ----------------------------------------------------------- observe --
    def observe(self, q_norm: float, shift: float, drifted: bool,
                resid_med: Optional[float] = None) -> None:
        """Fold this batch into the EWMAs (skipped when flagged)."""
        if drifted:
            return
        a = self.cfg.alpha
        self.ewma_q = (q_norm if self.ewma_q is None
                       else (1 - a) * self.ewma_q + a * q_norm)
        self.ewma_shift = (shift if self.ewma_shift is None
                           else (1 - a) * self.ewma_shift + a * shift)
        if resid_med is not None and math.isfinite(resid_med):
            self.ewma_resid = (resid_med if self.ewma_resid is None
                               else (1 - a) * self.ewma_resid
                               + a * resid_med)
        self.n += 1

    # -------------------------------------------------------- checkpoint --
    def state_arrays(self) -> Dict[str, np.ndarray]:
        nan = float("nan")
        return {
            "ewma_q": np.float32(nan if self.ewma_q is None else self.ewma_q),
            "ewma_shift": np.float32(
                nan if self.ewma_shift is None else self.ewma_shift),
            "ewma_resid": np.float32(
                nan if self.ewma_resid is None else self.ewma_resid),
            "n": np.int32(self.n),
        }

    def load_state_arrays(self, tree: Dict[str, np.ndarray]) -> None:
        q = float(np.asarray(tree["ewma_q"]))
        s = float(np.asarray(tree["ewma_shift"]))
        r = float(np.asarray(tree["ewma_resid"]))
        self.ewma_q = None if math.isnan(q) else q
        self.ewma_shift = None if math.isnan(s) else s
        self.ewma_resid = None if math.isnan(r) else r
        self.n = int(np.asarray(tree["n"]))
