"""Straggler mitigation, the single-host half of `repro.ft.elastic`.

Counterpart of `repro.ft.elastic`'s `detect_stragglers` and
`StragglerMonitor`, an own copy (stdlib and `repro_torch.obs` only).  The
mesh half (`make_mesh_for`, `elastic_remesh`) comes with the multi-GPU
slice.

`StragglerMonitor` implements the speculative-execution analogue: SPMD
steps are synchronous, so a straggling host shows up as a slow global
step.  The monitor keeps an EWMA of step times and flags outliers; the
launcher's policy is then (1) shrink the straggler's shard via the
weighted loader (BigFCM's weights make unequal shards *correct* — the
combiner weight of a smaller shard is proportionally smaller), or
(2) drop the node.  `detect_stragglers` is the fleet's row-normalized
rule (`repro_torch.fleet.sim`).  BigFCM additionally caps combiner
divergence with `max_iter` — a shard that won't converge cannot stall the
job by more than the iteration budget.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, List, Mapping, Optional, Tuple

from .. import obs


def detect_stragglers(
    inflight: Mapping[int, Tuple[float, int]],
    finished: Mapping[int, Tuple[float, int]],
    *,
    factor: float = 4.0,
    min_s: float = 0.5,
    min_finished: int = 2,
) -> List[int]:
    """Row-count-normalized straggler detection for phase-split fleets.

    ``inflight``/``finished`` map host id → ``(elapsed_seconds, rows)``
    where ``rows`` is the host's assigned row load from the partition
    plan (`PartitionPlan.shard_rows`) — a host with a bigger shard gets
    proportionally more time before being flagged, so uneven LPT splits
    don't read as stragglers.  A host is flagged when its per-row rate
    exceeds ``factor`` × the median finished per-row rate AND its raw
    elapsed time exceeds ``min_s`` (tiny fits never flag).  Requires at
    least ``min_finished`` finished hosts to establish the reference —
    before that, nothing is flagged.  Each flag bumps the same
    ``ft.straggler.flags`` counter `StragglerMonitor` uses.
    """
    refs = [dt / max(rows, 1) for dt, rows in finished.values()]
    if len(refs) < min_finished or not inflight:
        return []
    med = statistics.median(refs)
    out = []
    for h, (dt, rows) in sorted(inflight.items()):
        if dt > min_s and dt / max(rows, 1) > factor * max(med, 1e-12):
            out.append(h)
            obs.counter("ft.straggler.flags").add(1)
    return out


class StragglerMonitor:
    def __init__(self, *, alpha: float = 0.1, threshold: float = 1.5,
                 min_samples: int = 8,
                 on_straggler: Optional[Callable[[float, float], None]] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.ewma = None
        self.n = 0
        self.flags = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record a step; True if this step is a straggler outlier."""
        dt = time.perf_counter() - self._t0
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self.n >= self.min_samples
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.flags += 1
            obs.counter("ft.straggler.flags").add(1)
            if self.on_straggler:
                self.on_straggler(dt, self.ewma)
        # EWMA excludes flagged outliers so one straggler doesn't mask the
        # next.
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler
