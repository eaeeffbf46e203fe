"""Elastic scaling and straggler mitigation — counterpart of
`repro.ft.elastic`.

`make_mesh_for` gives the reference's best-effort (pod, data, model)
mesh over the ranks a restarted job came back with, and
`elastic_remesh` re-blocks a live sharded state from one mesh onto
another over the same ranks — (2, 4) → (4, 2), say — by gathering each
leaf and cutting this rank's block under the same placement.  Where the
world itself shrank or grew, the ranks of the old mesh are gone and the
path is the checkpoint (`CheckpointManager.restore(shardings=)` onto the
new mesh), as the reference's docstring says: the port's
`elastic_remesh` does not move state between process groups.

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

import math
import statistics
import time
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

from .. import obs


def make_mesh_for(ranks: Sequence[int], *, model_parallel: int,
                  pods: int = 1, device_type: str = "cuda"):
    """Best-effort (pod, data, model) mesh over ``ranks`` of the current
    process group (an elastic restart may come back with fewer): model =
    gcd(``model_parallel``, n), data = n // (model · pods), the first
    pods · data · model of ``ranks`` laid row-major — the reference's
    rule over its devices; ("data", "model") when ``pods`` is 1."""
    from .. import mesh as M
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    model = math.gcd(int(model_parallel), n)
    data = n // (model * pods)
    if data < 1:
        raise ValueError(f"{n} ranks hold no ({pods}, data, {model}) mesh")
    if pods > 1:
        shape, names = (pods, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    return M.make_mesh(shape, names, device_type=device_type,
                       ranks=ranks[:pods * data * model])


def elastic_remesh(state, old_shardings, new_mesh):
    """Re-block a live sharded tree onto ``new_mesh`` (same placements):
    ``old_shardings`` = (old mesh, placement tree), ``state`` this rank's
    blocks under it; each leaf is gathered from the old mesh's ranks and
    this rank's block under the same placement on ``new_mesh`` kept (a
    gated leaf's columns paired).  Both meshes span the same ranks."""
    import torch.distributed as dist
    from .. import mesh as M
    from ..sharding.rules import block_of, put_block
    from .checkpoint import _rebuild, _sharded, global_shape
    old_mesh = old_shardings[0]
    if sorted(M.layout(old_mesh).ravel().tolist()) != \
            sorted(M.layout(new_mesh).ravel().tolist()):
        raise ValueError("elastic_remesh re-blocks between meshes over the "
                         "same ranks; a changed world restarts from the "
                         "checkpoint (CheckpointManager.restore(shardings=))")
    obs.counter("ft.elastic.remesh").add(1)
    obs.event("ft.elastic.remesh", n_devices=M.mesh_size(new_mesh))
    rank = dist.get_rank()
    axes = tuple(old_mesh.mesh_dim_names)
    members = M._members(old_mesh, axes)
    out = []
    for _, x, spec in _sharded(state, old_shardings):
        parts = M.all_gather(x.contiguous(), old_mesh, axes)
        full = x.new_empty(global_shape(x.shape, spec, old_mesh))
        for r, blk in zip(members, parts):
            put_block(full, blk, spec, old_mesh, r)
        out.append(block_of(full, spec, new_mesh, rank).clone())
        del full, parts
    return _rebuild(state, iter(out))


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
