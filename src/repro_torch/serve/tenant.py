"""Tenant-routed scoring — one gather-scored call for cross-tenant
traffic.

Counterpart of `repro.serve.tenant`:

  * `TenantSnapshot` — the immutable published fleet: stacked (T, C, d)
    centers on the device, per-tenant ``versions``, and the id→row
    index.  Hot-swap is one attribute store: each call reads the
    snapshot once, so every response is scored against exactly one
    version of its tenant.
  * `TenantScorer` — the gather-score: rows from different tenants
    come as one (B, d) batch with a (B,) tenant-row vector; each row is
    scored against its own tenant's centers (``centers[tidx]``), the
    direct ‖x − v‖², then argmin (or the membership degrees when
    ``soft``).  ``traces`` counts the distinct (rows, T, C) shapes
    scored, the reference's compile count.
  * `TenantScoringService` — `ScoringService` with tenant routing:
    ``submit(tenant, x)`` tags the request with its tenant id (also the
    fairness group — set ``ServiceConfig.max_group_rows`` so a hot
    tenant cannot starve a quiet one), and the dispatch pads
    cross-tenant batches onto the same bucket ladder.

Observability: dispatches run under ``span.tenant.assign`` with a
``tenants=<distinct-in-batch>`` label next to the base service's
counters.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..data.plane import bucket_for, pad_rows
from ..device import as_real, resolve_device
from ..engine.backend import _u_from_d2
from ..tenant.core import TenantSet
from .service import ScoreResult, ScoringService, ServiceConfig

__all__ = ["TenantSnapshot", "tenant_snapshot", "TenantScorer",
           "TenantScoringService"]

DeviceLike = Union[str, torch.device]


class TenantSnapshot(NamedTuple):
    """One immutable published tenant fleet (the never-tear unit)."""
    ids: Tuple[str, ...]          # (T,) tenant ids, row order
    versions: np.ndarray          # (T,) int64 per-tenant versions
    centers: torch.Tensor         # (T, C, d) device-resident stack
    index: dict                   # id → row

    @property
    def n_tenants(self) -> int:
        return len(self.ids)

    def row_of(self, tenant) -> int:
        try:
            return self.index[str(tenant)]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant!r} (fleet holds "
                           f"{len(self.ids)} tenants)") from None


def tenant_snapshot(ts: TenantSet, device: DeviceLike = "cuda"
                    ) -> TenantSnapshot:
    """Publishable snapshot of a fitted `TenantSet`: its centers land on
    ``device`` once, here; swaps and calls only pass the reference."""
    return TenantSnapshot(ts.ids, np.asarray(ts.versions, np.int64),
                          as_real(ts.centers, resolve_device(device)),
                          {t: i for i, t in enumerate(ts.ids)})


class TenantScorer:
    """A read replica over a hot-swappable `TenantSnapshot`.

    ``score(x (B, d), tidx (B,))`` scores row b against
    ``centers[tidx[b]]``: every tenant in the batch, one call."""

    def __init__(self, tenants: Union[TenantSet, TenantSnapshot], *,
                 m: float = 2.0, soft: bool = False, replica: str = "t0",
                 device: DeviceLike = "cuda"):
        self.replica = str(replica)
        self.m = float(m)
        self.soft = bool(soft)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._shapes = set()
        self._snap: Optional[TenantSnapshot] = None
        self.swap(tenants)

    def swap(self, tenants) -> None:
        """Publish a new fleet: one attribute store of an immutable
        snapshot.  A call in flight finishes against the snapshot it
        already read."""
        self._snap = (tenants if isinstance(tenants, TenantSnapshot)
                      else tenant_snapshot(tenants, self.device))

    def read(self) -> TenantSnapshot:
        return self._snap

    @property
    def dim(self) -> int:
        return int(self._snap.centers.shape[2])

    @property
    def traces(self) -> int:
        """Distinct (rows, T, C) shapes scored — the reference's count of
        (re)compiles of its jitted gather-score."""
        return len(self._shapes)

    def score(self, x, tidx, snap: Optional[TenantSnapshot] = None
              ) -> torch.Tensor:
        """Gather-scored call on the snapshot's device: (B,) assignments,
        or (B, C) membership degrees when ``soft``."""
        snap = snap if snap is not None else self._snap
        dev = snap.centers.device
        x = as_real(x, dev)
        shape = (int(x.shape[0]),) + tuple(snap.centers.shape[:2])
        if shape not in self._shapes:
            with self._lock:
                self._shapes.add(shape)
        v = snap.centers[torch.as_tensor(tidx, dtype=torch.long,
                                         device=dev)]        # (B, C, d)
        d2 = torch.sum((x[:, None, :] - v) ** 2, dim=-1)     # (B, C)
        return (_u_from_d2(d2, self.m) if self.soft
                else torch.argmin(d2, dim=-1))

    def assign(self, tenant, x):
        """Single-shot convenience: ``(assignments, version)`` for one
        tenant against exactly one snapshot."""
        snap = self._snap
        row = snap.row_of(tenant)
        x = np.atleast_2d(np.asarray(x, np.float32))
        with obs.span("tenant.assign", labels={"tenants": "1"},
                      rows=int(x.shape[0])):
            out = self.score(x, np.full((x.shape[0],), row, np.int64),
                             snap).cpu().numpy()
        return out, int(snap.versions[row])

    def __repr__(self):
        return (f"<TenantScorer {self.replica} T={self._snap.n_tenants} "
                f"soft={self.soft}>")


class TenantScoringService(ScoringService):
    """The coalescing front end with tenant routing.

    ``submit(tenant, x)`` / ``score(tenant, x)`` — requests across
    tenants land on ONE queue and coalesce into ONE gather-scored call
    per batch bucket; each response reports its own tenant's snapshot
    version (never torn).  The tenant id doubles as the fairness group:
    with ``cfg.max_group_rows`` set, `_take` caps any one tenant's rows
    per dispatch so FIFO coalescing cannot let a firehose tenant starve a
    quiet one."""

    def __init__(self, scorers: Union[TenantScorer, Sequence[TenantScorer]],
                 cfg: ServiceConfig = ServiceConfig()):
        scorers = ([scorers] if isinstance(scorers, TenantScorer)
                   else list(scorers))
        super().__init__(scorers, cfg)

    # -- client side -------------------------------------------------------

    def submit(self, tenant, x):
        """Enqueue one request for ``tenant``; resolves to a
        `ScoreResult` whose ``version`` is that tenant's snapshot
        version.  Unknown tenants fail fast here (against the current
        snapshot — a concurrent swap that removes the tenant before
        dispatch fails the future instead)."""
        self.scorers[0].read().row_of(tenant)     # fail-fast validation
        return super().submit(x, group=str(tenant))

    def score(self, tenant, x, timeout: Optional[float] = None
              ) -> ScoreResult:
        return self.submit(tenant, x).result(timeout)

    def swap(self, tenants) -> None:
        """Hot-swap every replica to a new fleet (TenantSet or ready
        TenantSnapshot) — one snapshot build, N atomic stores."""
        snap = (tenants if isinstance(tenants, TenantSnapshot)
                else tenant_snapshot(tenants, self.scorers[0].device))
        for s in self.scorers:
            s.swap(snap)

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, scorer, reqs) -> None:
        snap = scorer.read()          # ONE read: every row of every
        #                               bucket slice scores against this
        #                               fleet version
        rows = [snap.row_of(r.group) for r in reqs]
        x = (reqs[0].x if len(reqs) == 1
             else np.concatenate([r.x for r in reqs]))
        tidx = np.concatenate([np.full((r.n,), row, np.int64)
                               for r, row in zip(reqs, rows)])
        total = int(x.shape[0])
        distinct = len(set(rows))
        maxb = self.cfg.max_batch_rows
        outs = []
        for start in range(0, total, maxb):
            piece, tpiece = x[start:start + maxb], tidx[start:start + maxb]
            n = int(piece.shape[0])
            b = bucket_for(n, self._buckets) if self.cfg.coalesce else n
            xp = pad_rows(piece, b)
            # phantom rows score against row 0 and are sliced off
            tp = np.zeros((b,), np.int64)
            tp[:n] = tpiece
            with obs.span("tenant.assign",
                          labels={"tenants": str(distinct)},
                          rows=n, bucket=b, coalesced=len(reqs),
                          replica=scorer.replica):
                out = scorer.score(xp, tp, snap).cpu().numpy()
            outs.append(out[:n])
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        obs.counter("serve.records", replica=scorer.replica).add(total)
        obs.counter("serve.batches", replica=scorer.replica).add(1)
        off = 0
        done = time.perf_counter()
        for r, row in zip(reqs, rows):
            res = ScoreResult(out[off:off + r.n],
                              int(snap.versions[row]), scorer.replica)
            off += r.n
            obs.histogram("serve.request").observe(done - r.t_submit)
            obs.counter("serve.served", replica=scorer.replica).add(1)
            r.future.set_result(res)
