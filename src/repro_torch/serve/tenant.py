"""Tenant-routed scoring — one gather-scored call for cross-tenant
traffic.

Counterpart of `repro.serve.tenant` (`TenantSnapshot`, `tenant_snapshot`,
`TenantScorer`):

  * `TenantSnapshot` — the immutable published fleet: stacked (T, C, d)
    centers on the device, per-tenant ``versions``, and the id→row
    index.  Hot-swap is one attribute store: each call reads the
    snapshot once, so every response is scored against exactly one
    version of its tenant.
  * `TenantScorer` — the gather-score: rows from different tenants
    come as one (B, d) batch with a (B,) tenant-row vector; each row is
    scored against its own tenant's centers (``centers[tidx]``), the
    direct ‖x − v‖², then argmin (or the membership degrees when
    ``soft``).

The reference's ``TenantScorer.traces`` counts XLA compiles of its
jitted program; the port runs eagerly and compiles nothing, so it keeps
no such count.  `TenantScoringService` (the coalescing front end) is
built on the scoring service and comes with its port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..device import as_real, resolve_device
from ..engine.backend import _u_from_d2
from ..tenant.core import TenantSet

__all__ = ["TenantSnapshot", "tenant_snapshot", "TenantScorer"]

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

    def score(self, x, tidx, snap: Optional[TenantSnapshot] = None
              ) -> torch.Tensor:
        """Gather-scored call on the snapshot's device: (B,) assignments,
        or (B, C) membership degrees when ``soft``."""
        snap = snap if snap is not None else self._snap
        dev = snap.centers.device
        x = as_real(x, dev)
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
