"""`TenantSet` — thousands of small models as one stacked object.

Counterpart of `repro.tenant.core`, of which it is the port's own copy
(that module is numpy-only, but `repro_torch` imports nothing of
`repro`).  Many small per-cohort models (per-user personalization,
per-region segments) are fit and served as one stack:

  * ``centers`` (T, C, d) / ``weights`` (T, C): every tenant's model in
    one stacked array, fit by `repro_torch.tenant.fit_tenants` and
    served by one gather-scored call (`repro_torch.serve.TenantScorer`);
  * ``ids`` — tenant identifiers (coerced to ``str``); row ``t`` of
    every stacked array belongs to ``ids[t]``;
  * ``versions`` (T,) — the per-tenant snapshot version a serving plane
    reports per response.

The stacked checkpoint (`save_tenants` / `load_tenants`) stores the
whole stack as one checkpoint of `repro_torch.ft.CheckpointManager`, in
the reference's leaf names, so either package restores the other's.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, \
    Tuple, Union

import numpy as np

__all__ = ["TenantData", "TenantSet", "load_tenants",
           "normalize_tenant_data", "save_tenants", "tenant_set"]


class TenantSet(NamedTuple):
    """T per-tenant (centers, weights) models stacked on a leading axis."""
    ids: Tuple[str, ...]       # (T,) tenant identifiers (str)
    centers: np.ndarray        # (T, C, d) float32
    weights: np.ndarray        # (T, C)    float32 — fuzzy masses
    versions: np.ndarray       # (T,) int64 — serving snapshot versions
    objective: np.ndarray      # (T,) float32 — per-tenant Eq. (2)
    n_iter: np.ndarray         # (T,) int32  — per-tenant sweeps to converge

    @property
    def n_tenants(self) -> int:
        return len(self.ids)

    @property
    def n_clusters(self) -> int:
        return int(self.centers.shape[1])

    @property
    def dim(self) -> int:
        return int(self.centers.shape[2])

    def index(self, tenant) -> int:
        """Row of ``tenant`` in the stack (ids are coerced to str)."""
        try:
            return self.ids.index(str(tenant))
        except ValueError:
            raise KeyError(f"unknown tenant {tenant!r}") from None

    def select(self, tenants: Iterable) -> "TenantSet":
        """A sub-stack holding ``tenants`` in the requested order."""
        rows = [self.index(t) for t in tenants]
        return TenantSet(tuple(self.ids[r] for r in rows),
                         self.centers[rows], self.weights[rows],
                         self.versions[rows], self.objective[rows],
                         self.n_iter[rows])

    def __repr__(self):
        return (f"<TenantSet T={self.n_tenants} C={self.n_clusters} "
                f"d={self.dim}>")


def tenant_set(ids: Sequence, centers, weights,
               versions: Optional[np.ndarray] = None,
               objective: Optional[np.ndarray] = None,
               n_iter: Optional[np.ndarray] = None) -> TenantSet:
    """Build a TenantSet coercing dtypes/defaults (versions→0 etc.)."""
    centers = np.asarray(centers, np.float32)
    weights = np.asarray(weights, np.float32)
    t = centers.shape[0]
    if centers.ndim != 3 or weights.shape != centers.shape[:2]:
        raise ValueError(f"stacked shapes disagree: centers "
                         f"{centers.shape}, weights {weights.shape}")
    if len(ids) != t:
        raise ValueError(f"{len(ids)} ids for {t} stacked models")
    sids = tuple(str(i) for i in ids)
    if len(set(sids)) != t:
        raise ValueError("tenant ids must be unique")
    return TenantSet(
        sids, centers, weights,
        np.zeros(t, np.int64) if versions is None
        else np.asarray(versions, np.int64),
        np.zeros(t, np.float32) if objective is None
        else np.asarray(objective, np.float32),
        np.zeros(t, np.int32) if n_iter is None
        else np.asarray(n_iter, np.int32))


# ---------------------------------------------------------- checkpointing ---

_LEAVES = ("tenant_ids", "tenant_centers", "tenant_weights",
           "tenant_versions", "tenant_objective", "tenant_n_iter")


def save_tenants(ckpt, step: int, ts: TenantSet) -> None:
    """Persist the whole tenant stack as ONE checkpoint — stacked leaves
    in the self-describing manifest (`ft.CheckpointManager.save`), so a
    1000-tenant fleet costs one manifest + six arrays, not 1000 files.
    Durable on return: the manager's async writer (if any) is drained so
    a `load_tenants` straight after cannot race the publish rename."""
    ckpt.save(step, dict(zip(_LEAVES, (
        np.asarray(ts.ids), ts.centers, ts.weights, ts.versions,
        ts.objective, ts.n_iter))))
    wait = getattr(ckpt, "wait", None)
    if wait is not None:
        wait()


def load_tenants(ckpt, step: Optional[int] = None,
                 tenants: Optional[Iterable] = None) -> TenantSet:
    """Template-free stacked restore: shapes come off the manifest, so
    ANY tenant count round-trips.  ``tenants`` restores just that subset
    (by id, in the requested order) — boot a shard of the fleet without
    materializing the rest."""
    step = step if step is not None else ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no tenant checkpoints in {ckpt.dir}")
    arrs = ckpt.restore_arrays(step, keys=_LEAVES)
    if "tenant_centers" not in arrs:
        raise KeyError(f"checkpoint step {step} holds no tenant stack "
                       f"(leaves: {sorted(arrs)})")
    ts = TenantSet(tuple(str(i) for i in arrs["tenant_ids"]),
                   np.asarray(arrs["tenant_centers"], np.float32),
                   np.asarray(arrs["tenant_weights"], np.float32),
                   np.asarray(arrs["tenant_versions"], np.int64),
                   np.asarray(arrs["tenant_objective"], np.float32),
                   np.asarray(arrs["tenant_n_iter"], np.int32))
    return ts if tenants is None else ts.select(tenants)


TenantData = Union[Dict, Sequence]


def normalize_tenant_data(data: TenantData
                          ) -> Tuple[Tuple[str, ...], List[np.ndarray]]:
    """Coerce tenant data into ``(ids, [x_t])``.

    Accepts a dict ``{id: (n_t, d) array}``, a sequence of ``(id, x)``
    pairs, or a bare sequence of arrays (ids become "0", "1", …).
    Every array must share ``d``; ids coerce to unique strings."""
    if isinstance(data, dict):
        items = list(data.items())
    else:
        items = [(p[0], p[1]) if isinstance(p, tuple) and len(p) == 2
                 and not isinstance(p[0], np.ndarray) else (i, p)
                 for i, p in enumerate(data)]
    if not items:
        raise ValueError("no tenants given")
    ids = tuple(str(i) for i, _ in items)
    if len(set(ids)) != len(ids):
        raise ValueError("tenant ids must be unique")
    xs = []
    dim = None
    for tid, x in items:
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or not x.shape[0]:
            raise ValueError(f"tenant {tid!r}: records must be "
                             f"(n>=1, d), got {x.shape}")
        if dim is None:
            dim = x.shape[1]
        elif x.shape[1] != dim:
            raise ValueError(f"tenant {tid!r}: dim {x.shape[1]} != "
                             f"{dim}")
        xs.append(x)
    return ids, xs
