"""`repro_torch.tenant` — the multi-tenant plane.

Counterpart of `repro.tenant`: thousands of small FCM models (per-user,
per-cohort, per-region) as one stacked object (`TenantSet`):

  * `fit_tenants` — every tenant converges in one loop of tenant-stacked
    sweeps (`engine.fcm_converge_batched`), ragged row counts and tenant
    counts absorbed by the phantom-padding bucket ladder;
  * `repro_torch.serve.TenantScorer` — cross-tenant traffic scored in
    one gather-scored call.

`fit_tenants_looped` is the per-tenant baseline (same math, T fits).
The stacked checkpoint (`save_tenants` / `load_tenants`) comes with the
port of `ft.CheckpointManager`.
"""
from .core import TenantSet, normalize_tenant_data, tenant_set
from .fit import (TenantFitConfig, fit_tenants, fit_tenants_looped,
                  pack_tenants, seed_centers)

__all__ = ["TenantSet", "normalize_tenant_data", "tenant_set",
           "TenantFitConfig", "fit_tenants", "fit_tenants_looped",
           "pack_tenants", "seed_centers"]
