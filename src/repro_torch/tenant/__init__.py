"""`repro_torch.tenant` — the multi-tenant plane.

Counterpart of `repro.tenant`: thousands of small FCM models (per-user,
per-cohort, per-region) as one stacked object (`TenantSet`):

  * `fit_tenants` — every tenant converges in one loop of tenant-stacked
    sweeps (`engine.fcm_converge_batched`), ragged row counts and tenant
    counts absorbed by the phantom-padding bucket ladder;
  * `repro_torch.serve.TenantScorer` — cross-tenant traffic scored in
    one gather-scored call.

`fit_tenants_looped` is the per-tenant baseline (same math, T fits);
`save_tenants` / `load_tenants` checkpoint the stack as one
`repro_torch.ft.CheckpointManager` step.
"""
from .core import (TenantSet, load_tenants, normalize_tenant_data,
                   save_tenants, tenant_set)
from .fit import (TenantFitConfig, fit_tenants, fit_tenants_looped,
                  pack_tenants, seed_centers)

__all__ = ["TenantSet", "load_tenants", "normalize_tenant_data",
           "save_tenants", "tenant_set",
           "TenantFitConfig", "fit_tenants", "fit_tenants_looped",
           "pack_tenants", "seed_centers"]
