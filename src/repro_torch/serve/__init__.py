"""`repro_torch.serve` — scoring against fitted models.

Counterpart of `repro.serve`.  This slice holds the tenant plane's
gather-scored `TenantScorer`; the single-model `Scorer`, the coalescing
`ScoringService` and its tenant-routed front end come with later
slices.
"""
from .tenant import TenantScorer, TenantSnapshot, tenant_snapshot

__all__ = ["TenantScorer", "TenantSnapshot", "tenant_snapshot"]
