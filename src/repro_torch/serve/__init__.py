"""`repro_torch.serve` — scoring against fitted models.

Counterpart of `repro.serve`.  This slice holds the frozen-snapshot
scorer (`make_assigner`) and out-of-core store scoring (`assign_store`),
and the tenant plane's gather-scored `TenantScorer`; streaming
assignment (`assign_stream`), the single-model `Scorer`, the coalescing
`ScoringService` and its tenant-routed front end come with later
slices.
"""
from .cluster import assign_store, make_assigner
from .tenant import TenantScorer, TenantSnapshot, tenant_snapshot

__all__ = ["assign_store", "make_assigner", "TenantScorer",
           "TenantSnapshot", "tenant_snapshot"]
