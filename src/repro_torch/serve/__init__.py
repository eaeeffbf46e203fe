"""`repro_torch.serve` — scoring against fitted and live models.

Counterpart of `repro.serve`.  This slice holds the frozen-snapshot
scorer (`make_assigner`), out-of-core store scoring (`assign_store`),
scoring against a live streaming model (`assign_stream`), and the tenant
plane's gather-scored `TenantScorer`; the single-model `Scorer` and
`SnapshotPublisher`, the coalescing `ScoringService` and its
tenant-routed front end come with later slices.
"""
from .cluster import assign_store, assign_stream, make_assigner
from .tenant import TenantScorer, TenantSnapshot, tenant_snapshot

__all__ = ["assign_store", "assign_stream", "make_assigner", "TenantScorer",
           "TenantSnapshot", "tenant_snapshot"]
