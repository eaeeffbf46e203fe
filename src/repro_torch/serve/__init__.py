"""`repro_torch.serve` — scoring against fitted and live models.

Counterpart of `repro.serve`: the frozen-snapshot scorer
(`make_assigner`), out-of-core store scoring (`assign_store`), scoring
against a live streaming model (`assign_stream`), hot-swappable replicas
and their publisher (`Scorer`, `SnapshotPublisher`,
`snapshot_from_checkpoint`), the coalescing `ScoringService`, and the
tenant plane's gather-scored `TenantScorer` with its tenant-routed
`TenantScoringService`; and the LM's greedy serving path for every
family (`make_prefill`, `make_serve_step`, `greedy_generate`).
"""
from .cluster import assign_store, assign_stream, make_assigner
from .decode import greedy_generate, make_prefill, make_serve_step
from .scorer import (CenterSnapshot, Scorer, SnapshotPublisher,
                     snapshot_from_checkpoint)
from .service import (DeadlineExceeded, Rejected, ScoreResult,
                      ScoringService, ServiceClosed, ServiceConfig)
from .tenant import (TenantScorer, TenantScoringService, TenantSnapshot,
                     tenant_snapshot)

__all__ = ["assign_store", "assign_stream", "make_assigner",
           "make_serve_step", "make_prefill", "greedy_generate",
           "CenterSnapshot", "Scorer", "SnapshotPublisher",
           "snapshot_from_checkpoint",
           "DeadlineExceeded", "Rejected", "ScoreResult",
           "ScoringService", "ServiceClosed", "ServiceConfig",
           "TenantScorer", "TenantScoringService", "TenantSnapshot",
           "tenant_snapshot"]
