"""`repro_torch.engine` — the sweep-backend and merge-plan core.

Counterpart of `repro.engine`: backends (implementations of the O(n·c)
accumulation sweep, selected by name or by measured race), summaries (the
(centers, masses) sketch every layer trades in) and merge plans (the
weighted summary-reduce, plus the shared convergence loop
`fcm_converge` and its tenant-stacked twin `fcm_converge_batched`).

Importing this package imports `repro_torch.kernels.ops`, which
registers the ``hopper`` kernel backends.
"""
from .backend import (Bf16Backend, SweepBackend, TorchBackend,
                      available_backends, default_backend_name,
                      fcm_accumulate, fcm_accumulate_batched,
                      fcm_accumulate_mixed, fcm_sweep, get_backend,
                      hard_assign, membership_terms, normalize_accumulators,
                      pairwise_sqdist, register_backend, resolve_backend,
                      scoring_backend, soft_assign)
from .merge import (TOPOLOGIES, MergePlan, MergeResult, fcm_converge,
                    fcm_converge_batched, merge_summaries)
from .summary import (Summary, concat, phantom, slot_masses, stack,
                      summary, total_mass)
from ..kernels import ops as _kernel_ops  # noqa: E402,F401  registers hopper

__all__ = [
    "Bf16Backend", "SweepBackend", "TorchBackend", "available_backends",
    "default_backend_name", "fcm_accumulate", "fcm_accumulate_batched",
    "fcm_accumulate_mixed", "fcm_sweep", "get_backend", "hard_assign", "membership_terms",
    "normalize_accumulators", "pairwise_sqdist", "register_backend",
    "resolve_backend", "scoring_backend", "soft_assign", "TOPOLOGIES", "MergePlan",
    "MergeResult", "fcm_converge", "fcm_converge_batched",
    "merge_summaries", "Summary", "concat", "phantom", "slot_masses",
    "stack", "summary", "total_mass",
]
