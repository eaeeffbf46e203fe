"""`repro_torch.ft` — fault tolerance (counterpart of `repro.ft`): the
checkpoint manager, in the reference's on-disk format, and the
single-host straggler helpers.  The elastic remesh comes with the
multi-GPU slice."""
from .checkpoint import CheckpointManager
from .elastic import StragglerMonitor, detect_stragglers

__all__ = ["CheckpointManager", "StragglerMonitor", "detect_stragglers"]
