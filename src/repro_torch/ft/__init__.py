"""`repro_torch.ft` — fault tolerance (counterpart of `repro.ft`): the
checkpoint manager, in the reference's on-disk format (sharded saves and
restores onto a mesh of any shape included), the straggler helpers, and
the LM trainer's elastic restart (`make_mesh_for`, `elastic_remesh`)."""
from .checkpoint import CheckpointManager
from .elastic import (StragglerMonitor, detect_stragglers, elastic_remesh,
                      make_mesh_for)

__all__ = ["CheckpointManager", "StragglerMonitor", "detect_stragglers",
           "elastic_remesh", "make_mesh_for"]
