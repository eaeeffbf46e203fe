"""`repro_torch.ft` — fault tolerance (counterpart of `repro.ft`): the
checkpoint manager, in the reference's on-disk format, and the
single-host straggler helpers.  The LM trainer's elastic remesh
(`make_mesh_for`, `elastic_remesh`) raises until the LM stack (M13)."""
from .checkpoint import CheckpointManager
from .elastic import (StragglerMonitor, detect_stragglers, elastic_remesh,
                      make_mesh_for)

__all__ = ["CheckpointManager", "StragglerMonitor", "detect_stragglers",
           "elastic_remesh", "make_mesh_for"]
