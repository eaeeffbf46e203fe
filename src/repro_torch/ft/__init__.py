"""`repro_torch.ft` — fault tolerance (counterpart of `repro.ft`): the
checkpoint manager, in the reference's on-disk format.  The elastic
remesh and straggler helpers come with a later slice."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
