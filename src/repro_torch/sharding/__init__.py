"""`repro_torch.sharding` — counterpart of `repro.sharding`.

Only `data_axes` so far: the mesh axes a fit's records split over.  The
logical-axis rules and ``constrain`` come with the sharded LM (ROADMAP
Queue 1 item 3d); the port's model code runs on one card and omits the
reference's ``constrain`` calls.
"""
from .rules import data_axes

__all__ = ["data_axes"]
