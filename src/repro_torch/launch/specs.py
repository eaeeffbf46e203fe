"""Model declarations and batch axes — counterpart of
`repro.launch.specs`'s ``model_decl`` and ``batch_axes_for``.  The
abstract parameters and the partition specs of every (arch × shape)
cell are ROADMAP Queue 1 item 3d."""
from __future__ import annotations

from typing import Tuple

from ..train.step import model_decl

# The reference's default ("tp") profile's logical rule for "batch"
# (repro.sharding.rules.LOGICAL_RULES); the "fsdp" profile is item 3d.
BATCH_AXES = ("pod", "data")

__all__ = ["batch_axes_for", "model_decl"]


def batch_axes_for(b: int, mesh) -> Tuple[str, ...]:
    """Largest prefix of the batch rule's axes present in ``mesh`` whose
    product divides the batch ``b``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    axes, prod = [], 1
    for a in BATCH_AXES:
        if a in sizes and b % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)
