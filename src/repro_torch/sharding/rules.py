"""Mesh axes of the data — counterpart of `repro.sharding.rules.data_axes`."""
from __future__ import annotations

from typing import Tuple


def data_axes(mesh=None) -> Tuple[str, ...]:
    """The batch/record axes of ``mesh`` (a `repro_torch.mesh` device
    mesh): ``("pod", "data")`` filtered to the mesh's ``mesh_dim_names``;
    ``("data",)`` without a mesh."""
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
