"""The sharded LM's explicit SPMD: what GSPMD does for each logical axis
in the reference, done by hand in the port's model code.

Under a mesh of more than one rank (`active_mesh`) every rank holds its
block of each parameter under `models.params.tree_pspecs` in the active
profile (`placement`), and the model code treats each dim of a
parameter by its logical axis:

* **storage** axes ("embed", "expert_embed": over "data" under "tp",
  over ("data", "model") under "fsdp") are gathered before use and
  their cotangents reduce-scattered (`param`, `mesh.gather_param`);
* **compute** axes ("heads", "kv_heads", "mlp", "vocab", "experts" over
  "model" under "tp") stay split: a layer whose weight is split over
  "model" enters with `mesh.enter_replicated` (column-parallel) and
  leaves with `mesh.reduce_replicated` (row-parallel) — Megatron's two
  operators.  A layer whose weights are whole there runs whole on every
  rank, replicated.

Activations are row blocks of the global batch over the profile's batch
axes (`batch_axes`), replicated over the other axes.  The global batch
must split over every one of them (`check_batch`): the reference's
fallbacks for a batch that does not — the sequence split over "model"
under "fsdp", replication over "data" — are not the port's.  A
parameter's gradient is then summed over the storage axes by the
reduce-scatter, and over the batch axes its placement leaves whole by
the trainer (`grad_sum_axes`).
"""
from __future__ import annotations

import math
from typing import Tuple

from .. import mesh as M
from .rules import (PROFILES, Paired, get_mesh, get_profile,
                    logical_to_spec, spec_axes)

STORAGE = ("embed", "expert_embed")


def active_mesh():
    """The active mesh (`sharding.mesh_context`) when it has more than
    one rank, else None: one rank runs the plain model code."""
    mesh = get_mesh()
    if mesh is None or M.mesh_size(mesh) == 1:
        return None
    return mesh


def placement(decl, mesh) -> tuple:
    """A declaration's placement on ``mesh`` under the active profile
    (`Paired` where its last dim is a gated [u | g] pair)."""
    spec = logical_to_spec(decl.logical, mesh, dims=decl.shape)
    return Paired(spec) if getattr(decl, "gated", False) else spec


def param(p, name: str, decl: dict, mesh):
    """``p[name]``, this rank's block of the declaration ``decl[name]``,
    with its storage dims gathered (`mesh.gather_param`): the block that
    the compute axes leave.  Without a mesh, ``p[name]``."""
    t = p[name]
    if mesh is None:
        return t
    d = decl[name]
    for dim, (logical, entry) in enumerate(zip(d.logical,
                                               placement(d, mesh))):
        if logical in STORAGE and spec_axes(entry):
            t = M.gather_param(t, dim, mesh, spec_axes(entry))
    return t


def model_split(decl, dim: int, mesh) -> bool:
    """Whether dim ``dim`` of the declaration is split over "model" (a
    compute axis: the layer runs tensor-parallel)."""
    if mesh is None:
        return False
    return "model" in spec_axes(placement(decl, mesh)[dim])


def model_rank(mesh) -> Tuple[int, int]:
    """(this rank's coordinate on "model", the axis's size)."""
    return M.block_index(mesh, ("model",))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The active profile's batch axes that ``mesh`` has, in the rule's
    order (tp: ("pod", "data"); fsdp: ("pod", "data", "model"))."""
    return tuple(a for a in PROFILES[get_profile()]["batch"]
                 if a in mesh.mesh_dim_names)


def batch_split(mesh) -> int:
    sizes = M.axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def global_batch(local_rows: int, mesh) -> int:
    """The global batch of which ``local_rows`` is a rank's block."""
    return local_rows if mesh is None else local_rows * batch_split(mesh)


def check_batch(rows: int, mesh) -> None:
    """Raise unless a global batch of ``rows`` splits over every batch
    axis of the profile that the mesh has."""
    if rows % batch_split(mesh):
        raise NotImplementedError(
            f"a global batch of {rows} rows does not split over the batch "
            f"axes {batch_axes(mesh)} of {M.axis_sizes(mesh)} under the "
            f"{get_profile()!r} profile: the sharded LM takes a batch that "
            "divides them (the reference would split the sequence or "
            "replicate rows instead)")


def check_ranks(mesh) -> None:
    """Raise unless this process is a rank of ``mesh``'s process group:
    SPMD, every rank of the mesh making the same call."""
    import torch.distributed as dist
    if not dist.is_initialized() or \
            dist.get_rank() not in mesh.mesh.flatten().tolist():
        raise RuntimeError(
            f"a mesh of {M.mesh_size(mesh)} ranks trains sharded, every "
            "rank of its process group making the call (torchrun, "
            "mesh.spawn_mesh); this process is none of them")


def first_holder(spec, mesh, rank: int) -> bool:
    """Whether ``rank`` is the first of the ranks holding its block
    under ``spec``: coordinate 0 on every axis the placement leaves
    whole."""
    split = {a for e in spec for a in spec_axes(e)}
    coords = M._coords(mesh, rank)
    return all(coords[a] == 0 for a in mesh.mesh_dim_names if a not in split)


def grad_sum_axes(spec, mesh) -> Tuple[str, ...]:
    """The batch axes a leaf's gradient is still to be summed over after
    the backward: those of more than one rank that its placement does not
    split (the split ones were reduce-scattered by `param`, or hold
    experts fed by the all-to-all)."""
    split = {a for e in spec for a in spec_axes(e)}
    sizes = M.axis_sizes(mesh)
    return tuple(a for a in batch_axes(mesh)
                 if a not in split and sizes[a] > 1)
