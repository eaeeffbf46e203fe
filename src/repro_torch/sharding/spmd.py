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

Activations are row blocks of the global batch, replicated over
"model" under "tp".  The rows split over the largest prefix of the
profile's batch axes whose product divides the global batch
(`launch.specs.batch_axes_for`, the reference's rule), set for a step
with `rows` (`sharding.rules.rows_context`), and are replicated over
the profile's other batch axes: a batch of 1 is whole on every rank, a
batch of 32 on the (16, 16) mesh under "fsdp" is split over "data" and
replicated over "model".  A parameter's gradient is summed over the
storage axes by the reduce-scatter, and over the batch axes its
placement leaves whole by the trainer (`grad_sum_axes`: every batch
axis of the profile, split or not).  The ranks that replicate rows each
weigh their copy by 1/`replication` in the backward, so those sums count
each row once.
"""
from __future__ import annotations

import math
from typing import Tuple

from .. import mesh as M
from .rules import (PROFILES, Paired, get_mesh, get_profile, get_rows,
                    logical_to_spec, rows_context, spec_axes)

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


def profile_batch_axes(mesh) -> Tuple[str, ...]:
    """The active profile's batch axes that ``mesh`` has, in the rule's
    order (tp: ("pod", "data"); fsdp: ("pod", "data", "model"))."""
    return tuple(a for a in PROFILES[get_profile()]["batch"]
                 if a in mesh.mesh_dim_names)


def dividing_axes(axes, rows: int, mesh) -> Tuple[str, ...]:
    """Those of ``axes`` (in their order) whose running product divides
    ``rows``, an axis that does not skipped."""
    sizes = M.axis_sizes(mesh)
    got, prod = [], 1
    for a in axes:
        if rows % (prod * sizes[a]) == 0:
            got.append(a)
            prod *= sizes[a]
    return tuple(got)


def rows_axes(rows: int, mesh) -> Tuple[str, ...]:
    """The axes a global batch of ``rows`` splits over: the largest
    prefix of the profile's batch axes whose product divides it
    (`dividing_axes`; `launch.specs.batch_axes_for`)."""
    return dividing_axes(profile_batch_axes(mesh), rows, mesh)


def rows(global_rows: int, mesh):
    """Context: a step on a global batch of ``global_rows`` rows, split
    over `rows_axes` and replicated over the rest."""
    return rows_context(rows_axes(global_rows, mesh))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes the active batch's rows split over (`rows`); every batch
    axis of the profile outside one."""
    got = get_rows()
    return profile_batch_axes(mesh) if got is None else got


def batch_split(mesh) -> int:
    sizes = M.axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def replication(mesh) -> int:
    """The ranks that hold each row of the active batch: the product of
    the profile's batch axes that do not split it."""
    sizes = M.axis_sizes(mesh)
    return math.prod(sizes[a] for a in profile_batch_axes(mesh)
                     if a not in batch_axes(mesh))


def global_batch(local_rows: int, mesh) -> int:
    """The global batch of which ``local_rows`` is a rank's block."""
    return local_rows if mesh is None else local_rows * batch_split(mesh)


def check_ranks(mesh) -> None:
    """Raise unless this process is a rank of ``mesh``'s process group:
    SPMD, every rank of the mesh making the same call."""
    import torch.distributed as dist
    if not dist.is_initialized() or \
            dist.get_rank() not in M.layout(mesh).ravel().tolist():
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
    the backward: those of the profile, of more than one rank, that its
    placement does not split (the split ones were reduce-scattered by
    `param`, or hold experts fed by the all-to-all) — the ones that
    replicate the rows too, each copy weighed 1/`replication`."""
    split = {a for e in spec for a in spec_axes(e)}
    sizes = M.axis_sizes(mesh)
    return tuple(a for a in profile_batch_axes(mesh)
                 if a not in split and sizes[a] > 1)
