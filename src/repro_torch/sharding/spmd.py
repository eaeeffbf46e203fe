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
not over "model".  There the sequence splits instead (the reference's
"seq" over "model" under "fsdp"), where the step's length divides
"model" and the model can (`models.transformer.split_length`: a
decoder of attention blocks, dense or MoE): the caller passes the
length to `rows`, and each rank holds its block of S/"model" positions
(`rules.get_seq`, its offset the rank's coordinate on "model" times the
block) — MLPs, norms and the loss run on it, attention gathers K and V
over "model" and the MoE layer its rows' whole sequence.  Elsewhere
(decode's one position, a length "model" does not divide, the SSM,
hybrid and encoder–decoder families) the rows stay replicated over
"model".  A parameter's gradient is summed over the storage axes by the
reduce-scatter, and over the batch axes its placement leaves whole by
the trainer (`grad_sum_axes`: every batch axis of the profile, split or
not).  The ranks that replicate tokens — neither their rows nor their
positions split there — each weigh their copy by 1/`replication` in the
backward, so those sums count each token once.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from .. import mesh as M
from .rules import (PROFILES, Paired, SeqBlock, get_mesh, get_profile,
                    get_rows, get_seq, logical_to_spec, rows_context,
                    spec_axes)

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


def seq_axes(rows: Tuple[str, ...], length: int, mesh) -> Tuple[str, ...]:
    """The axes a sequence of ``length`` positions splits over beside
    rows split over ``rows``: the profile's "seq" axes ("model" under
    "fsdp", none under "tp") that the rows leave, dropped from the tail
    until their product divides ``length`` (`logical_to_spec`'s dims
    rule), those of one rank left out."""
    sizes = M.axis_sizes(mesh)
    got = [a for a in spec_axes(PROFILES[get_profile()]["seq"])
           if a in sizes and a not in rows]
    while got and length % math.prod(sizes[a] for a in got):
        got.pop()
    return tuple(a for a in got if sizes[a] > 1)


def rows(global_rows: int, mesh, seq_len: Optional[int] = None):
    """Context: a step on a global batch of ``global_rows`` rows, split
    over `rows_axes` and replicated over the rest; with ``seq_len`` (a
    model that can split its sequence: `models.transformer.
    split_length`), each row's ``seq_len`` positions split over
    `seq_axes`, this rank holding its block of them (`rules.get_seq`)."""
    axes = rows_axes(global_rows, mesh)
    seq = None
    saxes = () if seq_len is None else seq_axes(axes, seq_len, mesh)
    if saxes:
        b, n = M.block_index(mesh, saxes)
        seq = SeqBlock(saxes, seq_len, b * (seq_len // n), seq_len // n)
    return rows_context(axes, seq)


def global_seq(local: int) -> int:
    """The positions of which this rank's ``local`` are its block: the
    active sequence's length where it splits, else ``local``."""
    seq = get_seq()
    return local if seq is None else local * (seq.length // seq.size)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes the active batch's rows split over (`rows`); every batch
    axis of the profile outside one."""
    got = get_rows()
    return profile_batch_axes(mesh) if got is None else got


def batch_split(mesh) -> int:
    sizes = M.axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def token_axes(mesh) -> Tuple[str, ...]:
    """The axes the active batch's tokens split over: its rows' axes
    (`batch_axes`), then its sequence's (`rules.get_seq`)."""
    seq = get_seq()
    return batch_axes(mesh) + (() if seq is None else seq.axes)


def replication(mesh) -> int:
    """The ranks that hold each token of the active batch: the product
    of the profile's batch axes that split neither its rows nor its
    sequence."""
    sizes = M.axis_sizes(mesh)
    return math.prod(sizes[a] for a in profile_batch_axes(mesh)
                     if a not in token_axes(mesh))


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
