"""Logical-axis sharding rules — counterpart of `repro.sharding.rules`.

Every parameter/activation dimension carries a *logical* name; the rules
table maps it to mesh axes.  Production mesh axes are
(pod, data, model): ``data`` doubles as the FSDP axis for parameters and
the batch axis for activations, ``model`` carries tensor/expert
parallelism, ``pod`` extends the batch/FSDP axes across pods.

A mesh is the port's `DeviceMesh` (`repro_torch.mesh.make_mesh`) or an
`AbstractMesh` (names and sizes, no process group).  A placement is a
plain tuple of entries, one a dim — ``None``, an axis name or a tuple of
names — as the reference's ``PartitionSpec`` (`pspec` collapses a
one-name tuple to the name, as ``PartitionSpec`` does); `local_block`
cuts a tensor to the block one rank holds under it (`block_of` also
cuts a `Paired` placement, a gated MLP's [u | g] columns).

`constrain` is the reference's ``with_sharding_constraint`` by logical
axes.  The port is SPMD with explicit collectives, so its model code
knows its layouts: `constrain` checks that a tensor is the block its
logical axes give this rank, and raises otherwise.

A step's activations are laid out by `rows_context`: the mesh axes its
batch's rows split over, and where the sequence splits too (the "seq"
rule under "fsdp", `sharding.spmd.rows`), this rank's block of it
(`SeqBlock`).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..mesh import _block, axis_sizes, layout

# logical axis -> mesh axes (None = replicated)
LOGICAL_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,              # sequence kept unsharded (SP is a perf knob)
    "act_embed": None,
    "act_heads": "model",     # attention activations sharded by head
    "act_mlp": "model",
    # parameters
    "vocab": "model",
    "embed": "data",          # FSDP shard of the embed/contracting dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",       # expert parallelism
    "expert_embed": "data",   # FSDP shard of expert d_model dims
    "expert_mlp": None,
    "layers": None,
    "conv": None,
    "state": None,
    "frames": None,
    None: None,
}

# Pure ZeRO-3/FSDP profile: no tensor parallelism — batch shards over
# EVERY mesh axis, every param shards its d_model dim over (data, model);
# "experts" stays on "model" (EP), "expert_embed" on "data"; the
# sequence shards over "model" where the batch cannot cover it.
FSDP_RULES = {
    **LOGICAL_RULES,
    "batch": ("pod", "data", "model"),
    "act_heads": None,
    "act_mlp": None,
    "vocab": None,
    "embed": ("data", "model"),
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "seq": "model",
}

PROFILES = {"tp": LOGICAL_RULES, "fsdp": FSDP_RULES}

_mesh_var: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_profile_var: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_profile", default="tp")
_rows_var: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_rows", default=None)
_seq_var: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_seq", default=None)


class SeqBlock(NamedTuple):
    """This rank's block of a sequence split over the mesh ``axes``:
    ``length`` positions in all, of which the block holds ``size`` from
    position ``offset`` on (its coordinate over the axes times
    ``size``)."""
    axes: Tuple[str, ...]
    length: int
    offset: int
    size: int


def set_mesh(mesh) -> None:
    _mesh_var.set(mesh)


def get_mesh():
    return _mesh_var.get()


def set_profile(name: str) -> None:
    if name not in PROFILES:
        raise ValueError(f"unknown sharding profile {name!r}")
    _profile_var.set(name)


def get_profile() -> str:
    return _profile_var.get()


@contextlib.contextmanager
def profile_context(name: str):
    if name not in PROFILES:
        raise ValueError(f"unknown sharding profile {name!r}")
    tok = _profile_var.set(name)
    try:
        yield
    finally:
        _profile_var.reset(tok)


@contextlib.contextmanager
def mesh_context(mesh):
    tok = _mesh_var.set(mesh)
    try:
        yield mesh
    finally:
        _mesh_var.reset(tok)


def get_rows() -> Optional[Tuple[str, ...]]:
    """The mesh axes the active batch's rows split over (`rows_context`),
    or None: every batch axis of the profile."""
    return _rows_var.get()


def get_seq() -> Optional[SeqBlock]:
    """This rank's block of the active sequence where it splits over the
    mesh (`rows_context`), else None: the sequence is whole."""
    return _seq_var.get()


@contextlib.contextmanager
def rows_context(axes: Sequence[str], seq: Optional[SeqBlock] = None):
    """Run with the batch's rows split over ``axes`` (the largest
    dividing prefix of the profile's batch axes, `launch.specs.
    batch_axes_for`) and replicated over the profile's other batch axes
    that ``seq`` leaves; with ``seq``, each row's sequence split over
    ``seq.axes``, this rank holding the block ``seq`` (else whole)."""
    tok = _rows_var.set(tuple(axes))
    tok_seq = _seq_var.set(seq)
    try:
        yield
    finally:
        _seq_var.reset(tok_seq)
        _rows_var.reset(tok)


def data_axes(mesh=None) -> Tuple[str, ...]:
    """The batch/record axes of ``mesh`` (default: the active one):
    ``("pod", "data")`` filtered to its dims; ``("data",)`` without a
    mesh."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _entry(axes):
    """One spec entry from a sequence of axis names: None, a name, or a
    tuple of names."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def pspec(*entries) -> tuple:
    """A placement, ``PartitionSpec(*entries)``'s counterpart: a tuple of
    entries, a one-name tuple collapsed to the name."""
    return tuple(e if e is None or isinstance(e, str) else _entry(e)
                 for e in entries)


def is_spec(x) -> bool:
    """A placement (a plain tuple), not a NamedTuple container."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_spec(logical: Sequence[Optional[str]], mesh=None,
                    dims: Optional[Sequence[int]] = None) -> tuple:
    """('batch','seq','embed') → (('pod','data'), None, 'data') filtered
    to axes that exist in the mesh (active profile's table).  With
    ``dims`` (the tensor shape), mesh axes are greedily dropped from the
    tail of each entry until the dim is divisible — so a rule like
    batch→(pod,data,model) degrades gracefully for small batches.  A
    mesh axis appears on at most one dim; earlier dims take precedence."""
    mesh = get_mesh() if mesh is None else mesh
    sizes = axis_sizes(mesh) if mesh is not None else {}
    rules = PROFILES[get_profile()]

    def resolve(ax, size):
        target = rules.get(ax, None)
        if target is None:
            return ()
        if isinstance(target, str):
            target = (target,)
        got = [t for t in target if t in sizes]
        if size is not None and mesh is not None:
            while got and size % math.prod(sizes[t] for t in got):
                got.pop()
        return tuple(got)

    dims = dims if dims is not None else [None] * len(logical)
    entries, used = [], set()
    for a, s in zip(logical, dims):
        got = tuple(t for t in resolve(a, s) if t not in used)
        used.update(got)
        entries.append(_entry(got))
    return tuple(entries)


def constrain(x, *logical: Optional[str], shape: Sequence[int] = None):
    """``x`` itself, once checked to be this rank's block of a tensor of
    the global ``shape`` placed by ``logical`` (`logical_to_spec` with
    ``dims=shape`` under the active mesh and profile): each dim the
    global size over the size of its entry's axes.  The port's rows are
    its own layout (`rows_context`): "batch" is split over the active
    rows' axes (`get_rows`; every batch axis of the profile by default)
    and "seq" over the active sequence block's axes (`get_seq`: the
    reference's "seq" over "model" under "fsdp", where the rows leave
    "model" and the length divides it), else whole.  A no-op without a
    mesh of more than one rank.  A wrong block raises."""
    mesh = get_mesh()
    if mesh is None or layout(mesh).size == 1:
        return x
    if shape is None or len(shape) != x.dim():
        raise ValueError(f"constrain under a mesh needs the global shape "
                         f"of the {x.dim()}-d tensor, not {shape}")
    rows = get_rows()
    if rows is None:
        rows = tuple(a for a in PROFILES[get_profile()]["batch"]
                     if a in mesh.mesh_dim_names)
    seq = get_seq()
    own = {"batch": _entry(rows),
           "seq": None if seq is None else _entry(seq.axes)}
    spec = logical_to_spec([None if a in own else a for a in logical],
                           mesh, dims=shape)
    spec = tuple(own[a] if a in own else e for a, e in zip(logical, spec))
    sizes = axis_sizes(mesh)
    want = tuple(int(n) // math.prod(sizes[a] for a in spec_axes(e))
                 for n, e in zip(shape, spec))
    if tuple(x.shape) != want:
        raise ValueError(f"constrain{tuple(logical)}: a block of "
                         f"{tuple(x.shape)}, not the {want} that {spec} "
                         f"gives of {tuple(shape)} on {sizes}")
    return x


class Paired(tuple):
    """A placement whose last dim holds two halves side by side — a gated
    MLP's ``w_in`` columns [u | g] — each cut on its own: a rank's block
    of that dim is its block of u, then its block of g (`block_of`), so
    the column-parallel ``u_r · act(g_r)`` needs no exchange.  Equal to
    the plain placement (it is the same tuple); on disk and in the
    reference the leaf keeps its [u | g] layout."""

    def __repr__(self) -> str:
        return f"Paired{tuple.__repr__(self)}"


def _halves(t, spec):
    """(u, g) of a `Paired` placement's last dim, or None where that dim
    is whole."""
    if not isinstance(spec, Paired) or len(spec) < t.ndim \
            or not spec_axes(spec[t.ndim - 1]):
        return None
    n = int(t.shape[-1])
    if n % 2:
        raise ValueError(f"a paired last dim of odd size {n}")
    return t[..., :n // 2], t[..., n // 2:]


def block_of(t, spec: Sequence, mesh, rank: int):
    """`local_block`, except under a `Paired` placement: there the last
    dim's block is the rank's block of each half, side by side (a new
    tensor or array, not a view)."""
    halves = _halves(t, spec)
    if halves is None:
        return local_block(t, spec, mesh, rank)
    u, g = (local_block(h, spec, mesh, rank) for h in halves)
    if isinstance(t, torch.Tensor):
        return torch.cat([u, g], dim=-1)
    import numpy as np
    return np.concatenate([u, g], axis=-1)


def put_block(full, blk, spec: Sequence, mesh, rank: int) -> None:
    """`block_of`'s inverse: write ``rank``'s block ``blk`` into the
    global array ``full`` (numpy, a memmap, or a tensor) in place."""
    halves = _halves(full, spec)
    if halves is None:
        full[_index(full, spec, mesh, rank) + (Ellipsis,)] = blk
        return
    n = int(blk.shape[-1]) // 2
    for h, part in zip(halves, (blk[..., :n], blk[..., n:])):
        h[_index(h, spec, mesh, rank) + (Ellipsis,)] = part


def local_block(t, spec: Sequence, mesh, rank: int):
    """The block of ``t`` (a tensor or numpy array; sliced, not copied)
    that ``rank`` holds under ``spec``: dim i split into equal blocks over
    entry i's axes, ``rank``'s block in row-major order over those axes
    as listed (`PartitionSpec`'s order); dims past the spec whole.  A dim
    its blocks do not divide raises."""
    return t[_index(t, spec, mesh, rank)]


def _index(t, spec: Sequence, mesh, rank: int) -> tuple:
    """The slices of `local_block`."""
    spec = tuple(spec)
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{t.ndim}-d tensor")
    index = []
    for i, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            index.append(slice(None))
            continue
        b, count = _block(mesh, rank, axes)
        n = int(t.shape[i])
        if n % count:
            raise ValueError(f"dim {i} of size {n} does not split into "
                             f"{count} blocks over {axes}")
        per = n // count
        index.append(slice(b * per, (b + 1) * per))
    return tuple(index)


def map_leaves(fn, tree):
    """``fn`` over the tensor leaves of a tree of dicts, lists, tuples
    and NamedTuples (kept as they are); other leaves (ints) unchanged."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def abstract_like(tree, dtype: Optional[torch.dtype] = None):
    """A tree of tensors → the same tree of ``meta`` tensors, of the
    same shapes and their dtypes (or ``dtype``): no storage."""
    return map_leaves(lambda a: torch.empty(
        a.shape, dtype=dtype or a.dtype, device="meta"), tree)
