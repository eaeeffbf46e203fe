"""The device mesh over `torch.distributed` — the port's counterpart of
`jax.sharding.Mesh` and of the collectives the reference calls inside
``shard_map`` (`jax.lax.all_gather`, `jax.lax.psum`).

The reference is one controller driving every device of a mesh.  The
port is SPMD: one process per rank, each calling the same entry point
with the same arguments; what the reference computes once and hands
every device, every rank computes (or receives) here.  The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dims — e.g.
``("pod", "data")`` — over the default process group, ranks laid out
row-major over its shape.  A collective over some of its axes runs on
those axes' subgroup (the ranks sharing this rank's coordinates on the
other dims; a group of its own for each set of axes, made on first use
by its members alone), so its payload reaches only the ranks that need
it: a few KB of BigFCM summaries, or the hundreds of MB of an LM's
tensor-parallel activations and FSDP parameter gathers.

  * `make_mesh` / `rank_device` — the mesh and this rank's device
    (``cuda:{local rank % device count}``; the CPU for a CPU mesh).
  * `shard_rows` — this rank's contiguous row block under the
    reference's ``P(data_axes)`` placement: blocks ordered row-major over
    the axes *as given*, a row count that does not divide raising as
    `jax.device_put` does.
  * `all_gather` — the (P, …) stack, in the order
    `jax.lax.all_gather(t, axes)` gives (that same row-major order).
  * `psum` — the gathered partials added in rank order, so every rank
    holds the same bits and a rerun repeats them whatever ring order the
    backend uses.
  * `reduce_scatter` — the sum over the axes, each member keeping its
    block of one dim: an all-to-all of the blocks, each block's parts
    added in rank order (the bits of `psum`'s block, at 1/P of the
    bytes received).
  * `gather_param` — a parameter's block gathered over the axes that
    only store it (FSDP), under autograd: its backward is
    `reduce_scatter`, each member's use of the whole a part of one
    global use.
  * `gather_seq` / `scatter_seq` — the same gather for an activation's
    sequence split over the axes (K and V around attention, a MoE
    layer's input), and its transpose: the partials' sum of which each
    member keeps its block, whose backward gathers the cotangent.
  * `all_to_all` — ``jax.lax.all_to_all(t, axis, 0, 0, tiled=False)``
    over one mesh axis, on that axis's subgroup (its payload is the
    routed tokens of expert parallelism, hundreds of MB, not summaries);
    differentiable, its backward the inverse all-to-all.
  * `enter_replicated` / `reduce_replicated` — shard_map's transposes
    for a value replicated over an axis, under autograd: the first is the
    identity whose backward sums the ranks' cotangents over the axes; the
    second is `psum` whose backward hands each rank the (replicated)
    output cotangent unchanged.
  * `broadcast_first` — rank 0's tensor or picklable object on every
    rank (decisions that pick a branch must be identical everywhere).
  * `AbstractMesh` — axis names and sizes with no process group
    (`repro.compat.abstract_mesh`'s counterpart): placements at
    production shapes, (16, 16) or (2, 16, 16), computed on one host.
  * `spawn_mesh` — start ``fn`` on every rank of a fresh process group
    (a ``file://`` rendezvous in a temporary directory), with a deadline;
    how the tests and `chip_smoke.py` run a mesh on one host.

Backends: NCCL across cards, gloo for the CPU tests and for several
ranks on one card (NCCL refuses two ranks on one GPU).  Under gloo a
collective's payload is staged through host memory here, explicitly —
that is the transport; the kernels still run on each rank's device.
Under the "fake" backend (`torch.testing._internal.distributed.fake_pg`,
what the dry run joins: one process standing for rank 0 of 256 or 512)
a payload stays on its own device, no card is selected, and the
collectives return at once — on ``FakeTensorMode`` tensors they move
nothing and allocate nothing.  A mesh's rank layout is read from a numpy
copy (`layout`), so placements and groups are worked out under
``FakeTensorMode`` too.

Users launch ranks with ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous), then::

    torch.distributed.init_process_group("nccl")
    mesh = make_mesh((torch.distributed.get_world_size(),), ("data",))
    res = bigfcm_fit(x, cfg, mesh=mesh, data_axes=("data",))

Instrumentation: each collective adds its host seconds to
``mesh.collective_s`` and the bytes it receives to ``mesh.gathered_bytes``
— `all_to_all` to ``mesh.all_to_all_bytes``, `reduce_scatter` to
``mesh.reduce_scatter_bytes`` — (`repro_torch.obs` counters; the
process's own, like every counter).  By kind besides: `psum`'s gathers
also go to ``mesh.psum_bytes`` (a tensor-parallel all-reduce),
`gather_param`'s to ``mesh.param_gather_bytes`` and `gather_seq`'s (and
`scatter_seq`'s backward's) to ``mesh.seq_gather_bytes``.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from . import obs
from .device import resolve_device

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device_type: str = "cuda",
              ranks: Optional[Sequence[int]] = None):
    """A `DeviceMesh` of ``shape`` with dims ``axis_names`` over the
    initialised default process group, ranks row-major over ``shape``
    (their product must be the world size).  ``ranks`` lays out those
    ranks instead, in their order — a subset of the world (the ranks
    outside it hold no coordinate and take no part in its collectives).
    On ``"cuda"`` this rank's card becomes the current device."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torchrun + init_process_group, or "
                           "spawn_mesh)")
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} "
                         "differ in length")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if math.prod(shape) != len(ranks) or not set(ranks) <= set(range(world)) \
            or len(set(ranks)) != len(ranks):
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"ranks; it is given {ranks} of a process group of "
                         f"{world}")
    if device_type == "cuda" and not is_fake():
        torch.cuda.set_device(_local_device(torch.device("cuda")))
    elif device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device type {device_type!r}: "
                         "cuda or cpu")
    mesh = DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)
    mesh.__dict__["_repro_layout"] = np.asarray(ranks).reshape(shape)
    return mesh


def is_fake() -> bool:
    """Whether the default process group is the "fake" backend's (the
    dry run's stand-in for a cluster)."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def layout(mesh) -> np.ndarray:
    """The mesh's ranks as a numpy array of its shape (cached on the
    mesh): read without dispatching a tensor op, so under
    ``FakeTensorMode`` too."""
    got = mesh.__dict__.get("_repro_layout")
    if got is None:
        got = np.asarray(mesh.mesh.tolist()).reshape(tuple(mesh.mesh.shape))
        mesh.__dict__["_repro_layout"] = got
    return got


def _local_device(dev: torch.device) -> torch.device:
    if dev.type != "cuda":
        return dev
    resolve_device(dev)                 # raises without a card
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def rank_device(mesh) -> torch.device:
    """This rank's device: ``cuda:{local rank % device count}`` on a CUDA
    mesh (raising when there is no card), the CPU on a CPU mesh."""
    return _local_device(torch.device(mesh.device_type))


def mesh_size(mesh) -> int:
    return int(layout(mesh).size)


def axis_sizes(mesh) -> dict:
    """Dim name → size of a `DeviceMesh` or an `AbstractMesh`, in the
    mesh's dim order (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, layout(mesh).shape))


class AbstractMesh:
    """A mesh's axis names and sizes, ranks row-major over its shape, with
    no process group behind it (`repro.compat.abstract_mesh`'s
    counterpart): what placements (`repro_torch.sharding`) and
    `local_block` read, for meshes no host here runs, such as the
    production (16, 16) and (2, 16, 16).  Collectives refuse it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "differ in length")
        self.mesh_dim_names = names
        self.mesh = torch.arange(math.prod(shape)).reshape(shape)
        self._repro_layout = np.arange(math.prod(shape)).reshape(shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({axis_sizes(self)})"


def _coords(mesh, rank: int) -> dict:
    """Dim name → coordinate of ``rank`` in ``mesh``."""
    where = np.argwhere(layout(mesh) == rank)
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, where[0].tolist()))


def _block(mesh, rank: int, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(block index, block count) of ``rank`` over ``axes``, row-major
    over the axes as given — `jax.sharding.PartitionSpec((axes,))`'s
    order, and `jax.lax.all_gather(t, axes)`'s."""
    sizes = axis_sizes(mesh)
    unknown = [a for a in axes if a not in sizes]
    if unknown:
        raise ValueError(f"axes {unknown} are not dims of the mesh "
                         f"{tuple(mesh.mesh_dim_names)}")
    coord = _coords(mesh, rank)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx, math.prod(sizes[a] for a in axes)


def _group(mesh, axes: Tuple[str, ...]) -> List[int]:
    """The ranks this rank gathers from over ``axes`` (those sharing its
    coordinates on every other dim), in block order."""
    me = _coords(mesh, dist.get_rank())
    others = [a for a in mesh.mesh_dim_names if a not in axes]
    members = [r for r in layout(mesh).ravel().tolist()
               if all(_coords(mesh, r)[a] == me[a] for a in others)]
    return sorted(members, key=lambda r: _block(mesh, r, axes)[0])


def shard_rows(x, mesh, axes: Axes = ("data",)):
    """This rank's contiguous row block of ``x`` (numpy, a memmap or a
    tensor; sliced, not copied) under the reference's ``P(axes)``
    placement.  A row count the block count does not divide raises."""
    axes = _axes(axes)
    idx, count = _block(mesh, dist.get_rank(), axes)
    n = int(x.shape[0])
    if n % count:
        raise ValueError(f"{n} rows do not split into {count} equal blocks "
                         f"over the mesh axes {axes}; pad with zero-weight "
                         "phantom rows")
    per = n // count
    return x[idx * per:(idx + 1) * per]


def block_index(mesh, axes: Axes = ("data",)) -> Tuple[int, int]:
    """(this rank's block, the block count) under ``P(axes)``."""
    return _block(mesh, dist.get_rank(), _axes(axes))


def _wire_device(t: torch.Tensor) -> torch.device:
    """Where ``t``'s payload travels: this rank's card under NCCL, host
    memory under gloo, its own device under the fake backend."""
    backend = dist.get_backend()
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "fake":
        return t.device
    return torch.device("cpu")


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` flat and contiguous on the wire's device; a 16-bit tensor as
    its bytes under gloo (which refuses int16, and not every build takes
    bf16)."""
    wire = t.detach().to(_wire_device(t)).reshape(-1).contiguous()
    if wire.element_size() == 2 and wire.device.type == "cpu":
        wire = wire.view(torch.uint8)
    return wire


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A wire tensor back as ``like``'s dtype and device (flat)."""
    if w.dtype != like.dtype:
        w = w.view(like.dtype)
    return w.to(like.device)


def _members(mesh, axes: Tuple[str, ...]) -> List[int]:
    """This rank's members over ``axes`` in block order (`_group`),
    cached on the mesh."""
    cache = mesh.__dict__.setdefault("_repro_members", {})
    if axes not in cache:
        cache[axes] = _group(mesh, axes)
    return cache[axes]


def _subgroup(mesh, axes: Tuple[str, ...]):
    """The process group of this rank's members over ``axes``: the
    default group where they are every rank, a mesh dim's own group for
    one axis, else a group made by its members alone on first use (so
    ranks outside it need not take part), cached on the mesh."""
    members = _members(mesh, axes)
    if len(members) == dist.get_world_size():
        return None
    if len(axes) == 1 and hasattr(mesh, "get_group"):
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    key = tuple(sorted(members))
    if key not in cache:
        cache[key] = dist.new_group(list(key),
                                    use_local_synchronization=True)
    return cache[key]


def _gather_all(out: torch.Tensor, wire: torch.Tensor, group) -> None:
    """Every member's flat ``wire`` into the flat ``out``, in group-rank
    order (``all_gather_single``, or its older name)."""
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, wire, group=group)


def _block_order(members: List[int]) -> Optional[List[int]]:
    """The group-rank positions of ``members`` (in block order), or None
    where block order is the group's rank order already."""
    ranked = sorted(members)
    order = [ranked.index(r) for r in members]
    return None if order == list(range(len(members))) else order


def _gather_stack(t: torch.Tensor, mesh, axes: Tuple[str, ...]
                  ) -> torch.Tensor:
    """Every member's ``t`` (equal shapes) over ``axes``, stacked (P, …)
    in block order, on ``t``'s device: one gather into one buffer."""
    t0 = time.perf_counter()
    members = _members(mesh, axes)
    wire = _to_wire(t)
    p = len(members)
    if p == 1:
        got = wire[None]
    else:
        got = wire.new_empty((p * wire.numel(),))
        _gather_all(got, wire, _subgroup(mesh, axes))
        # the group's ranks ascend; the blocks follow the axes' order
        got = got.view(p, -1)
        order = _block_order(members)
        if order is not None:
            got = got[torch.tensor(order, device=got.device)]
    out = _from_wire(got, t).reshape((p,) + tuple(t.shape))
    obs.counter("mesh.collective_s").add(time.perf_counter() - t0)
    obs.counter("mesh.gathered_bytes").add(wire.numel() * wire.element_size()
                                           * p)
    return out


def all_gather(t: torch.Tensor, mesh, axes: Axes = ("data",)
               ) -> torch.Tensor:
    """The (P, …) stack of ``t`` over ``axes`` — the members sharing
    this rank's coordinates on the other dims — in the order
    `jax.lax.all_gather(t, axes)` stacks it, gathered on their
    subgroup."""
    return _gather_stack(t, mesh, _axes(axes))


def gather_rows(x_l: torch.Tensor, idx, mesh, axes: Axes = ("data",)
                ) -> torch.Tensor:
    """Rows ``idx`` (global row numbers) of the array whose ``P(axes)``
    blocks the ranks hold — ``x_l`` is this rank's — on every rank, in
    ``idx``'s order: each rank fills the rows it owns into zeros and the
    stacks are added (x + 0 is x exactly)."""
    idx = np.asarray(idx, np.int64)
    b, _ = block_index(mesh, axes)
    lo, n_l = b * x_l.shape[0], x_l.shape[0]
    mine = np.flatnonzero((idx >= lo) & (idx < lo + n_l))
    out = x_l.new_zeros((idx.shape[0],) + tuple(x_l.shape[1:]))
    out[torch.as_tensor(mine, device=x_l.device)] = x_l[
        torch.as_tensor(idx[mine] - lo, device=x_l.device)]
    return psum(out, mesh, axes)


def sum_in_order(parts) -> torch.Tensor:
    """``parts[0] + parts[1] + …``, left to right: the one summation
    order of a cross-rank sum."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def psum(t: torch.Tensor, mesh, axes: Axes = ("data",)) -> torch.Tensor:
    """The sum of ``t`` over ``axes``: the gathered partials added in
    rank order, so every rank holds the same bits."""
    parts = _gather_stack(t, mesh, _axes(axes))
    obs.counter("mesh.psum_bytes").add(
        t.numel() * t.element_size() * len(parts))
    return sum_in_order(parts.unbind(0))


def reduce_scatter(t: torch.Tensor, mesh, axes: Axes = ("data",),
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, of which this rank keeps its block
    along ``dim`` (P equal blocks in the axes' row-major order, as
    `shard_rows` cuts): the bits of ``psum(t)``'s block.  Each member
    sends block j to the member at block j (one all-to-all on the
    subgroup) and adds the parts it receives in rank order."""
    axes = _axes(axes)
    members = _members(mesh, axes)
    p = len(members)
    n = int(t.shape[dim])
    if n % p:
        raise ValueError(f"reduce_scatter over {axes} ({p} ranks): dim "
                         f"{dim} of {tuple(t.shape)} does not split")
    blocks = t.movedim(dim, 0).reshape((p, n // p) + tuple(
        t.movedim(dim, 0).shape[1:]))
    if p == 1:
        return blocks[0].movedim(0, dim)
    t0 = time.perf_counter()
    # all_to_all_single takes and gives the chunks by group rank
    # (ascending global rank); block j goes to members[j]
    order = _block_order(members)
    send = blocks
    if order is not None:
        send = blocks[torch.tensor(sorted(range(p), key=lambda j: members[j]),
                                   device=blocks.device)]
    send = _to_wire(send).view(p, -1)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=_subgroup(mesh, axes))
    if order is not None:
        recv = recv[torch.tensor(order, device=recv.device)]
    parts = _from_wire(recv, t).reshape(blocks.shape).unbind(0)
    out = sum_in_order(parts).movedim(0, dim)
    obs.counter("mesh.collective_s").add(time.perf_counter() - t0)
    obs.counter("mesh.reduce_scatter_bytes").add(
        recv.numel() * recv.element_size())
    return out


def _gather_along(t: torch.Tensor, dim: int, mesh, axes: Tuple[str, ...],
                  counter: str) -> torch.Tensor:
    """The members' ``t`` over ``axes`` side by side along ``dim`` (block
    order), its bytes added to the obs counter ``counter``."""
    parts = _gather_stack(t, mesh, axes)
    obs.counter(counter).add(t.numel() * t.element_size() * len(parts))
    # (P, …, n, …) → (…, P·n, …): the blocks side by side along dim
    whole = parts.movedim(0, dim)
    return whole.reshape(tuple(t.shape[:dim]) + (-1,)
                         + tuple(t.shape[dim + 1:]))


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes, counter):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _gather_along(t, dim, mesh, axes, counter)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None, None)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return reduce_scatter(t.contiguous(), mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather_along(g.contiguous(), ctx.dim, ctx.mesh, ctx.axes,
                              "mesh.seq_gather_bytes"), None, None, None)


def gather_param(block: torch.Tensor, dim: int, mesh, axes: Axes
                 ) -> torch.Tensor:
    """The whole of a tensor along ``dim`` from the members' blocks over
    ``axes`` (row-major over the axes as listed: `local_block`'s order);
    under autograd its cotangent is summed over the axes and each member
    keeps its block (`reduce_scatter`) — the members' uses of the whole
    are parts of one global use, as an FSDP parameter's are.  No axes:
    ``block`` itself."""
    axes = _axes(axes)
    if not axes:
        return block
    return _GatherParam.apply(block, dim % block.dim(), mesh, axes,
                              "mesh.param_gather_bytes")


def gather_seq(block: torch.Tensor, dim: int, mesh, axes: Axes
               ) -> torch.Tensor:
    """`gather_param` of an activation: the whole sequence along ``dim``
    from the members' blocks of it over ``axes`` (K and V around
    attention, a MoE layer's input, under the sequence split), its
    cotangent reduce-scattered; its bytes go to ``mesh.seq_gather_bytes``.
    No axes: ``block`` itself."""
    axes = _axes(axes)
    if not axes:
        return block
    return _GatherParam.apply(block, dim % block.dim(), mesh, axes,
                              "mesh.seq_gather_bytes")


def scatter_seq(t: torch.Tensor, dim: int, mesh, axes: Axes
                ) -> torch.Tensor:
    """`gather_seq`'s transpose: the sum of the members' partial ``t``
    over ``axes``, of which this rank keeps its block along ``dim``
    (`reduce_scatter`); under autograd its cotangent is gathered along
    ``dim`` (every member's part reads the whole).  No axes: ``t``."""
    axes = _axes(axes)
    if not axes:
        return t
    return _ScatterSum.apply(t, dim % t.dim(), mesh, axes)


def _all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    n = axis_sizes(mesh)[axis]
    if t.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks) needs a "
                         f"leading dim of {n}, not {tuple(t.shape)}")
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"{mesh!r} has no process group to run "
                        "all_to_all on")
    t0 = time.perf_counter()
    wire = _to_wire(t).reshape(n, -1)
    out = torch.empty_like(wire)
    # the axis's subgroup (DeviceMesh builds one per axis and coordinate
    # on every rank, in one order), its ranks in the axis's order
    dist.all_to_all_single(out, wire, group=mesh.get_group(axis))
    out = _from_wire(out, t).reshape(t.shape)
    obs.counter("mesh.collective_s").add(time.perf_counter() - t0)
    obs.counter("mesh.all_to_all_bytes").add(
        out.numel() * out.element_size())
    return out


class _AllToAll(torch.autograd.Function):
    """`all_to_all` under autograd: chunk j of rank i's input lands as
    chunk i on rank j, so the cotangents travel back by the same
    exchange."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.axis), None, None


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(t, axis, split_axis=0, concat_axis=0,
    tiled=False)`` over the one mesh axis ``axis``: ``t`` (n, …) with n
    the axis's size; chunk j goes to the member at coordinate j of the
    axis, and the result's chunk i is what the member at coordinate i
    sent this rank.  Every rank's ``t`` has the same shape and dtype
    (gloo and NCCL take equal splits).  It runs on the axis's subgroup
    (the members sharing this rank's coordinates on the other dims),
    under gloo through host memory; differentiable.  Its received bytes
    go to ``mesh.all_to_all_bytes``."""
    return _AllToAll.apply(t, mesh, axis)


class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return psum(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return psum(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


def sum_replicas(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """`psum` of the members' parts ``t`` over ``axes`` where the members
    hold copies of the same rows, each weighed 1/P in the backward (a
    trainer's seeding): under autograd each part's cotangent is the sum
    of the copies' (`psum`), the whole output's."""
    return _SumReplicas.apply(t, mesh, _axes(axes))


def enter_replicated(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``t`` as it is; under autograd its cotangent is summed over
    ``axes`` (`psum`): the transpose of shard_map's input replicated over
    ``axes``, each member's use of it a part of one global use."""
    return _EnterReplicated.apply(t, mesh, _axes(axes))


def reduce_replicated(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """`psum` of ``t`` over ``axes``, its result replicated there; under
    autograd each member's part takes the output's cotangent unchanged
    (every member holds the same one, and the global result counts
    once)."""
    return _ReduceReplicated.apply(t, mesh, _axes(axes))


def broadcast_first(value, mesh):
    """Rank 0's ``value`` on every rank: a tensor keeps its device (and
    every rank must pass one of the same shape and dtype), anything else
    travels pickled."""
    t0 = time.perf_counter()
    if isinstance(value, torch.Tensor):
        wire = value.detach().to(_wire_device(value)).contiguous()
        dist.broadcast(wire, src=int(layout(mesh).flat[0]))
        out = wire.to(value.device)
    else:
        box = [value]
        dist.broadcast_object_list(box, src=int(layout(mesh).flat[0]))
        out = box[0]
    obs.counter("mesh.collective_s").add(time.perf_counter() - t0)
    return out


def barrier(mesh) -> None:
    """Wait until every rank of the mesh is here."""
    group = _subgroup(mesh, tuple(mesh.mesh_dim_names))
    if group is None and dist.get_world_size() == 1:
        return
    dist.barrier(group=group)


def is_first(mesh) -> bool:
    """True on the rank whose answers `broadcast_first` hands out."""
    return dist.get_rank() == int(layout(mesh).flat[0])


def agreed_backend(spec, mesh, *, shape=None):
    """The sweep backend ``spec`` names, resolved on rank 0 (where
    "auto" runs its calibration race) and the same on every rank."""
    from .engine import resolve_backend
    dev = rank_device(mesh)
    name = (resolve_backend(spec, device=dev, shape=shape).name
            if is_first(mesh) else None)
    return resolve_backend(broadcast_first(name, mesh), device=dev)


# ------------------------------------------------------------- spawning --

def _rank_main(fn, rank: int, world: int, rdv: str, out_dir: str,
               backend: str, device_type: str, shape, axis_names,
               timeout_s: float, args, kwargs) -> None:
    """One spawned rank: join the group, build the mesh, run ``fn(mesh,
    *args, **kwargs)`` and publish its result (or its traceback)."""
    os.environ["LOCAL_RANK"] = str(rank)
    result_path = os.path.join(out_dir, f"result.{rank}.pt")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{rdv}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(shape, axis_names, device_type=device_type)
            res = fn(mesh, *args, **kwargs)
        finally:
            dist.destroy_process_group()
        torch.save(res, result_path + ".tmp")
        os.replace(result_path + ".tmp", result_path)
    except BaseException:
        with open(os.path.join(out_dir, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class RankError(RuntimeError):
    """A spawned rank failed; the message carries its traceback."""


def spawn_mesh(fn: Callable, shape: Sequence[int],
               axis_names: Sequence[str], *, backend: str = "nccl",
               device_type: str = "cuda", timeout_s: float = 300.0,
               args: tuple = (), kwargs: Optional[dict] = None) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on ``prod(shape)`` spawned ranks
    of a fresh process group and return each rank's result, by rank.

    ``fn`` must be importable (a module-level function) and its result
    picklable.  The ranks meet through a ``file://`` rendezvous in a
    temporary directory; ``timeout_s`` bounds both the group's
    collectives and the whole run: past it every rank still alive is
    killed and `TimeoutError` is raised, so a hang fails instead of
    stalling.  A rank that raises fails the run with its traceback
    (`RankError`), the others killed at once."""
    world = math.prod(int(s) for s in shape)
    if device_type == "cuda":
        resolve_device("cuda")          # no card: raise before spawning
    ctx = mp.get_context("spawn")
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world, rdv, tmp, backend, device_type,
                  tuple(shape), tuple(axis_names), timeout_s, args,
                  kwargs or {}))
            for r in range(world)]
        for p in procs:
            p.start()
        try:
            while True:
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a rank's failure fails its peers' collectives: give
                    # them a moment to report, so the first cause shows
                    grace = time.monotonic() + 2.0
                    while time.monotonic() < grace and any(
                            p.is_alive() for p in procs):
                        time.sleep(0.02)
                    failed = [r for r, p in enumerate(procs)
                              if p.exitcode not in (None, 0)]
                    raise RankError(_failure(tmp, procs, failed))
                if all(p.exitcode == 0 for p in procs):
                    break
                if time.monotonic() > deadline:
                    alive = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(
                        f"spawn_mesh: ranks {alive} still running after "
                        f"{timeout_s} s; killed")
                time.sleep(0.02)
            return [torch.load(os.path.join(tmp, f"result.{r}.pt"),
                               weights_only=False) for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5.0)


def _failure(tmp: str, procs, failed) -> str:
    lines = []
    for r in failed:
        path = os.path.join(tmp, f"error.{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"rank {r} raised:\n{f.read()}")
        else:
            lines.append(f"rank {r} exited with code {procs[r].exitcode}")
    return "spawn_mesh: " + "\n".join(lines)
