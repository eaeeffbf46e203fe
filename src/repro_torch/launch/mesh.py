"""Mesh construction — counterpart of `repro.launch.mesh` over
`repro_torch.mesh`.

Defined as functions, so importing this module touches no device and
joins no process group."""
from __future__ import annotations

import math
import os

import torch.distributed as dist

from .. import mesh as M


def _join(device_type: str) -> None:
    """Join this process's group: the one ``torchrun`` describes in the
    environment (NCCL on cards, gloo on the CPU), else a one-rank gloo
    group over an in-process store (no network, no files)."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's pod mesh: 16×16 ("data", "model"), or 2×16×16
    ("pod", "data", "model") with ``multi_pod``, over the first 256 (512)
    ranks of the process group — torchrun's, or the "fake" group of 256
    or 512 ranks the dry run joins (`launch.dryrun.join_fake_group`),
    which this joins nothing beside.  Fewer ranks raise `RuntimeError`,
    as the reference does with fewer devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", 1))
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {world} — launch "
            f"{n} ranks (torchrun) to train on it")
    _join(device_type)
    return M.make_mesh(shape, axes, device_type=device_type,
                       ranks=range(n))


def make_host_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """A ("data", "model") mesh over the process group's ranks: mp =
    gcd(``model_parallel``, world size) ranks a replica, (world / mp,
    mp) — the reference's rule over its devices; one card gives (1, 1).
    Without a process group this process joins one (`_join`: torchrun's,
    or a one-rank group)."""
    _join(device_type)
    n = dist.get_world_size()
    mp = math.gcd(int(model_parallel), n)
    return M.make_mesh((n // mp, mp), ("data", "model"),
                       device_type=device_type)


def mesh_shape(mesh) -> dict:
    """{axis: size} of a mesh (the reference's ``dict(mesh.shape)``)."""
    return M.axis_sizes(mesh)
