"""Mesh construction — counterpart of `repro.launch.mesh` over
`repro_torch.mesh`.

Defined as functions, so importing this module touches no device and
joins no process group."""
from __future__ import annotations

import torch.distributed as dist

from .. import mesh as M

ITEM_3D = ("ROADMAP Queue 1 item 3d iv (the sharded LM's model-parallel "
           "training: model-parallel meshes, the production mesh)")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16×16 (data, model) pod mesh: item 3d iv."""
    raise NotImplementedError(f"make_production_mesh comes with {ITEM_3D}")


def make_host_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """A ("data", "model") mesh over the host's ranks: (world size, 1),
    every rank one replica — one card gives (1, 1).  Without a process
    group this process joins a one-rank gloo group over an in-process
    store (no network, no files); under ``torchrun`` the caller's group
    is used.  ``model_parallel`` > 1 is item 3d iv."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {model_parallel}: model-parallel meshes come "
            f"with {ITEM_3D}")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return M.make_mesh((dist.get_world_size(), 1), ("data", "model"),
                       device_type=device_type)


def mesh_shape(mesh) -> dict:
    """{axis: size} of a mesh (the reference's ``dict(mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
