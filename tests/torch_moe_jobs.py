"""The rank side of tests/test_torch_moe_ep.py: what each spawned rank
of an 8-rank (2, 4) ("data", "model") gloo CPU mesh runs
(`repro_torch.mesh.spawn_mesh` imports this module in every rank, so it
loads torch and `repro_torch` only, never jax)."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import mesh as M
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as TM
from repro_torch.sharding import local_block, mesh_context, profile_context

EXPERT_SPEC = ("model", None, None)     # the reference's shard_map in_spec


def moe_cfg(cf: float):
    """tests/test_padding_profiles.py:121's: reduced OLMoE, 8 experts,
    top-2, capacity factor ``cf``."""
    return dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                               n_experts=8, top_k=2, capacity_factor=cf)


def _leaf(a):
    return torch.tensor(np.ascontiguousarray(a)).requires_grad_(True)


def run_case(mesh, cfg, arrays, profile: str) -> dict:
    """`moe` under ``profile`` on this rank's blocks of the case's x and
    expert weights; the backward of sum(y·g) → this rank's y, its
    gradients (x block, w_router, its expert slices), the branch, the
    pairs it keeps (flat (token, k) order of its block: under a2a of its
    own tokens, under tp those of its own experts) and the bytes its
    collectives moved."""
    rank = dist.get_rank()
    b = arrays["x"].shape[0]
    a2a_bytes = obs.counter("mesh.all_to_all_bytes")
    gathered = obs.counter("mesh.gathered_bytes")
    a0, g0 = a2a_bytes.value, gathered.value
    with mesh_context(mesh), profile_context(profile):
        branch = TM.ep_branch(cfg, mesh, b)
        xspec = (TM.ep_batch_axes(branch, mesh), None, None)
        x = _leaf(local_block(arrays["x"], xspec, mesh, rank))
        p = {"w_router": _leaf(arrays["w_router"]),
             "w_in": _leaf(local_block(arrays["w_in"], EXPERT_SPEC, mesh,
                                       rank)),
             "w_out": _leaf(local_block(arrays["w_out"], EXPERT_SPEC, mesh,
                                        rank))}
        y = TM.moe(cfg, p, x, global_batch=b)
        g = torch.tensor(np.ascontiguousarray(
            local_block(arrays["g"], xspec, mesh, rank)))
        (y * g).sum().backward()
    with torch.no_grad():
        xt = x.detach().reshape(-1, x.shape[-1])
        _, eidx = TM.route(cfg, p["w_router"].detach(), xt)
        if branch == "a2a":
            dp = TM.dispatch(cfg, eidx, cap=TM.a2a_capacity(cfg, xt.shape[0]))
        else:   # the pairs of this rank's experts that it keeps
            dp = TM.dispatch(cfg, eidx, n_ranks=M.axis_sizes(mesh)["model"],
                             rank=M.block_index(mesh, ("model",))[0])
        valid = np.zeros(eidx.numel(), bool)
        valid[dp.order.numpy()] = dp.valid.numpy()
    return {"branch": branch, "xspec": xspec, "y": y.detach().numpy(),
            "gx": x.grad.numpy(), "g_router": p["w_router"].grad.numpy(),
            "g_in": p["w_in"].grad.numpy(), "g_out": p["w_out"].grad.numpy(),
            "w_in": p["w_in"].detach().numpy(), "valid": valid,
            "a2a_bytes": a2a_bytes.value - a0,
            "gathered_bytes": gathered.value - g0}


def run_all(mesh, cases, probe) -> dict:
    """Every (case, profile) of ``cases`` ({name: (cf, arrays)}), then
    `all_to_all` of this rank's block of the integer ``probe`` over
    "model" (blocks split over ("data", "model"))."""
    torch.set_num_threads(1)
    out = {}
    for name, (cf, arrays) in cases.items():
        for profile in ("tp", "fsdp"):
            out[name, profile] = run_case(mesh, moe_cfg(cf), arrays, profile)
    blk = local_block(probe, (("data", "model"),), mesh, dist.get_rank())
    out["probe"] = M.all_to_all(torch.tensor(np.ascontiguousarray(blk)),
                                mesh, "model").numpy()
    return out
