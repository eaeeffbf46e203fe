"""The rank side of tests/test_torch_tp.py and tests/test_torch_elastic.py:
what each spawned rank of a gloo CPU mesh runs (`repro_torch.mesh.
spawn_mesh` imports this module in every rank, so it loads torch and
`repro_torch` only, never jax)."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import mesh as M
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm import synthetic_token_batches
from repro_torch.ft import CheckpointManager, elastic_remesh, make_mesh_for
from repro_torch.ft.checkpoint import _flatten_with_paths, flatten_specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.specs import train_state_pspecs
from repro_torch.launch.train import (build, restore_sharded,
                                      sharded_checkpoint_tree, train)
from repro_torch.models import DecoderLM
from repro_torch.models.params import from_reference, tree_paths
from repro_torch.sharding import profile_context

# the head-padded dense config of tests/test_torch_models.py: 6 Q heads
# over 2 KV heads padded to 8, vocab 250 padded to 256
PADDED = dict(name="padded", family="dense", n_layers=2, d_model=48,
              n_heads=6, n_kv_heads=2, d_ff=96, vocab=250, head_dim=8,
              qkv_bias=True, compute_dtype="float32",
              param_dtype="float32", attn_chunk=0, head_pad_quantum=4)


def config(arch: str) -> ModelConfig:
    """A case's port config: an arch's reduced config, or "padded"."""
    if arch == "padded":
        return ModelConfig(**PADDED)
    return reduced(get_config(arch))


def whole_model(cfg, params) -> DecoderLM:
    """The one-rank model of the reference's parameter tree."""
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(from_reference(params, device="cpu"))
    return model


def blocks(state) -> dict:
    """This rank's stacked blocks of the parameters, by reference path."""
    tree = sharded_checkpoint_tree(state)
    return {k: v.numpy() for k, v in tree_paths(tree.params).items()}


def run_train(mesh, arch, params, profile, steps, batch, seq,
              opts=None) -> dict:
    """`launch.train.train` on this mesh under ``profile`` from the
    reference's ``params`` → losses, grad norms, this rank's blocks after
    the last step and the bytes its collectives moved by kind."""
    cfg = config(arch)
    norms = []
    counters = {k: obs.counter("mesh." + k) for k in (
        "param_gather_bytes", "reduce_scatter_bytes", "psum_bytes",
        "all_to_all_bytes")}
    before = {k: c.value for k, c in counters.items()}
    with profile_context(profile):
        state, losses = train(
            cfg, mesh, steps=steps, batch=batch, seq=seq, device="cpu",
            params=whole_model(cfg, params), log_fn=lambda *a: None,
            on_step=lambda i, m: norms.append(float(m["grad_norm"])),
            **(opts or {}))
    return {"losses": losses, "grad_norms": norms, "blocks": blocks(state),
            "bytes": {k: c.value - before[k] for k, c in counters.items()}}


def run_cases(mesh, cases, probes: bool = False, seed: int = 0) -> dict:
    """`run_train` for each (name, arch, params, profile, steps, batch,
    seq, train's options) of ``cases``; with ``probes``, then
    `collectives`, `meshes` and `run_remesh` of the first case's arch and
    params under "tp"."""
    torch.set_num_threads(1)
    out = {c[0]: run_train(mesh, *c[1:]) for c in cases}
    if probes:
        out["collectives"] = collectives(mesh, seed)
        out["meshes"] = meshes(mesh)
        out["remesh"] = run_remesh(mesh, cases[0][1], cases[0][2], "tp")
        out["thread"] = backward_in_a_thread(mesh, cases[0][1], cases[0][2])
    return out


def backward_in_a_thread(mesh, arch, params) -> bool:
    """The sharded loss's gradients with the backward run on a fresh
    thread, which sees none of this thread's contexts — as autograd's
    device thread runs a CUDA backward (and with it each rematted block's
    recompute) — equal to those of a backward on this thread: under
    "tp" on a batch of 8, and under "fsdp" on a batch of 4, whose rows
    split over "data" only (the recompute re-enters the rows too)."""
    import threading
    from repro_torch.sharding import mesh_context, spmd
    from repro_torch.train.step import model_loss, on_device
    torch.set_num_threads(1)
    cfg = config(arch)
    same = True
    for profile, rows in (("tp", 8), ("fsdp", 4)):
        with profile_context(profile):
            state, _ = build(cfg, mesh, device="cpu",
                             params=whole_model(cfg, params))
        model = state.params
        tokens, labels = next(synthetic_token_batches(cfg.vocab, rows, 16,
                                                      steps=1, seed=5))
        leaves = list(model.parameters())
        grads = []
        for threaded in (False, True):
            with mesh_context(mesh), profile_context(profile), \
                    spmd.rows(rows, mesh):
                axes = spmd.batch_axes(mesh)
                batch = on_device({"tokens": M.shard_rows(tokens, mesh,
                                                          axes),
                                   "labels": M.shard_rows(labels, mesh,
                                                          axes)},
                                  torch.device("cpu"))
                loss = model_loss(cfg, model, batch)
            box = []
            run = lambda: box.append(torch.autograd.grad(loss, leaves))
            if threaded:
                t = threading.Thread(target=run)
                t.start()
                t.join()
            else:
                run()
            grads.append(box[0])
        same &= all(torch.equal(a, b) for a, b in zip(*grads))
    return same


def collectives(mesh, seed: int) -> dict:
    """The subgroup `psum`, `all_gather` and `reduce_scatter` of this
    rank's seeded (8, 4) f32 tensor over each axis set, beside the same
    from a gather over every rank (the default group) composed here."""
    rank = dist.get_rank()
    t = torch.tensor(np.random.default_rng(seed + rank).normal(
        size=(8, 4)).astype(np.float32))
    world = [None] * dist.get_world_size()
    dist.all_gather_object(world, t)
    out = {}
    for axes in (("model",), ("data",), ("data", "model"),
                 ("model", "data")):
        members = M._group(mesh, axes)
        n = len(members)
        composed = M.sum_in_order([world[r] for r in members])
        out[axes] = {
            "psum": (M.psum(t, mesh, axes), composed),
            "all_gather": (M.all_gather(t, mesh, axes),
                           torch.stack([world[r] for r in members])),
            "reduce_scatter": (M.reduce_scatter(t, mesh, axes, 0),
                               composed.chunk(n, 0)[
                                   M.block_index(mesh, axes)[0]]),
            "reduce_scatter_dim1": (
                M.reduce_scatter(t, mesh, axes, 1) if 4 % n == 0 else None,
                composed.chunk(n, 1)[M.block_index(mesh, axes)[0]]
                if 4 % n == 0 else None)}
    # gather_param's backward is reduce_scatter
    x = t.clone().requires_grad_(True)
    full = M.gather_param(x, 0, mesh, ("data", "model"))
    (full * torch.arange(full.numel(), dtype=torch.float32)
     .reshape(full.shape)).sum().backward()
    out["gather_param"] = (full.detach(), x.grad)
    return out


def meshes(mesh) -> dict:
    """`make_host_mesh` and `make_mesh_for` layouts on this 8-rank world:
    {case: (dim names, rank layout)} (a rank outside a mesh still takes
    part in making it)."""
    out = {}
    for mp in (1, 2, 3, 4, 8, 16):
        m = make_host_mesh(mp, device_type="cpu")
        out["host", mp] = (tuple(m.mesh_dim_names), m.mesh.tolist())
    for n in (8, 6, 4):
        for mp in (2, 4):
            for pods in (1, 2):
                try:
                    m = make_mesh_for(list(range(n)), model_parallel=mp,
                                      pods=pods, device_type="cpu")
                except ValueError:
                    out["for", n, mp, pods] = "raises"
                    continue
                out["for", n, mp, pods] = (tuple(m.mesh_dim_names),
                                           m.mesh.tolist())
    return out


def run_remesh(mesh, arch, params, profile) -> dict:
    """A sharded state on this (2, 4) mesh re-blocked onto (4, 2) by
    `elastic_remesh` (same placements) → this rank's blocks on each."""
    torch.set_num_threads(1)
    cfg = config(arch)
    with profile_context(profile):
        state, _ = build(cfg, mesh, device="cpu",
                         params=whole_model(cfg, params))
        specs = train_state_pspecs(cfg, "adamw", mesh)
        tree = sharded_checkpoint_tree(state)
        new = M.make_mesh((4, 2), ("data", "model"), device_type="cpu")
        got = elastic_remesh(tree, (mesh, specs), new)
    return {"old": {k: v.numpy() for k, v in tree_paths(tree).items()},
            "new": {k: v.numpy() for k, v in tree_paths(got).items()}}


def run_phase1(mesh, arch, params, profile, ckpt_dir, steps, batch, seq,
               ckpt_every) -> list:
    """Train ``steps`` steps on this mesh from the reference's
    ``params``, checkpointing every ``ckpt_every`` → the losses."""
    torch.set_num_threads(1)
    cfg = config(arch)
    with profile_context(profile):
        _, losses = train(cfg, mesh, steps=steps, batch=batch, seq=seq,
                          ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                          device="cpu", params=whole_model(cfg, params),
                          log_fn=lambda *a: None)
    return losses


def run_resume(mesh, arch, profile, ckpt_dir, model_parallel, steps,
               batch, seq, data_seed) -> dict:
    """The restart: `make_mesh_for` over this smaller world, a model
    built on it, the latest checkpoint restored into it
    (`restore_sharded`), then ``steps`` steps over the batches of
    ``data_seed`` → the step restored, this rank's restored blocks, the
    losses."""
    torch.set_num_threads(1)
    cfg = config(arch)
    new = make_mesh_for(list(range(dist.get_world_size())),
                        model_parallel=model_parallel, device_type="cpu")
    with profile_context(profile):
        state, step = build(cfg, new, device="cpu")
        mgr = CheckpointManager(ckpt_dir)
        state = restore_sharded(mgr, state, "adamw")
        restored = {k: v.numpy().copy() for k, v in _flatten_with_paths(
            sharded_checkpoint_tree(state))}
        spec = dict(flatten_specs(train_state_pspecs(cfg, "adamw", new)))
        losses = []
        for tokens, labels in synthetic_token_batches(
                cfg.vocab, batch, seq, steps=steps, seed=data_seed):
            state, m = step(state, {"tokens": tokens, "labels": labels})
            losses.append(float(m["loss"]))
    return {"mesh": (tuple(new.mesh_dim_names), new.mesh.tolist()),
            "step": int(state.step) - steps, "restored": restored,
            "specs": spec, "losses": losses}


def save_two(mesh, root):
    """A sharded save of a leaf split over "data", a replicated one and a
    scalar by this (2,) mesh, then their restore → this rank's block of
    the split leaf, restored."""
    rank = dist.get_rank()
    tree = {"w": torch.arange(12.0).reshape(4, 3)[2 * rank:2 * rank + 2],
            "b": torch.ones(3), "step": torch.tensor(7, dtype=torch.int32)}
    specs = {"w": ("data", None), "b": (None,), "step": ()}
    mgr = CheckpointManager(root)
    mgr.save(7, tree, shardings=(mesh, specs))
    got = mgr.restore({k: torch.zeros_like(v) for k, v in tree.items()},
                      shardings=(mesh, specs))
    return got["w"].reshape(-1).tolist()
