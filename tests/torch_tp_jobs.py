"""The rank side of tests/test_torch_tp.py and tests/test_torch_elastic.py:
what each spawned rank of a gloo CPU mesh runs (`repro_torch.mesh.
spawn_mesh` imports this module in every rank, so it loads torch and
`repro_torch` only, never jax)."""
import dataclasses

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


# the sequence split's configs: an arch's reduced config with fields
# replaced — OLMoE at one MoE layer and cf 8 (no pair dropped), Qwen2
# with a KV chunk of 4 positions, under a rank's block of 8
VARIANTS = {"olmoe-1l": ("olmoe-1b-7b", dict(n_layers=1,
                                             capacity_factor=8.0)),
            "qwen2-chunk": ("qwen2-1.5b", dict(attn_chunk=4))}


def config(arch: str) -> ModelConfig:
    """A case's port config: an arch's reduced config, a `VARIANTS`
    entry, or "padded"."""
    if arch == "padded":
        return ModelConfig(**PADDED)
    if arch in VARIANTS:
        base, kw = VARIANTS[arch]
        return dataclasses.replace(reduced(get_config(base)), **kw)
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
        "all_to_all_bytes", "seq_gather_bytes")}
    before = {k: c.value for k, c in counters.items()}
    with profile_context(profile):
        state, losses = train(
            cfg, mesh, steps=steps, batch=batch, seq=seq, device="cpu",
            params=whole_model(cfg, params), log_fn=lambda *a: None,
            on_step=lambda i, m: norms.append(float(m["grad_norm"])),
            **(opts or {}))
    return {"losses": losses, "grad_norms": norms, "blocks": blocks(state),
            "bytes": {k: c.value - before[k] for k, c in counters.items()}}


def run_cases(mesh, cases, probes: bool = False, seed: int = 0,
              prefix=None) -> dict:
    """`run_train` for each (name, arch, params, profile, steps, batch,
    seq, train's options) of ``cases``, and `run_prefix` of ``prefix``
    (name, params, batches) if given; with ``probes``, then
    `collectives`, `meshes` and `run_remesh` of the first case's arch and
    params under "tp", and `seq_witness` of the dense and MoE archs."""
    torch.set_num_threads(1)
    out = {c[0]: run_train(mesh, *c[1:]) for c in cases}
    if prefix is not None:
        out[prefix[0]] = run_prefix(mesh, *prefix[1:])
    if probes:
        params = {c[1]: c[2] for c in cases}
        out["collectives"] = collectives(mesh, seed)
        out["meshes"] = meshes(mesh)
        out["remesh"] = run_remesh(mesh, cases[0][1], cases[0][2], "tp")
        out["thread"] = backward_in_a_thread(mesh, cases[0][1], cases[0][2])
        out["witness"] = {a: seq_witness(mesh, a, params[a])
                          for a in ("qwen2-1.5b", "olmoe-1l")}
        out["prefix"] = prefix_step(mesh)
    return out


def prefix_batches(cfg, steps: int) -> list:
    """``steps`` batches of 4 rows of 4 patch embeddings and 12 tokens:
    16 positions, 4 a rank of "model" — the first rank's block all
    prefix, no label."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(steps):
        tokens = rng.integers(0, cfg.vocab, (4, 12))
        out.append({"tokens": tokens, "labels": np.roll(tokens, -1, 1),
                    "patch_embeds": rng.normal(
                        size=(4, cfg.n_patches, cfg.d_model)
                    ).astype(np.float32)})
    return out


def prefix_batch(cfg):
    """The first of `prefix_batches`."""
    return prefix_batches(cfg, 1)[0]


def run_prefix(mesh, params, batches) -> dict:
    """Reduced Pixtral under "fsdp" on this mesh from the reference's
    ``params``: `build` and its step on each of ``batches`` (the step's
    total of max(steps, 2), as the reference's) → losses, grad norms,
    this rank's blocks after the last step and the bytes its collectives
    moved by kind."""
    cfg = config("pixtral-12b")
    counters = {k: obs.counter("mesh." + k) for k in (
        "param_gather_bytes", "psum_bytes", "seq_gather_bytes")}
    before = {k: c.value for k, c in counters.items()}
    losses, norms = [], []
    with profile_context("fsdp"):
        state, step = build(cfg, mesh, device="cpu",
                            params=whole_model(cfg, params),
                            total_steps=max(len(batches), 2))
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "blocks": blocks(state),
            "bytes": {k: c.value - before[k] for k, c in counters.items()}}


def prefix_step(mesh) -> tuple:
    """One AdamW step of reduced Pixtral (4 patch embeddings) under
    "fsdp" on this mesh, from the draw of seed 0, on `prefix_batch` →
    (loss, grad norm)."""
    cfg = config("pixtral-12b")
    whole = DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
    with profile_context("fsdp"):
        state, step = build(cfg, mesh, device="cpu", params=whole)
        _, m = step(state, prefix_batch(cfg))
    return float(m["loss"]), float(m["grad_norm"])


def seq_witness(mesh, arch, params) -> dict:
    """A forward of a batch of 4 on this (2, 4) mesh under "fsdp" (rows
    split over "data" only), at 32 positions and at 30 ("model" does not
    divide it) → {positions: (this rank's hidden state's shape, its
    sequence block as a tuple or None, the bytes its sequence gathers
    moved)}."""
    from repro_torch.models.transformer import split_length
    from repro_torch.sharding import mesh_context, spmd
    from repro_torch.sharding.rules import get_seq
    cfg = config(arch)
    with profile_context("fsdp"):
        state, _ = build(cfg, mesh, device="cpu",
                         params=whole_model(cfg, params))
    out = {}
    for seq in (32, 30):
        tokens, _ = next(synthetic_token_batches(cfg.vocab, 4, seq,
                                                 steps=1, seed=5))
        moved = obs.counter("mesh.seq_gather_bytes")
        before = moved.value
        with mesh_context(mesh), profile_context("fsdp"), \
                spmd.rows(4, mesh, split_length(cfg, {"tokens": tokens})), \
                torch.no_grad():
            blk = get_seq()
            hidden = state.params(torch.as_tensor(M.shard_rows(
                tokens, mesh, spmd.batch_axes(mesh))))
        out[seq] = (tuple(hidden.shape), None if blk is None
                    else tuple(blk), moved.value - before)
    return out


def backward_in_a_thread(mesh, arch, params) -> bool:
    """The sharded loss's gradients with the backward run on a fresh
    thread, which sees none of this thread's contexts — as autograd's
    device thread runs a CUDA backward (and with it each rematted block's
    recompute) — equal to those of a backward on this thread: under
    "tp" on a batch of 8, and under "fsdp" on a batch of 4, whose rows
    split over "data" only and whose 16 positions over "model" (the
    recompute re-enters the rows and the sequence block too)."""
    from repro_torch.models.transformer import split_length
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
                    spmd.rows(rows, mesh,
                              split_length(cfg, {"tokens": tokens})):
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
    # scatter_seq over "model" along dim 1: the summed block; its
    # backward gathers the cotangent
    x = t.clone().requires_grad_(True)
    blk = M.scatter_seq(x, 1, mesh, ("model",))
    (blk * (1 + torch.arange(blk.numel(), dtype=torch.float32)
            .reshape(blk.shape))).sum().backward()
    out["scatter_seq"] = (blk.detach(), x.grad)
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
