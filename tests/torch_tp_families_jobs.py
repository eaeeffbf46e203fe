"""The rank side of tests/test_torch_tp_families.py: what each spawned rank
of a gloo CPU mesh runs (`repro_torch.mesh.spawn_mesh` imports this module
in every rank, so it loads torch and `repro_torch` only, never jax)."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import mesh as M
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.data.lm import synthetic_token_batches
from repro_torch.ft import CheckpointManager
from repro_torch.ft.checkpoint import _flatten_with_paths, flatten_specs
from repro_torch.launch.specs import train_state_pspecs
from repro_torch.launch.train import (build, restore_sharded,
                                      sharded_checkpoint_tree, train)
from repro_torch.models import DecoderLM, EncDecLM
from repro_torch.models.params import from_reference, tree_paths
from repro_torch.sharding import profile_context

NAMES = ("data", "model")
COUNTERS = ("param_gather_bytes", "reduce_scatter_bytes", "psum_bytes",
            "all_to_all_bytes")


def config(arch: str):
    return reduced(get_config(arch))


def whole_model(cfg, params):
    """The one-rank model of the reference's parameter tree."""
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    model = cls(cfg, device="cpu")
    model.load_state_dict(from_reference(params, device="cpu"))
    return model


def batches(cfg, steps, batch, seq, seed=0, frame_seed=1) -> list:
    """The reference ``train``'s batches of ``seed`` (tokens, labels),
    with N(0, 1) frames of ``frame_seed`` for the encoder–decoder."""
    rng = np.random.default_rng(frame_seed)
    out = []
    for tokens, labels in synthetic_token_batches(cfg.vocab, batch, seq,
                                                  steps=steps, seed=seed):
        b = {"tokens": tokens, "labels": labels}
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def blocks(state) -> dict:
    """This rank's stacked blocks of the parameters, by reference path."""
    tree = sharded_checkpoint_tree(state)
    return {k: v.numpy() for k, v in tree_paths(tree.params).items()}


def run_case(mesh, arch, params, profile, steps, batch, seq) -> dict:
    """A case from the reference's ``params`` on this mesh under
    ``profile``: the decoders through `launch.train.train`, the
    encoder–decoder through `build` and its step on batches with frames
    → losses, grad norms, this rank's blocks after the last step, the
    bytes its collectives moved by kind, and the state."""
    cfg = config(arch)
    counters = {k: obs.counter("mesh." + k) for k in COUNTERS}
    before = {k: c.value for k, c in counters.items()}
    norms, losses = [], []
    with profile_context(profile):
        model = whole_model(cfg, params)
        if cfg.family == "encdec":
            state, step = build(cfg, mesh, device="cpu", params=model,
                                total_steps=max(steps, 2))
            for b in batches(cfg, steps, batch, seq):
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        else:
            state, losses = train(
                cfg, mesh, steps=steps, batch=batch, seq=seq, device="cpu",
                params=model, log_fn=lambda *a: None,
                on_step=lambda i, m: norms.append(float(m["grad_norm"])))
    return {"losses": losses, "grad_norms": norms, "blocks": blocks(state),
            "bytes": {k: c.value - before[k] for k, c in counters.items()},
            "state": state}


def restore_elsewhere(mesh, arch, profile, state, ckpt_dir, shape) -> dict:
    """``state`` saved sharded on this mesh into ``ckpt_dir``, then
    restored onto a mesh of ``shape`` over the same ranks
    (`restore_sharded` into a model built there) → this rank's restored
    blocks and their placements there."""
    cfg = config(arch)
    with profile_context(profile):
        CheckpointManager(ckpt_dir).save(
            int(state.step), sharded_checkpoint_tree(state),
            shardings=(mesh, train_state_pspecs(cfg, "adamw", mesh)))
        new = M.make_mesh(shape, NAMES, device_type="cpu")
        fresh, _ = build(cfg, new, device="cpu", seed=1)
        got = restore_sharded(CheckpointManager(ckpt_dir), fresh, "adamw")
        specs = dict(flatten_specs(train_state_pspecs(cfg, "adamw", new)))
        restored = {k: v.numpy().copy() for k, v in _flatten_with_paths(
            sharded_checkpoint_tree(got))}
    return {"restored": restored, "specs": specs, "step": int(got.step),
            "mesh": (tuple(new.mesh_dim_names), new.mesh.tolist())}


def run_cases(mesh, cases, saves=(), ckpt_root=None) -> dict:
    """`run_case` for each (name, arch, params, profile, steps, batch,
    seq) of ``cases``; for each (name, restore shape) of ``saves``, that
    case's state saved and restored there (`restore_elsewhere`) under
    ``ckpt_root``/name."""
    torch.set_num_threads(1)
    saves = dict(saves)
    out = {}
    for name, arch, params, profile, steps, batch, seq in cases:
        rec = run_case(mesh, arch, params, profile, steps, batch, seq)
        state = rec.pop("state")
        if name in saves:
            rec["restore"] = restore_elsewhere(
                mesh, arch, profile, state, f"{ckpt_root}/{name}",
                saves[name])
        out[name] = rec
        del state
    out["rank"] = dist.get_rank()
    return out
