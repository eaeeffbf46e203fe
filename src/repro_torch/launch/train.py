"""End-to-end training driver — counterpart of `repro.launch.train`.

Wires the layers together: config registry → host mesh → parameters
from ``--seed`` (a `torch.Generator` on the device) → data pipeline →
train step → checkpoint/restart (atomic, async) → straggler monitor.
Runs on the card unless ``--device cpu``; ``--reduced`` (same model
family, small dims) is the CPU smoke size.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 20 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt

Restart semantics: rerunning the same command resumes from the latest
checkpoint (crash = lose at most ``--ckpt-every`` steps of work).  The
resumed run continues the same token stream (the batches of the steps
already taken are drawn and skipped), so it takes the steps the
uninterrupted run would have taken, bit for bit where the device's
kernels are deterministic; the reference reseeds the stream at ``seed +
start`` instead.

On a mesh of more than one rank (``torchrun --nproc-per-node N … 
--model-parallel M``: a (N / gcd(M, N), gcd(M, N)) ("data", "model")
mesh, `make_host_mesh`; ``--production-mesh``: the 16×16 pod mesh) every
decoder family trains sharded under the active profile
(`sharding.spmd`): every rank draws the same global parameters from
``--seed`` and keeps its blocks, draws the same global batches and takes
its rows, and the checkpoint is the reference's global leaves, written
and read block by block (`CheckpointManager.save(shardings=)`), so a
mesh of another shape — fewer ranks after a failure — restores it.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import time

import numpy as np
import torch

from .. import mesh as M
from ..configs import get_config, reduced as reduced_cfg
from ..data.lm import synthetic_token_batches
from ..device import resolve_device
from ..ft.checkpoint import CheckpointManager
from ..ft.elastic import StragglerMonitor
from ..models import DecoderLM, EncDecLM
from ..models.params import (assign_state, n_params, nest, to_reference,
                             to_state, tree_paths, tree_pspecs)
from ..optim import cosine_schedule
from ..optim.optimizers import make as make_opt
from ..sharding import spmd
from ..sharding.rules import block_of, profile_context
from ..train import TrainState, init_train_state, make_train_step
from ..train.step import (_at, param_groups, state_from_reference,
                          train_state_to_reference)
from . import specs as S
from .mesh import make_host_mesh, make_production_mesh, mesh_shape


def _sharded_mesh(mesh):
    """The mesh when it has more than one rank (the sharded path)."""
    return mesh if mesh is not None and M.mesh_size(mesh) > 1 else None


def build(cfg, mesh=None, *, optimizer="adamw", lr=3e-4, warmup=100,
          total_steps=10_000, microbatches=1, seed=0, device="cuda",
          params=None):
    """(state, step_fn) — shared with examples.  The parameters come
    from ``seed`` through a `torch.Generator` on ``device``, or are the
    given model ``params`` (e.g. one whose routers were seeded), made
    trainable.  ``mesh`` of one rank (or None) places nothing on one
    card; of more, the model is this rank's blocks under the active
    profile — of the very tensors one rank would draw from ``seed``, or
    cut from the whole model ``params`` — on this rank's device
    (``device`` names its type)."""
    dev = resolve_device(device)
    opt = make_opt(optimizer)
    sharded = _sharded_mesh(mesh)
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    if sharded is not None:
        spmd.check_ranks(sharded)
        if dev.type == "cuda":
            dev = M.rank_device(sharded)
        if params is None:
            params = cls(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev, mesh=sharded)
        elif getattr(params, "mesh", None) is None:
            params = shard_model(params, sharded, dev)
    elif params is None:
        params = cls(cfg, torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    params.requires_grad_(True)
    state = init_train_state(params, opt)
    step = make_train_step(
        cfg, opt,
        lambda s: cosine_schedule(s, peak=lr, warmup=warmup,
                                  total=total_steps),
        microbatches=microbatches)
    return state, step


def shard_model(model, mesh, device=None):
    """A whole ``DecoderLM``'s or ``EncDecLM``'s blocks for this rank of
    ``mesh`` under the active profile: a sharded model of its class
    (requires_grad off)."""
    cfg = model.cfg
    dev = device or next(model.parameters()).device
    out = type(model)(cfg, device=dev, mesh=mesh)
    decl = S.model_decl(cfg)
    rank = torch.distributed.get_rank()
    specs = tree_paths(tree_pspecs(decl, mesh))
    blocks = {p: block_of(v, specs[p], mesh, rank).to(dev).contiguous()
              for p, v in tree_paths(to_reference(model, decl)).items()}
    assign_state(out, to_state(nest(blocks)))
    return out


def sharded_checkpoint_tree(state: TrainState) -> TrainState:
    """A sharded state as the reference's ``TrainState`` of this rank's
    stacked blocks (CPU tensors), for `CheckpointManager.save(shardings=)`
    with `launch.specs.train_state_pspecs` (AdamW or Adafactor)."""
    ref = train_state_to_reference(state)
    return TrainState(ref["params"], ref["opt_state"], ref["step"])


def restore_sharded(mgr: CheckpointManager, state: TrainState, optimizer,
                    step=None) -> TrainState:
    """``state`` (sharded) with this rank's blocks of the checkpoint's
    global leaves (the latest, or ``step``) copied into its tensors: a
    checkpoint written on a mesh of any shape, or by the reference."""
    model = state.params
    with profile_context(model.profile):
        specs = S.train_state_pspecs(model.cfg, optimizer, model.mesh)
    got = mgr.restore(sharded_checkpoint_tree(state), step,
                      shardings=(model.mesh, specs))
    load_reference_blocks(state, got)
    return TrainState(state.params, state.opt_state, got.step.clone())


def load_reference_blocks(state: TrainState, ref: TrainState) -> None:
    """Copy a reference-layout tree of this rank's stacked blocks (params,
    opt_state) into the live state's tensors."""
    groups = param_groups(state.params)
    flat = tree_paths(ref.params)
    with torch.no_grad():
        for path, g in groups.items():
            t = flat[path].reshape((len(g.parts),) + tuple(g.parts[0].shape))
            for part, blk in zip(g.parts, t):
                part.copy_(blk)
    opt = {k: (v if k == "count" else
               {p: _at(v, p) for p in groups})
           for k, v in ref.opt_state.items()}
    _into(state.opt_state, state_from_reference(opt, groups))


def _into(have, saved):
    """Copy the tree ``saved`` into the tensors of the tree ``have``."""
    if isinstance(have, dict):
        for k in have:
            _into(have[k], saved[k])
    elif isinstance(have, list):
        for a, b in zip(have, saved):
            _into(a, b)
    else:
        with torch.no_grad():
            have.copy_(saved)


def checkpoint_tree(state: TrainState) -> TrainState:
    """The state as a tree of tensors for `CheckpointManager`: the
    model's state dict (its keys in order), the optimizer state, the
    step."""
    return TrainState(collections.OrderedDict(state.params.state_dict()),
                      state.opt_state, state.step)


def restore(mgr: CheckpointManager, state: TrainState,
            step=None) -> TrainState:
    """``state`` with the checkpoint's values (the latest, or ``step``)
    copied into its tensors."""
    live = checkpoint_tree(state)
    got = mgr.restore(live, step)
    with torch.no_grad():
        for name, t in got.params.items():
            live.params[name].copy_(t)
    _into(state.opt_state, got.opt_state)
    return TrainState(state.params, state.opt_state, got.step.clone())


def train(cfg, mesh=None, *, steps, batch, seq, ckpt_dir=None,
          ckpt_every=50, optimizer="adamw", lr=3e-4, microbatches=1,
          seed=0, log_every=10, log_fn=print, device="cuda", params=None,
          on_step=None):
    """Train ``steps`` steps of ``batch`` × ``seq`` synthetic tokens from
    ``seed``, checkpointing every ``ckpt_every`` steps into ``ckpt_dir``
    (resuming from its latest checkpoint) → (state, losses).  On a mesh
    of more than one rank every rank calls it alike (SPMD), under the
    profile to shard by (`sharding.profile_context`).  ``params`` (a
    whole model) replaces the draw from ``seed`` (`build`);
    ``on_step(i, metrics)`` sees each step's metrics."""
    shape = mesh_shape(mesh) if mesh is not None else {"data": 1,
                                                       "model": 1}
    sharded = _sharded_mesh(mesh)
    state, step_fn = build(
        cfg, mesh, optimizer=optimizer, lr=lr, total_steps=max(steps, 2),
        microbatches=microbatches, seed=seed, device=device, params=params)
    log_fn(f"params: {n_params(S.model_decl(cfg)):,}  mesh: {shape}")

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    specs = None
    if sharded is not None and mgr:
        specs = S.train_state_pspecs(cfg, optimizer, sharded)

    def save(n):
        if specs is None:
            mgr.save(n, checkpoint_tree(state))
        else:
            mgr.save(n, sharded_checkpoint_tree(state),
                     shardings=(sharded, specs))
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = (restore(mgr, state) if specs is None
                 else restore_sharded(mgr, state, optimizer))
        log_fn(f"restored checkpoint step={start}")

    mon = StragglerMonitor()
    history = []
    data = itertools.islice(
        synthetic_token_batches(cfg.vocab, batch, seq, steps=steps,
                                seed=seed), start, None)
    try:
        for i, (tokens, labels) in enumerate(data, start=start):
            mon.start()
            state, metrics = step_fn(state, {"tokens": tokens,
                                             "labels": labels})
            loss = float(metrics["loss"])        # waits for the step
            mon.stop()
            if on_step is not None:
                on_step(i, metrics)
            history.append(loss)
            if i % log_every == 0 or i == steps - 1:
                log_fn(f"step {i:5d}  loss {loss:.4f}  "
                       f"gnorm {float(metrics['grad_norm']):.3f}  "
                       f"lr {float(metrics['lr']):.2e}")
            if mgr and (i + 1) % ckpt_every == 0:
                save(i + 1)
        if mgr:
            save(steps)
    finally:
        if mgr:
            mgr.wait()              # a crash keeps the write in flight
    return state, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 pod mesh (needs 256 ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_cfg(cfg)
    dev = resolve_device(args.device)
    mesh = (make_production_mesh(device_type=dev.type)
            if args.production_mesh
            else make_host_mesh(args.model_parallel, device_type=dev.type))
    first = M.is_first(mesh)

    t0 = time.time()
    _, history = train(cfg, mesh, steps=args.steps, batch=args.batch,
                       seq=args.seq, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, optimizer=args.optimizer,
                       lr=args.lr, microbatches=args.microbatches,
                       seed=args.seed, device=dev,
                       log_fn=print if first else lambda *a: None)
    dt = time.time() - t0
    if not first:
        return

    def mean(xs):
        return round(float(np.mean(xs)), 4) if xs else None
    first = history[:10] if len(history) >= 10 else history[:1]
    print(json.dumps({"arch": cfg.name, "steps": len(history),
                      "wall_s": round(dt, 1),
                      "loss_first10": mean(first),
                      "loss_last10": mean(history[-10:])}))


if __name__ == "__main__":
    main()
