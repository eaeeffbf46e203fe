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
start`` instead.  A single card only: ``--model-parallel`` > 1 and
``--production-mesh`` are ROADMAP Queue 1 item 3d iv.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import time

import numpy as np
import torch

from ..configs import get_config, reduced as reduced_cfg
from ..data.lm import synthetic_token_batches
from ..device import resolve_device
from ..ft.checkpoint import CheckpointManager
from ..ft.elastic import StragglerMonitor
from ..models import DecoderLM, EncDecLM
from ..models.params import n_params
from ..optim import cosine_schedule
from ..optim.optimizers import make as make_opt
from ..train import TrainState, init_train_state, make_train_step
from . import specs as S
from .mesh import ITEM_3D, make_host_mesh, make_production_mesh, mesh_shape


def build(cfg, mesh=None, *, optimizer="adamw", lr=3e-4, warmup=100,
          total_steps=10_000, microbatches=1, seed=0, device="cuda",
          params=None):
    """(state, step_fn) — shared with examples.  The parameters come
    from ``seed`` through a `torch.Generator` on ``device``, or are the
    given model ``params`` (e.g. one whose routers were seeded), made
    trainable.  ``mesh`` (a one-replica host mesh, or None) places
    nothing on one card."""
    dev = resolve_device(device)
    opt = make_opt(optimizer)
    if params is None:
        cls = EncDecLM if cfg.family == "encdec" else DecoderLM
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

    def into(have, saved):
        if isinstance(have, dict):
            for k in have:
                into(have[k], saved[k])
        elif isinstance(have, list):
            for a, b in zip(have, saved):
                into(a, b)
        else:
            with torch.no_grad():
                have.copy_(saved)

    into(state.opt_state, got.opt_state)
    return TrainState(state.params, state.opt_state, got.step.clone())


def train(cfg, mesh=None, *, steps, batch, seq, ckpt_dir=None,
          ckpt_every=50, optimizer="adamw", lr=3e-4, microbatches=1,
          seed=0, log_every=10, log_fn=print, device="cuda"):
    shape = mesh_shape(mesh) if mesh is not None else {"data": 1,
                                                       "model": 1}
    if any(n > 1 for n in shape.values()):
        raise NotImplementedError(
            f"train on a {shape} mesh: sharded and multi-rank training "
            f"through launch.train come with {ITEM_3D}; a data-parallel "
            "step over ranks is train.dp.make_dp_train_step")
    state, step_fn = build(
        cfg, mesh, optimizer=optimizer, lr=lr, total_steps=max(steps, 2),
        microbatches=microbatches, seed=seed, device=device)
    log_fn(f"params: {n_params(S.model_decl(cfg)):,}  mesh: {shape}")

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = restore(mgr, state)
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
            history.append(loss)
            if i % log_every == 0 or i == steps - 1:
                log_fn(f"step {i:5d}  loss {loss:.4f}  "
                       f"gnorm {float(metrics['grad_norm']):.3f}  "
                       f"lr {float(metrics['lr']):.2e}")
            if mgr and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, checkpoint_tree(state))
        if mgr:
            mgr.save(steps, checkpoint_tree(state))
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
                    help="16x16 pod mesh (ROADMAP Queue 1 item 3d iv)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_cfg(cfg)
    dev = resolve_device(args.device)
    mesh = (make_production_mesh() if args.production_mesh
            else make_host_mesh(args.model_parallel, device_type=dev.type))

    t0 = time.time()
    _, history = train(cfg, mesh, steps=args.steps, batch=args.batch,
                       seq=args.seq, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, optimizer=args.optimizer,
                       lr=args.lr, microbatches=args.microbatches,
                       seed=args.seed, device=dev)
    dt = time.time() - t0

    def mean(xs):
        return round(float(np.mean(xs)), 4) if xs else None
    first = history[:10] if len(history) >= 10 else history[:1]
    print(json.dumps({"arch": cfg.name, "steps": len(history),
                      "wall_s": round(dt, 1),
                      "loss_first10": mean(first),
                      "loss_last10": mean(history[-10:])}))


if __name__ == "__main__":
    main()
