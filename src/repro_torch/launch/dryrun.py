"""The dry run: trace every (arch × shape × mesh × profile) cell's step
as rank 0 of the production mesh — counterpart of `repro.launch.dryrun`.

The reference lowers and compiles each cell's step on 512 forced host
devices.  The port is SPMD, one process a rank, so one process stands
for rank 0: it joins a "fake" process group of 256 (16×16) or 512
(2×16×16) ranks (``torch.testing._internal.distributed.fake_pg``, whose
collectives return at once), builds the production mesh over it, and
runs rank 0's program of the cell — the sharded train step, prefill or
decode step that `repro_torch.train` / `repro_torch.serve` run — on
``FakeTensorMode`` tensors of the card's device type, which hold shapes
and allocate nothing, so Kimi-K2's 1T-parameter step traces on a laptop.
The trace (`launch.roofline.ProgramTrace`) records the c10d collectives
and their bytes by kind, the ops' bytes, the FLOPs
(``FlopCounterMode``) and the peak of the bytes the step's ops hold
live.  A cell's record has the reference's keys, so
``python -m benchmarks.roofline_table --dir <out>`` renders it:

  * ``t_lower_s`` — the seconds of the trace; ``t_compile_s`` is 0
    (nothing is compiled);
  * ``memory_analysis`` per rank: ``argument_size_in_bytes`` the rank's
    blocks of the parameters, optimizer state, batch and caches under
    the reference's placements (`launch.specs.step_arguments`);
    ``output_size_in_bytes`` the step's outputs; ``alias_size_in_bytes``
    the bytes the step updates in place (the train state, the decode
    caches: where the reference donates); ``temp_size_in_bytes`` the
    peak of what the step's ops hold live, beyond the arguments;
  * ``compiled_cost`` — the counted FLOPs and the bytes every op
    dispatched touches (`perf.roofline.compiled_cost`);
  * ``roofline`` — compute and memory terms from the analytic model
    (`launch.flops_model`), the collective term from the traced c10d
    calls, under the card's rates (`perf.roofline`).

The port's own layout shows in its peak, not in ``argument_size``: where
a rank-local cache block differs from the reference's placement (the
whole KV heads where ``cache_logical`` splits the head dim; the Mamba2
conv state's [xi_r | B | C] channels), ``peak_bytes_per_rank`` counts
the port's blocks.  A cell whose predicted per-rank peak exceeds the
card's memory is an ``"error"`` (the counterpart of a compile-time OOM)
with the peak and the capacity — read from the card where one is
present (``torch.cuda.get_device_properties``), else `CARD_MEMORY_BYTES`.

Usage (the default device is ``cuda``, the card's type; ``--device cpu``
traces CPU fake tensors, for hosts whose torch has no CUDA):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --multi-pod both --out-dir results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from .. import mesh as M
from ..configs import ARCHS, get_config
from ..configs.base import SHAPES, cell_applicable, shape_cell
from ..models import DecoderLM, EncDecLM
from ..models.attention import KVCache, local_kv_heads
from ..models.encdec import DecCache
from ..models.transformer import init_caches, torch_dtype
from ..optim import cosine_schedule
from ..optim.optimizers import make as make_opt
from ..serve.decode import make_prefill, make_serve_step
from ..sharding import spmd
from ..sharding.rules import map_leaves, mesh_context, profile_context
from ..train import init_train_state, make_train_step
from . import specs as S
from .flops_model import step_flops, step_hbm_bytes
from .mesh import make_production_mesh
from .roofline import ProgramTrace, analyze, compiled_cost, model_flops_for

# ``torch.cuda.get_device_properties(0).total_memory`` of the card the
# dry run's capacity check stands for where none is present: an NVIDIA
# H100 80GB HBM3 at a 700 W power limit, as a run on one read it
# (PERF.md §5).
CARD_MEMORY_BYTES = 85_017_493_504


def card_memory_bytes() -> int:
    """The capacity a rank's predicted peak is held to: the card's own
    where one is present, else `CARD_MEMORY_BYTES`."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return CARD_MEMORY_BYTES


class PredictedOOM(RuntimeError):
    """A cell's predicted per-rank peak exceeds the card's memory."""


def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a "fake" process group of ``world``
    ranks (leaving an earlier fake group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run stands for rank 0 of a fake "
                               "process group; this process has joined a "
                               f"{dist.get_backend()!r} one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors of a tree (a model's
    parameters included), each storage once."""
    out = {}

    def add(t):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    if isinstance(tree, torch.nn.Module):
        for t in tree.parameters():
            add(t)
        return out
    map_leaves(add, tree)
    return out


def _filled(caches, length: int):
    """The caches with every KV cache's length set to ``length`` (a
    prompt of that many positions already in)."""
    if isinstance(caches, KVCache):
        return KVCache(caches.k, caches.v, length)
    if isinstance(caches, DecCache):
        return DecCache(_filled(caches.self_kv, length), caches.cross_k,
                        caches.cross_v)
    if isinstance(caches, dict):
        return {k: _filled(v, length) for k, v in caches.items()}
    if isinstance(caches, list):
        return [_filled(c, length) for c in caches]
    return caches


def _batch(cfg, cell, dev, labels: bool):
    """The global batch of the cell as tensors on ``dev`` (fake under the
    dry run's mode: nothing allocated); every rank is handed it and
    takes its rows."""
    shapes = S.batch_inputs(cfg, cell)
    if not labels:
        shapes.pop("labels")
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
            for k, v in shapes.items()}


def _decode_caches(cfg, cell, model, mesh, dev):
    """This rank's caches of a decode cell, holding ``seq_len − 1``
    positions: the step writes the last one."""
    dt = torch_dtype(cfg.compute_dtype)
    b, s = cell.global_batch, cell.seq_len
    with mesh_context(mesh), profile_context(model.profile), \
            spmd.rows(b, mesh):
        if cfg.family != "encdec":
            return _filled(init_caches(cfg, b, s, dt, dev, mesh), s - 1)
        b_loc = b // spmd.batch_split(mesh)
        kvh = local_kv_heads(cfg, mesh)
        self_kv = (cfg.n_layers, b_loc, s, kvh, cfg.hd)
        cross = (cfg.n_layers, b_loc, cfg.n_frames, kvh, cfg.hd)
        return DecCache(KVCache(torch.zeros(self_kv, dtype=dt, device=dev),
                                torch.zeros(self_kv, dtype=dt, device=dev),
                                s - 1),
                        torch.zeros(cross, dtype=dt, device=dev),
                        torch.zeros(cross, dtype=dt, device=dev))


def lower_cell(cfg, cell, mesh, device: str = "cuda",
               fake: bool = True) -> dict:
    """Trace this rank's step of the cell on ``FakeTensorMode`` tensors
    under the active profile, over ``mesh`` (a mesh of a fake process
    group) → {"trace": its `ProgramTrace`, "seconds": the trace's wall
    seconds, "memory": its ``memory_analysis`` dict, "peak_bytes": the
    port's arguments plus the step's own peak}.  ``fake=False`` runs the
    same step on real zeros instead (a real process group's rank: the
    trace's yardstick).  The parameters are zeros: a traced MoE layer
    holds ``cap`` rows an expert (no count to read), as the reference's
    static shapes do, where a real one trims them to the fullest
    expert's."""
    dev = torch.device(device)
    opt_name = S.optimizer_name(cfg)
    args = S.block_bytes(S.step_arguments(cfg, cell, mesh))
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    with _fake_mode() if fake else contextlib.nullcontext():
        model = cls(cfg, device=dev, mesh=mesh)
        if cell.kind == "train":
            opt = make_opt(opt_name)
            model.requires_grad_(True)
            state = init_train_state(model, opt)
            step = make_train_step(
                cfg, opt, lambda s: cosine_schedule(s, peak=3e-4,
                                                    warmup=100,
                                                    total=10000))
            batch = _batch(cfg, cell, dev, labels=True)
            held = {**_storages(model), **_storages(state.opt_state),
                    **_storages(state.step)}
            run = lambda: step(state, batch)               # noqa: E731
        elif cell.kind == "prefill":
            batch = _batch(cfg, cell, dev, labels=False)
            held = _storages(model)
            run = lambda: make_prefill(cfg, cell.seq_len)(  # noqa: E731
                model, batch)
        else:
            caches = _decode_caches(cfg, cell, model, mesh, dev)
            tokens = torch.zeros((cell.global_batch, 1), dtype=torch.int32,
                                 device=dev)
            held = {**_storages(model), **_storages(caches)}
            run = lambda: make_serve_step(cfg)(  # noqa: E731
                model, caches, tokens)
        local_batch = S.block_bytes(
            {k: v for k, v in S.step_arguments(cfg, cell, mesh).items()
             if k in ("batch", "tokens")})
        t0 = time.perf_counter()
        with ProgramTrace() as tr:
            out = run()
        seconds = time.perf_counter() - t0
        outputs = _storages(out)
        if cell.kind == "train":            # the model's own leaves
            outputs.update(held)
            alias = sum(held.values())
        elif cell.kind == "decode":
            alias = sum(_storages(caches).values())
        else:
            alias = 0
    port_args = sum(held.values()) + local_batch
    return {"trace": tr, "seconds": seconds,
            "memory": {"argument_size_in_bytes": args,
                       "output_size_in_bytes": sum(outputs.values()),
                       "temp_size_in_bytes": tr.peak_bytes,
                       "alias_size_in_bytes": alias},
            "peak_bytes": port_args + tr.peak_bytes}


def cell_record(arch: str, shape: str, multi_pod: bool, profile: str = "tp",
                no_remat: bool = False):
    """(config, shape cell, the record's head): its arch, shape, profile,
    mesh and cell id ``{arch}__{shape}__pod1|pod2[__fsdp][__noremat]``,
    with status "skipped" and the reason where the cell does not run."""
    cfg = get_config(arch)
    if no_remat:
        cfg = dataclasses.replace(cfg, remat=False)
    cell = shape_cell(shape)
    cell_id = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    if profile != "tp":
        cell_id += f"__{profile}"
    if no_remat:
        cell_id += "__noremat"
    rec = {"arch": arch, "shape": shape, "profile": profile,
           "mesh": "2x16x16" if multi_pod else "16x16", "cell": cell_id}
    skip = cell_applicable(cfg, cell)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
    return cfg, cell, rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir=None,
             verbose=True, profile: str = "tp", no_remat: bool = False,
             device: str = "cuda") -> dict:
    """One cell's record (the reference's keys), written to
    ``out_dir/<cell id>.json`` when ``out_dir`` is given."""
    cfg, cell, rec = cell_record(arch, shape, multi_pod, profile, no_remat)
    cell_id = rec["cell"]
    if rec.get("status") == "skipped":
        _emit(rec, out_dir, cell_id, verbose)
        return rec
    try:
        join_fake_group(512 if multi_pod else 256)
        with profile_context(profile):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device)
            with mesh_context(mesh):
                low = lower_cell(cfg, cell, mesh, device)
        tr, mem = low["trace"], low["memory"]
        cap = card_memory_bytes()
        rec.update(memory_analysis=mem, peak_bytes_per_rank=low["peak_bytes"],
                   card_memory_bytes=cap)
        if verbose:
            print(f"== {cell_id}: memory_analysis == {mem}", flush=True)
        if low["peak_bytes"] > cap:
            raise PredictedOOM(
                f"predicted per-rank peak {low['peak_bytes'] / 1e9:.2f} GB "
                f"exceeds the card's {cap / 1e9:.2f} GB")
        ccost = compiled_cost(tr)
        roof = analyze(tr, model_flops_for(cfg, cell), M.mesh_size(mesh),
                       analytic_flops=step_flops(cfg, cell),
                       analytic_bytes=step_hbm_bytes(
                           cfg, cell, S.optimizer_name(cfg)))
        rec.update(status="ok", t_lower_s=low["seconds"], t_compile_s=0.0,
                   compiled_cost=ccost, roofline=roof.to_dict())
        if verbose:
            print(f"== {cell_id}: roofline == bottleneck={roof.bottleneck} "
                  f"t_comp={roof.t_compute:.4g}s "
                  f"t_mem={roof.t_memory:.4g}s "
                  f"t_coll={roof.t_collective:.4g}s "
                  f"useful={roof.useful_flops_ratio:.3f} "
                  f"mfu_bound={roof.mfu_bound:.3f}", flush=True)
    except Exception as e:  # noqa: BLE001 — a cell's failure is its record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"== {cell_id}: ERROR ==\n{rec['error']}", flush=True)
    _emit(rec, out_dir, cell_id, verbose=False)
    return rec


def _emit(rec, out_dir, cell_id, verbose):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "traceback"}, indent=1), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", default="no",
                    choices=["no", "yes", "both"])
    ap.add_argument("--profile", default="tp", choices=["tp", "fsdp"],
                    help="sharding profile (sharding/rules.PROFILES)")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing (§Perf knob)")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the traced fake tensors")
    ap.add_argument("--cell", action="append", default=[],
                    help="a cell id ({arch}__{shape}__pod1|pod2[__fsdp]"
                         "[__noremat]), repeatable: these cells instead "
                         "of the --arch × --shape × --multi-pod grid")
    args = ap.parse_args(argv)

    if args.cell:
        cells = [parse_cell(c) for c in args.cell]
    else:
        archs = list(ARCHS) if args.arch == "all" else [args.arch]
        shapes = [s.name for s in SHAPES] if args.shape == "all" \
            else [args.shape]
        pods = {"no": [False], "yes": [True], "both": [False, True]}[
            args.multi_pod]
        cells = [(arch, shape, mp, args.profile, args.no_remat)
                 for arch in archs for shape in shapes for mp in pods]
    failed = 0
    for arch, shape, mp, profile, no_remat in cells:
        rec = run_cell(arch, shape, mp, args.out_dir, profile=profile,
                       no_remat=no_remat, device=args.device)
        failed += rec["status"] == "error"
    return 1 if failed else 0


def parse_cell(cell_id: str) -> tuple:
    """(arch, shape, multi_pod, profile, no_remat) of a cell id."""
    parts = cell_id.split("__")
    if len(parts) < 3 or parts[2] not in ("pod1", "pod2") or not set(
            parts[3:]) <= {"fsdp", "noremat"}:
        raise ValueError(f"not a cell id: {cell_id!r}")
    return (parts[0], parts[1], parts[2] == "pod2",
            "fsdp" if "fsdp" in parts[3:] else "tp", "noremat" in parts[3:])


if __name__ == "__main__":
    sys.exit(main())
