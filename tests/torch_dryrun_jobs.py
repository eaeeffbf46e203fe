"""The port's side of tests/test_torch_dryrun.py, run out of the pytest
worker's process: the fake-group traces (``python
tests/torch_dryrun_jobs.py IN OUT``, one process standing for rank 0 of
8) and the same steps on real tensors on 8 spawned gloo ranks
(`real_cells`, through `repro_torch.mesh.spawn_mesh`).  It loads torch
and `repro_torch` only, never jax."""
import contextlib
import pickle
import sys
import traceback

import torch

from repro_torch import mesh as M
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as D
from repro_torch.perf.roofline import collective_bytes
from repro_torch.sharding import mesh_context, profile_context

SHAPE, NAMES = (2, 4), ("data", "model")


def shape_cell(kind: str, seq: int, batch: int) -> ShapeCell:
    return ShapeCell(f"{kind}_{seq}x{batch}", seq, batch, kind)


def summary(low, comm, seq_gathered) -> dict:
    tr = low["trace"]
    return {"status": "ok", "memory": low["memory"],
            "kinds": collective_bytes(tr.calls), "flops": tr.flops,
            "calls": len(tr.calls), "comm_debug_calls": comm,
            "seq_gather_bytes": seq_gathered}


def run(mesh, cases, fake: bool, comm: bool = False) -> dict:
    """`dryrun.lower_cell` of each (name, arch, profile, kind, seq,
    batch) of ``cases`` on ``mesh``: this rank's trace's summary, or the
    error; with ``comm``, ``CommDebugMode``'s count of its c10d calls
    too (its module tracker does not follow nested recomputes: the dense
    and MoE cases only), and the bytes its sequence gathers moved
    (``mesh.seq_gather_bytes``)."""
    from torch.distributed.tensor.debug import CommDebugMode
    out = {}
    for name, arch, profile, kind, seq, batch in cases:
        cfg = reduced(get_config(arch))
        try:
            counter = CommDebugMode() if comm else contextlib.nullcontext()
            before = obs.counter("mesh.seq_gather_bytes").value
            with profile_context(profile), mesh_context(mesh), counter:
                low = D.lower_cell(cfg, shape_cell(kind, seq, batch), mesh,
                                   "cpu", fake=fake)
            out[name] = summary(
                low, counter.get_total_counts() if comm else None,
                obs.counter("mesh.seq_gather_bytes").value - before)
        except Exception as e:   # noqa: BLE001 — the test reads it
            out[name] = {"status": "error",
                         "error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()}
    return out


def real_cells(mesh, cases) -> dict:
    """`run` on real zeros, on a spawned rank of a gloo group."""
    torch.set_num_threads(1)
    return run(mesh, cases, fake=False, comm=True)


def fake_cells(cases, real) -> dict:
    """`run` on fake tensors as rank 0 of a fake group of 8: ``cases``,
    and ``real`` with ``CommDebugMode``'s count."""
    D.join_fake_group(8)
    mesh = M.make_mesh(SHAPE, NAMES, device_type="cpu")
    return {**run(mesh, cases, fake=True),
            **run(mesh, real, fake=True, comm=True)}


if __name__ == "__main__":
    torch.set_num_threads(1)
    with open(sys.argv[1], "rb") as f:
        cases, real = pickle.load(f)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(fake_cells(cases, real), f)
