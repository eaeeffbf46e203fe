"""`repro_torch.launch` (the single-card part: `train`, `mesh`, `specs`)
against `repro.launch`'s, on the CPU.

`train()` on reduced qwen2 for 12 steps with checkpoints every 4; a run
stopped at step 8 (its logger raises there, as a crash would) and run
again resumes from that checkpoint and takes the uninterrupted run's last
four steps bit for bit.  The command line runs and resumes (a
subprocess: `make_host_mesh` joins this process to a one-rank group).
Model-parallel meshes (ROADMAP item 3d iv): `make_host_mesh`'s gcd rule
on one rank, the production mesh's rank count, and a mesh of several
ranks training sharded only on its ranks (tests/test_torch_tp.py holds
the sharded training itself)."""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch.specs import batch_axes_for as ref_batch_axes_for
from repro.launch.specs import model_decl as ref_model_decl
from repro.sharding.rules import profile_context as ref_profile_context
import repro_torch.configs as TC
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.train import train
from repro_torch.sharding import profile_context

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CFG = TC.reduced(TC.get_config("qwen2-1.5b"))
RUN = dict(steps=12, batch=4, seq=16, ckpt_every=4, log_every=1,
           device="cpu")


class Crash(RuntimeError):
    pass


def _stop_at(step):
    def log(line):
        if line.startswith(f"step {step:5d}"):
            raise Crash(line)
    return log


def test_train_resumes_bit_for_bit(tmp_path):
    lines = []
    _, full = train(CFG, ckpt_dir=str(tmp_path / "a"), log_fn=lines.append,
                    **RUN)
    assert len(full) == 12 and all(np.isfinite(full))
    assert lines[0].startswith("params: ") and "mesh: {'data': 1" in lines[0]
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [4, 8, 12]
    with pytest.raises(Crash):
        train(CFG, ckpt_dir=str(tmp_path / "b"), log_fn=_stop_at(8), **RUN)
    mgr = CheckpointManager(str(tmp_path / "b"))
    assert mgr.latest_step() == 8
    lines = []
    state, resumed = train(CFG, ckpt_dir=str(tmp_path / "b"),
                           log_fn=lines.append, **RUN)
    assert "restored checkpoint step=8" in lines
    assert resumed == full[8:]
    assert int(state.step) == 12
    # and the state written at the end is the uninterrupted run's
    a = CheckpointManager(str(tmp_path / "a")).restore_arrays(12)
    b = mgr.restore_arrays(12)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bf16_state_round_trips_a_checkpoint(tmp_path):
    """bf16 parameters are written as their bit patterns and come back
    into a bf16 template bit for bit."""
    t = torch.randn(5, 3).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": t, "n": torch.zeros((), dtype=torch.int32)})
    got = mgr.restore({"w": torch.zeros_like(t),
                       "n": torch.zeros((), dtype=torch.int32)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t.view(torch.int16))


def test_cli_runs_and_resumes(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2-1.5b", "--reduced", "--device", "cpu", "--batch", "4",
           "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first = subprocess.run(cmd + ["--steps", "6"], capture_output=True,
                           text=True, timeout=300, env=env)
    assert first.returncode == 0, first.stderr[-2000:]
    out = json.loads(first.stdout.strip().splitlines()[-1])
    assert out["arch"] == "qwen2-1.5b" and out["steps"] == 6
    assert set(out) == {"arch", "steps", "wall_s", "loss_first10",
                        "loss_last10"}
    again = subprocess.run(cmd + ["--steps", "9"], capture_output=True,
                           text=True, timeout=300, env=env)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "restored checkpoint step=6" in again.stdout
    assert json.loads(again.stdout.strip().splitlines()[-1])["steps"] == 3
    card = subprocess.run(cmd[:-6] + ["--steps", "1", "--device", "cuda"],
                          capture_output=True, text=True, timeout=300,
                          env={**env, "CUDA_VISIBLE_DEVICES": ""})
    assert card.returncode != 0 and "device='cpu'" in card.stderr


def test_model_parallel_and_production_mesh_are_item_3d():
    """`make_host_mesh(mp)` takes gcd(mp, world) ranks a replica: (1, 1)
    on one rank at mp 2 and 8 (in a subprocess: it joins a one-rank
    group); `make_production_mesh` raises below its 256 ranks; a mesh of
    several ranks trains sharded, every rank of its group calling
    ``train``: this process alone is not its ranks and raises, never
    training replicated."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from repro_torch.launch.mesh import make_host_mesh\n"
            "for mp in (2, 8):\n"
            "    m = make_host_mesh(mp, device_type='cpu')\n"
            "    print(tuple(m.mesh.shape), m.mesh_dim_names)\n"
            % os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == ["(1, 1) ('data', 'model')"] * 2
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    four = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros(4, 1))
    with pytest.raises(RuntimeError, match="process group"):
        train(CFG, four, **RUN)


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_model_decl_matches_reference(arch):
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tuple(tree.logical), tree.init,
                tree.scale)
    assert shapes(specs.model_decl(TC.get_config(arch))) == \
        shapes(ref_model_decl(RC.get_config(arch)))


@pytest.mark.parametrize("shape,names", [((4, 2), ("data", "model")),
                                         ((2, 4, 2), ("pod", "data",
                                                      "model")),
                                         ((1, 1), ("data", "model"))])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_batch_axes_for_matches_reference(shape, names, b, profile):
    """The active profile's batch rule: ("pod", "data") under "tp",
    ("pod", "data", "model") under "fsdp"."""
    ref_mesh = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, shape)))
    port_mesh = types.SimpleNamespace(mesh_dim_names=names,
                                      mesh=torch.zeros(shape))
    with profile_context(profile), ref_profile_context(profile):
        assert specs.batch_axes_for(b, port_mesh) == \
            ref_batch_axes_for(b, ref_mesh)
