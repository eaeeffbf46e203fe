"""Elastic restart of the sharded LM trainer (`CheckpointManager.save /
restore(shardings=)`, `make_mesh_for`, `launch.train.restore_sharded`)
against tests/test_elastic_restart.py's scenario in the reference.

Reduced Qwen2 trains 4 steps (8 × 32 tokens, a checkpoint every 2) on an
(8, 1) mesh, half the ranks are lost, and the state is restored on
`make_mesh_for` the 4 left (4, 1), which takes 3 steps over the batches
of seed 123; the same from a (2, 4) mesh onto (1, 4) (model_parallel 4).
The port runs on spawned gloo CPU ranks (tests/torch_tp_jobs.py), the
reference in a subprocess on 8 forced CPU devices, from the parameters
the reference's ``train`` starts from.

Held: the losses before and after the restart against the reference's
(rtol 1e-5, as tests/test_torch_tp.py's), the first resumed loss below
the first loss + 0.5 (the reference test's bar), the step restored, and
every restored block bit for bit against its block of the saved global
leaf.  Checkpoints cross both ways bit for bit: the reference's written
on 8 devices is restored by the port on 4 ranks (and resumes with the
reference's losses), the port's written on (2, 4) is read by the
reference's ``CheckpointManager.restore(shardings=)`` on (1, 4)."""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from repro_torch import mesh as M
from repro_torch.ft import CheckpointManager
from repro_torch.models.params import nest
from repro_torch.sharding import block_of

import torch_tp_jobs as J

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 420.0
NAMES = ("data", "model")
ARCH = "qwen2-1.5b"
STEPS, BATCH, SEQ, EVERY, RESUMED, DATA_SEED = 4, 8, 32, 2, 3, 123
LOSS_RTOL = 1e-5
# (name, phase-1 mesh, model_parallel of the 4-rank restart)
SCENARIOS = [("8to4", (8, 1), 1), ("2x4to1x4", (2, 4), 4)]
# the 4-rank mesh each restart comes back on (the reference's rule)
RESTART_MESH = {"8to4": (4, 1), "2x4to1x4": (1, 4)}

_COMMON = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import pickle, sys
    sys.path.insert(0, {src!r})
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.data.lm import synthetic_token_batches
    from repro.ft import CheckpointManager
    from repro.ft.elastic import make_mesh_for
    import repro.launch.train as RT
    from repro.sharding.rules import mesh_context

    args = pickle.load(open({inp!r}, "rb"))
    cfg = reduced(get_config(args["arch"]))
    devs = jax.devices()

    def paths(tree, pre=()):
        if hasattr(tree, "_fields"):
            tree = dict(zip(tree._fields, tree))
        if isinstance(tree, dict):
            out = {{}}
            for k in sorted(tree):
                out.update(paths(tree[k], pre + (str(k),)))
            return out
        if isinstance(tree, (list, tuple)):
            out = {{}}
            for i, t in enumerate(tree):
                out.update(paths(t, pre + (str(i),)))
            return out
        return {{"/".join(pre): np.asarray(tree)}}

    def restored(ckpt, mp):
        mesh4 = make_mesh_for(devs[:4], model_parallel=mp)
        with mesh_context(mesh4), mesh4:
            state, step_fn, state_sh = RT.build(cfg, mesh4)
            mgr = CheckpointManager(ckpt)
            state = mgr.restore(state, shardings=state_sh)
            return mesh4, state, step_fn
"""

_REFERENCE = textwrap.dedent(_COMMON + """
    orig_build = RT.build
    init = {{}}

    def build(*a, **k):
        state, step_fn, sh = orig_build(*a, **k)
        init.setdefault("params", paths(jax.device_get(state.params)))
        return state, step_fn, sh
    RT.build = build

    out = {{}}
    for name, shape, mp in args["scenarios"]:
        ckpt = os.path.join(args["dir"], "ref_" + name)
        mesh = Mesh(np.asarray(devs).reshape(shape), ("data", "model"))
        _, hist = RT.train(cfg, mesh, steps=args["steps"],
                           batch=args["batch"], seq=args["seq"],
                           ckpt_dir=ckpt, ckpt_every=args["every"],
                           log_fn=lambda *a: None)
        mesh4, state, step_fn = restored(ckpt, mp)
        step = int(state.step)
        with mesh_context(mesh4), mesh4:
            bsh = NamedSharding(mesh4, P("data", None))
            losses = []
            for tokens, labels in synthetic_token_batches(
                    cfg.vocab, args["batch"], args["seq"],
                    steps=args["resumed"], seed=args["data_seed"]):
                b = {{"tokens": jax.device_put(tokens, bsh),
                     "labels": jax.device_put(labels, bsh)}}
                state, m = step_fn(state, b)
                losses.append(float(m["loss"]))
        out[name] = {{"hist": hist, "step": step, "losses": losses}}
    out["init"] = init["params"]
    pickle.dump(out, open({out!r}, "wb"))
""")

# the reference reading the port's (2, 4) checkpoint on (1, 4)
_READ_PORT = textwrap.dedent(_COMMON + """
    mesh4, state, _ = restored(args["port_ckpt"], 4)
    leaves = paths(jax.device_get(state))
    pickle.dump({{"step": int(state.step), "leaves": leaves}},
                open({out!r}, "wb"))
""")


def _reference(script, args):
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(args, f)
        res = subprocess.run(
            [sys.executable, "-c", script.format(
                src=os.path.abspath(SRC), inp=inp, out=out)],
            capture_output=True, text=True, timeout=DEADLINE_S)
        assert res.returncode == 0, res.stderr[-3000:]
        with open(out, "rb") as f:
            return pickle.load(f)


def _spawn(fn, shape, *args):
    """``fn`` on the ranks of a fresh process group of ``shape`` (a
    restart's job makes its own mesh over them)."""
    return M.spawn_mesh(fn, shape, NAMES[-len(shape):], backend="gloo",
                        device_type="cpu", timeout_s=DEADLINE_S, args=args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    base = dict(arch=ARCH, steps=STEPS, batch=BATCH, seq=SEQ, every=EVERY,
                resumed=RESUMED, data_seed=DATA_SEED, dir=root)
    ref = _reference(_REFERENCE, dict(base, scenarios=SCENARIOS))
    params = nest(ref["init"])
    port = {}
    for name, shape, mp in SCENARIOS:
        ckpt = os.path.join(root, "port_" + name)
        hist = _spawn(J.run_phase1, shape, ARCH, params, "tp", ckpt, STEPS,
                      BATCH, SEQ, EVERY)
        resume = _spawn(J.run_resume, (4,), ARCH, "tp", ckpt, mp, RESUMED,
                        BATCH, SEQ, DATA_SEED)
        port[name] = {"hist": hist, "resume": resume, "ckpt": ckpt}
    # the port restoring the reference's 8-device checkpoint on 4 ranks
    port["from_ref"] = _spawn(J.run_resume, (4,), ARCH, "tp",
                              os.path.join(root, "ref_8to4"), 1, RESUMED,
                              BATCH, SEQ, DATA_SEED)
    read = _reference(_READ_PORT, dict(
        base, port_ckpt=port["2x4to1x4"]["ckpt"]))
    return dict(ref=ref, port=port, read=read, root=root)


def _saved(ckpt):
    """The checkpoint's latest global leaves, by path."""
    return CheckpointManager(ckpt).restore_arrays()


def _hold_restored(resume, saved):
    """Each rank's restored blocks bit for bit against its block of the
    saved global leaf, under the new mesh's placements."""
    names, layout = resume[0]["mesh"]
    mesh = M.AbstractMesh(np.asarray(layout).shape, names)
    assert sorted(np.asarray(layout).reshape(-1).tolist()) == list(range(4))
    for rank, r in enumerate(resume):
        assert set(r["restored"]) == set(saved)
        for path, got in r["restored"].items():
            want = block_of(saved[path], r["specs"][path], mesh, rank)
            np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("name", [s[0] for s in SCENARIOS])
def test_restart_on_half_the_ranks(runs, name):
    """Phase 1's losses, then the restart on `make_mesh_for` 4 ranks:
    the step, every restored block, the resumed losses against the
    reference's, the first below the first loss + 0.5."""
    ref, port = runs["ref"][name], runs["port"][name]
    for hist in port["hist"]:
        np.testing.assert_allclose(hist, ref["hist"], rtol=LOSS_RTOL)
    assert port["resume"][0]["mesh"][0] == ("data", "model")
    assert np.asarray(port["resume"][0]["mesh"][1]).shape == \
        RESTART_MESH[name]
    _hold_restored(port["resume"], _saved(port["ckpt"]))
    for r in port["resume"]:
        assert r["step"] == ref["step"] == STEPS
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        assert r["losses"][0] < ref["hist"][0] + 0.5


def test_port_restores_reference_checkpoint(runs):
    """The reference's checkpoint written on 8 devices, restored by the
    port on 4 ranks: every block bit for bit, the resumed losses the
    reference's."""
    got = runs["port"]["from_ref"]
    _hold_restored(got, _saved(os.path.join(runs["root"], "ref_8to4")))
    for r in got:
        np.testing.assert_allclose(r["losses"], runs["ref"]["8to4"]["losses"],
                                   rtol=LOSS_RTOL)


def test_reference_reads_port_checkpoint(runs):
    """The port's checkpoint written on (2, 4), read by the reference's
    ``restore(shardings=)`` on (1, 4): every leaf bit for bit."""
    saved = _saved(runs["port"]["2x4to1x4"]["ckpt"])
    got = runs["read"]["leaves"]
    assert runs["read"]["step"] == STEPS
    assert set(got) == set(saved)
    for path, want in saved.items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)


def test_sharded_save_writes_global_leaves(tmp_path):
    """Two ranks of one process group write one checkpoint of a split and
    a replicated leaf and a scalar: the files hold the global leaves
    (the replicated one written once), the manifest their shapes."""
    leaves = M.spawn_mesh(J.save_two, (2,), ("data",), backend="gloo",
                          device_type="cpu", timeout_s=120.0,
                          args=(str(tmp_path),))
    saved = CheckpointManager(str(tmp_path)).restore_arrays()
    np.testing.assert_array_equal(saved["w"], np.arange(12.0).reshape(4, 3))
    np.testing.assert_array_equal(saved["b"], np.ones(3))
    assert int(saved["step"]) == 7
    assert leaves == [[0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
                      [6.0, 7.0, 8.0, 9.0, 10.0, 11.0]]
