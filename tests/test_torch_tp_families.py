"""Model-parallel training of the Mamba2, hybrid and encoder–decoder
families (`sharding.spmd` in `models.mamba`, the hybrid's period stage,
`models.encdec` and cross-attention) against the reference on the same
mesh and profile.

The port runs on 8 spawned gloo CPU ranks (`spawn_mesh`, once per mesh
shape, each rank running tests/torch_tp_families_jobs.py's `run_cases`);
the reference once in a subprocess on 8 forced CPU devices (a
`jax.sharding.Mesh` over them), each case with fresh jits (jit's cache
does not key on the mesh or the profile).  The reference draws the
initial parameters first and the port starts from them (`from_reference`,
cut by `build`), its ranks running while the reference trains.  Cases:
reduced Mamba2 (8 SSD heads, 160 conv channels: a "model" rank's conv
block is not its inner channels' block), reduced Zamba2 (2 periods of 2
Mamba2 layers and the shared attention block, 1 tail layer) and reduced
Whisper (2 + 2 layers, 16 frames) on (2, 4) and (4, 2) ("data", "model")
meshes under "tp" and "fsdp": 3 steps of 8 × 32 tokens, AdamW at its
defaults.  The decoders run through the reference's own
``launch.train.train`` and the port's; the encoder–decoder through each
package's ``build`` and its step on batches that carry N(0, 1) frames
(the reference's ``train`` feeds tokens only and raises ``KeyError:
'frames'`` for it).

Bars (tests/test_torch_tp.py's): losses and grad norms rtol 1e-5; each
rank's blocks after the last step against `block_of` the reference's
leaves at rtol 1e-4 and atol 1e-4 × the leaf's largest update over the
run, every element also passing within twice the summed learning rates
where a gradient is rounding noise (AdamW steps such an element by up to
lr either way).  Beside them: the collectives each profile owes, and the
sharded checkpoint of a reduced Zamba2 and a reduced Whisper state saved
on (2, 4) and restored on (4, 2), every restored block bit for bit
against its block of the saved global leaf."""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

from repro_torch import mesh as M
from repro_torch.ft import CheckpointManager
from repro_torch.launch import specs as TS
from repro_torch.models.params import nest, tree_paths, tree_pspecs
from repro_torch.sharding import block_of, profile_context

import torch_tp_families_jobs as J

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 900.0
STEPS, BATCH, SEQ = 3, 8, 32
LOSS_RTOL = 1e-5
P_RTOL, P_UPDATE = 1e-4, 1e-4
ARCHS = ("mamba2-2.7b", "zamba2-7b", "whisper-medium")
SHAPES = ((2, 4), (4, 2))
CASES = [(f"{arch}/{shape[0]}x{shape[1]}/{profile}", arch, shape, profile)
         for arch in ARCHS for shape in SHAPES
         for profile in ("tp", "fsdp")]
# (case, the mesh its state is restored on)
SAVES = (("zamba2-7b/2x4/tp", (4, 2)), ("whisper-medium/2x4/tp", (4, 2)))
# leaves with an element whose gradient is rounding noise: one element of
# the shared attention block's w_out, whose first gradient (-1.7e-7) is
# 25,000 times below the leaf's median, its terms cancelling — AdamW
# turns it into most of a step, so its rounding moves the update
NOISY = ("shared_attn/mlp/w_out",)

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import pickle, sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.launch import specs as S
    import repro.launch.train as RT
    from repro.models.params import tree_init
    from repro.sharding.rules import mesh_context, profile_context

    args = pickle.load(open({inp!r}, "rb"))

    def paths(tree, pre=()):
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

    def dump(obj, path):
        pickle.dump(obj, open(path + ".tmp", "wb"))
        os.replace(path + ".tmp", path)

    # the parameters every build of seed 0 draws, for the port to start
    # from while the cases run here
    init = {{}}
    for arch in args["archs"]:
        cfg = reduced(get_config(arch))
        init[arch] = paths(jax.device_get(jax.jit(lambda k: tree_init(
            k, S.model_decl(cfg), jnp.dtype(cfg.param_dtype)))(
                jax.random.PRNGKey(0))))
    dump(init, {init_out!r})

    orig_build = RT.build
    rec = {{}}

    def build(*a, **k):
        state, step_fn, sh = orig_build(*a, **k)
        rec["init"] = paths(jax.device_get(state.params))
        rec["metrics"] = []

        def step(state, b):
            state, m = step_fn(state, b)
            rec["metrics"].append(jax.device_get(m))
            return state, m
        return state, step, sh
    RT.build = build

    def build_and_step(cfg, mesh, batches):
        # the encoder-decoder: RT.train feeds no frames
        with mesh_context(mesh), mesh:
            state, step_fn, _ = RT.build(cfg, mesh,
                                         total_steps=max(len(batches), 2))
            axes = S.batch_axes_for(len(batches[0]["tokens"]), mesh) or None
            hist = []
            for b in batches:
                placed = {{k: jax.device_put(v, NamedSharding(
                    mesh, P(axes, *([None] * (v.ndim - 1)))))
                    for k, v in b.items()}}
                state, m = step_fn(state, placed)
                hist.append(float(jax.device_get(m)["loss"]))
            return state, hist

    out = {{}}
    for name, arch, shape, profile in args["cases"]:
        cfg = reduced(get_config(arch))
        mesh = Mesh(np.asarray(jax.devices()).reshape(shape),
                    ("data", "model"))
        with profile_context(profile):
            if cfg.family == "encdec":
                state, hist = build_and_step(cfg, mesh,
                                             args["batches"][arch])
            else:
                state, hist = RT.train(cfg, mesh, steps=args["steps"],
                                       batch=args["batch"],
                                       seq=args["seq"],
                                       log_fn=lambda *a: None)
        out[name] = {{"losses": hist,
                     "grad_norms": [float(m["grad_norm"])
                                    for m in rec["metrics"]],
                     "lrs": [float(m["lr"]) for m in rec["metrics"]],
                     "init_same": all(np.array_equal(v, init[arch][k])
                                      for k, v in rec["init"].items()),
                     "params": paths(jax.device_get(state.params))}}
    dump(out, {out!r})
""")


def _wait_for(path, proc, deadline):
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(proc.stderr.read()[-3000:])
        if time.monotonic() > deadline:
            proc.kill()
            raise TimeoutError(f"the reference wrote no {path}")
        time.sleep(0.1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("families"))
    deadline = time.monotonic() + DEADLINE_S
    batches = {arch: J.batches(J.config(arch), STEPS, BATCH, SEQ)
               for arch in ARCHS}
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        init_out = os.path.join(tmp, "init.pkl")
        with open(inp, "wb") as f:
            pickle.dump(dict(cases=CASES, archs=ARCHS, steps=STEPS,
                             batch=BATCH, seq=SEQ, batches=batches), f)
        proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE.format(
                src=os.path.abspath(SRC), inp=inp, out=out,
                init_out=init_out)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            _wait_for(init_out, proc, deadline)
            with open(init_out, "rb") as f:
                init = {a: nest(t) for a, t in pickle.load(f).items()}
            port = {}
            for shape in SHAPES:
                cases = [(name, arch, init[arch], profile, STEPS, BATCH, SEQ)
                         for name, arch, s, profile in CASES if s == shape]
                port[shape] = M.spawn_mesh(
                    J.run_cases, shape, J.NAMES, backend="gloo",
                    device_type="cpu",
                    timeout_s=max(deadline - time.monotonic(), 1.0),
                    args=(cases, [s for s in SAVES
                                  if s[0].split("/")[1] == "%dx%d" % shape],
                          root))
            _, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            assert proc.returncode == 0, err[-3000:]
            with open(out, "rb") as f:
                ref = pickle.load(f)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return dict(ref=ref, port=port, init=init, root=root)


def _noise_bar(ref_case):
    """Twice the summed learning rates of the run: AdamW's bound on how
    far an element whose gradient is rounding noise may step."""
    return 2.0 * sum(ref_case["lrs"]) * 1.01


def _hold_blocks(ranks, want, init, arch, shape, profile, noise):
    """Each rank's blocks against `block_of` the whole leaves ``want``:
    within rtol 1e-4 and 1e-4 × the leaf's largest update, or within the
    noise bar."""
    mesh = M.AbstractMesh(shape, J.NAMES)
    with profile_context(profile):
        specs = tree_paths(tree_pspecs(TS.model_decl(J.config(arch)), mesh))
    init = tree_paths(init)
    for path, spec in specs.items():
        full = np.asarray(want[path])
        update = float(np.abs(full - np.asarray(init[path])).max())
        for rank, r in enumerate(ranks):
            got = r["blocks"][path]
            blk = block_of(full, spec, mesh, rank)
            bar = P_RTOL * np.abs(blk) + P_UPDATE * update
            bar = np.maximum(bar, noise) if path in NOISY else bar
            bad = np.abs(got - blk) > bar
            assert not bad.any(), (path, rank, int(bad.sum()),
                                   float(np.abs(got - blk).max()), update)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_family_trains_as_reference_on_mesh(runs, case):
    """Losses, grad norms and every rank's final blocks against the
    reference on the same mesh and profile, from the same parameters."""
    name, arch, shape, profile = case
    ref = runs["ref"][name]
    assert ref["init_same"]
    ranks = [r[name] for r in runs["port"][shape]]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                   rtol=LOSS_RTOL)
    _hold_blocks(ranks, ref["params"], runs["init"][arch], arch, shape,
                 profile, _noise_bar(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_by_profile(runs, arch):
    """Under "tp" a rank gathers parameters, reduce-scatters their
    cotangents and all-reduces activations over "model" (the Mamba2
    mixer's input, B/C weights, norm sums and output; attention's and the
    MLP's); under "fsdp" it gathers more and all-reduces no activation
    (its psums are the loss, the grad norm and the whole leaves'
    gradients).  No family exchanges tokens."""
    for r in runs["port"][(2, 4)]:
        tp = r[f"{arch}/2x4/tp"]["bytes"]
        fsdp = r[f"{arch}/2x4/fsdp"]["bytes"]
        assert tp["param_gather_bytes"] > 0 and tp["reduce_scatter_bytes"] > 0
        assert fsdp["param_gather_bytes"] > tp["param_gather_bytes"]
        assert tp["psum_bytes"] > 4 * fsdp["psum_bytes"]
        assert tp["all_to_all_bytes"] == fsdp["all_to_all_bytes"] == 0


@pytest.mark.parametrize("name", [s[0] for s in SAVES])
def test_sharded_checkpoint_crosses_meshes(runs, name):
    """A state saved on (2, 4) restored on (4, 2) (`restore_sharded` into
    a model built there): the step, and every rank's restored block bit
    for bit against its block of the saved global leaf."""
    saved = CheckpointManager(os.path.join(runs["root"], name)
                              ).restore_arrays()
    shape = dict(SAVES)[name]
    for rank, r in enumerate(runs["port"][(2, 4)]):
        got = r[name]["restore"]
        assert got["mesh"] == (J.NAMES, np.arange(8).reshape(shape).tolist())
        assert got["step"] == STEPS
        assert set(got["restored"]) == set(saved)
        mesh = M.AbstractMesh(shape, J.NAMES)
        for path, blk in got["restored"].items():
            want = block_of(saved[path], got["specs"][path], mesh, rank)
            np.testing.assert_array_equal(blk, want, err_msg=path)
