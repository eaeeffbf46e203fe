"""`repro_torch.train.dp` (the compressed data-parallel step) against
`repro.train.dp`.

The port runs once on 4 spawned gloo ranks on the CPU
(`repro_torch.mesh.spawn_mesh`, each rank running
tests/torch_train_jobs.py's `run_dp`); the reference once in a subprocess
on 4 forced CPU devices (``XLA_FLAGS`` before jax loads, as
tests/test_dp_compress.py runs it).  Both start from the reference's
`tree_init` parameters of reduced qwen2 and take 3 steps over the same
global batches (8 × 32 tokens, 2 rows a rank), AdamW with eps 1e-4
(tests/test_torch_train_step.py says why), a bf16 wire with error
feedback.

Bars: losses and grad norms rtol 1e-5; the residuals g − f32(bf16(g)):
an element whose f32 gradient parts from the reference's by its last bits
may round to the neighbouring bf16 value, which moves its residual by one
bf16 ulp of g (up to twice the residual's own largest size), so every
residual lies within 2.5× its leaf's largest |residual| of the
reference's, and all but max(4, 1 %) of a leaf's within 1e-2 of it;
parameters rtol 1e-4 / atol 5e-5 (such a flip moves that element's mean
gradient by a quarter bf16 ulp, and Adam's step with it).  The
reference's residuals are per device though its ``out_specs`` declare
them replicated (``P()``): its host value is device 0's, so each
device's own buffer is read.  The
wire is bf16: each rank gathers 2 bytes a parameter a rank a step (plus
the f32 losses).  The port's DP against its own exact single-process
step at tests/test_dp_compress.py:62-63's bar."""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch.specs import model_decl as ref_model_decl
from repro.models.params import tree_init as ref_tree_init
from repro_torch import mesh as M
from repro_torch.configs import get_config, reduced
from repro_torch.models import DecoderLM
from repro_torch.models.params import from_reference
from repro_torch.optim import adamw
from repro_torch.train import init_train_state, make_train_step

import torch_train_jobs as J

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 300.0
EPS, LR, STEPS, RANKS = 1e-4, 1e-3, 3, 4
LOSS_REL = 1e-5
STEP = dict(rtol=1e-4, atol=5e-5)

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle, sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduced
    from repro.launch.mesh import make_host_mesh
    from repro.optim import adamw
    from repro.sharding.rules import mesh_context
    from repro.train.dp import init_dp_state, make_dp_train_step

    args = pickle.load(open({inp!r}, "rb"))
    cfg = reduced(get_config({arch!r}))
    mesh = make_host_mesh()
    assert dict(mesh.shape) == {{"data": 4, "model": 1}}, mesh.shape
    opt = adamw(eps=args["eps"])
    lr = args["lr"]
    params = jax.tree_util.tree_map(jnp.asarray, args["params"])
    with mesh_context(mesh), mesh:
        st = init_dp_state(params, opt)
        step = jax.jit(make_dp_train_step(cfg, opt, lambda s: lr, mesh))
        losses, norms = [], []
        for b in args["batches"]:
            st, m = step(st, {{k: jnp.asarray(v) for k, v in b.items()}})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))

    def flat(tree):
        return {{"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}
    # the residuals are per device, though out_specs declares them
    # replicated: read each device's own buffer (device i is rank i)
    def per_device(a):
        shards = sorted(a.addressable_shards, key=lambda s: s.device.id)
        return np.stack([np.asarray(s.data) for s in shards])
    pickle.dump(dict(losses=losses, grad_norms=norms,
                     params=flat(st.train.params),
                     error=flat(jax.tree_util.tree_map(per_device,
                                                       st.error))),
                open({out!r}, "wb"))
""")


def _batches():
    """tests/test_dp_compress.py's: one batch of random tokens, taken at
    every step (the loss falls as it is memorized)."""
    vocab = reduced(get_config(J.ARCH)).vocab
    tok = np.random.default_rng(5).integers(
        0, vocab, (2 * RANKS, 32)).astype(np.int32)
    return [{"tokens": tok, "labels": np.roll(tok, -1, 1)}] * STEPS


@pytest.fixture(scope="module")
def runs():
    cfg = ref_reduced(ref_get_config(J.ARCH))
    params = jax.tree_util.tree_map(
        np.asarray, ref_tree_init(jax.random.PRNGKey(0),
                                  ref_model_decl(cfg)))
    batches = _batches()
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(dict(params=params, batches=batches, eps=EPS,
                             lr=LR), f)
        res = subprocess.run(
            [sys.executable, "-c", _REFERENCE.format(
                src=os.path.abspath(SRC), inp=inp, out=out, arch=J.ARCH)],
            capture_output=True, text=True, timeout=DEADLINE_S)
        assert res.returncode == 0, res.stderr[-3000:]
        with open(out, "rb") as f:
            ref = pickle.load(f)
    port = M.spawn_mesh(J.run_dp, (RANKS,), ("data",), backend="gloo",
                        device_type="cpu", timeout_s=DEADLINE_S,
                        args=(params, batches, EPS, LR))
    return dict(ref=ref, port=port, params=params, batches=batches)


def test_dp_losses_match_reference(runs):
    ref = runs["ref"]
    for rank in runs["port"]:
        np.testing.assert_allclose(rank["losses"], ref["losses"],
                                   rtol=LOSS_REL)
        np.testing.assert_allclose(rank["grad_norms"], ref["grad_norms"],
                                   rtol=LOSS_REL)


def test_dp_params_match_reference_and_stay_replicated(runs):
    ref, port = runs["ref"], runs["port"]
    for rank in port[1:]:
        for p, v in rank["params"].items():
            np.testing.assert_array_equal(v, port[0]["params"][p])
    assert set(port[0]["params"]) == set(ref["params"])
    for p, v in port[0]["params"].items():
        np.testing.assert_allclose(v, ref["params"][p], err_msg=p, **STEP)


def test_dp_residuals_match_reference(runs):
    ref = runs["ref"]
    for r, rank in enumerate(runs["port"]):
        # the reference's residual tree is stacked over its 4 devices
        assert set(rank["error"]) == set(ref["error"])
        for p, e in rank["error"].items():
            want = ref["error"][p][r]
            scale = float(np.abs(want).max())
            diff = np.abs(e - want)
            assert diff.max() <= 2.5 * scale + 1e-12, (p, r, diff.max())
            assert (diff > 1e-2 * scale).sum() <= max(4, 0.01 * diff.size), \
                (p, r)


def test_dp_wire_is_bf16(runs):
    for rank in runs["port"]:
        n = rank["n_params"]
        assert rank["gathered_bytes"] == STEPS * RANKS * (2 * n + 4)


def test_dp_tracks_exact_single_process_step(runs):
    """tests/test_dp_compress.py:62-63's bar: the compressed DP step's
    losses within 5 % of the exact (f32, one process) step's."""
    cfg = reduced(get_config(J.ARCH))
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(from_reference(runs["params"], device="cpu"))
    model.requires_grad_(True)
    opt = adamw(eps=EPS)
    st = init_train_state(model, opt)
    step = make_train_step(cfg, opt, lambda s: LR)
    exact = []
    for b in runs["batches"]:
        st, m = step(st, b)
        exact.append(float(m["loss"]))
    dp = runs["port"][0]["losses"]
    assert dp[-1] < dp[0]
    for a, b in zip(exact, dp):
        assert abs(a - b) < 0.05 * max(abs(a), 1.0), (a, b)
