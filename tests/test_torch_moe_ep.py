"""Expert parallelism (`repro_torch.models.moe`'s mesh branches and
`repro_torch.mesh.all_to_all`) against `repro.models.moe` under a mesh.

The port runs once on 8 spawned gloo CPU ranks on a (2, 4) ("data",
"model") mesh (`spawn_mesh`, each rank running tests/torch_moe_jobs.py's
`run_all`); the reference once in a subprocess on 8 forced CPU devices
(tests/test_padding_profiles.py:110's setting) under the same mesh,
`jax.jit` of ``moe`` and of ``jax.grad`` of sum(y·g).  Both take the
reference's `tree_init` parameters of reduced OLMoE at 8 experts, top-2,
and the same seeded numpy x and g: cf 8 (no drops) on (8, 4, 64) as the
reference's own test, and cf 1.25 on (16, 16, 64), where both branches
drop pairs.

Bars: y at atol 1e-4 / rtol 1e-4 (the reference's, against its local
dispatch), the gradients at atol 1e-4 × their leaf's largest |g| / rtol
1e-4 (each rank's part of a replicated weight's gradient added here in
f32 in rank order, XLA's in its own).  The drop sets (the pairs a rank
keeps) equal the reference's dispatch (src/repro/models/moe.py:66-88
under a2a, :142-152 at each rank under tp, in jnp on each rank's block).
`all_to_all` equals `jax.lax.all_to_all` bit for bit on integers, and
`local_block` gives every rank the block jax places on its device."""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import moe as RM
from repro.models.params import tree_init as ref_tree_init
from repro_torch import mesh as M
from repro_torch.sharding import local_block

import torch_moe_jobs as J

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 300.0
SHAPE, NAMES = (2, 4), ("data", "model")
CASES = {"cf8": (8.0, (8, 4, 64)), "cf1.25": (1.25, (16, 16, 64))}
Y_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
PROBE_SHAPE = (32, 3)       # 8 blocks of (4, 3): a block's 4 rows to 4 ranks
PLACEMENTS = [("model", None, None), ("data", None), (("data", "model"),),
              (("model", "data"), None), (None, "model"), ("data", "model")]
PLACED_SHAPE = (8, 8, 3)

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, pickle, sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import get_config, reduced
    from repro.models import moe as RM
    from repro.sharding.rules import mesh_context, profile_context

    args = pickle.load(open({inp!r}, "rb"))
    mesh = jax.make_mesh({shape!r}, {names!r})
    out = {{}}
    for name, (cf, a) in args["cases"].items():
        cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                                  n_experts=8, top_k=2, capacity_factor=cf)
        p = {{k: jnp.asarray(a[k]) for k in ("w_router", "w_in", "w_out")}}
        x, g = jnp.asarray(a["x"]), jnp.asarray(a["g"])

        def loss(p, x):
            return jnp.sum(RM.moe(cfg, p, x) * g)

        def run():
            # a fresh jit each time: the mesh and the profile are read
            # while tracing, and jit's cache does not key on them
            fwd = jax.jit(lambda p, x: RM.moe(cfg, p, x))
            grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
            return np.asarray(fwd(p, x)), grad(p, x)
        out[name, "local"] = run()
        with mesh_context(mesh), mesh:
            out[name, "tp"] = run()
            with profile_context("fsdp"):
                out[name, "fsdp"] = run()
    out = {{k: (y, ({{n: np.asarray(v) for n, v in gp.items()}},
                    np.asarray(gx)))
           for k, (y, (gp, gx)) in out.items()}}
    probe = jnp.asarray(args["probe"])
    a2a = shard_map(lambda t: jax.lax.all_to_all(t, "model", 0, 0,
                                                 tiled=False),
                    mesh=mesh, in_specs=P(("data", "model")),
                    out_specs=P(("data", "model")), check_vma=False)
    out["probe"] = np.asarray(jax.jit(a2a)(probe))
    # the block of each placement each mesh position holds
    placed = {{}}
    for spec in args["placements"]:
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(
            args["placed_shape"])
        for pos in np.ndindex(*mesh.devices.shape):
            rank = int(np.ravel_multi_index(pos, mesh.devices.shape))
            placed[spec, rank] = tuple(
                (s.start or 0, s.stop if s.stop is not None else n)
                for s, n in zip(idx[mesh.devices[pos]], args["placed_shape"]))
    out["placed"] = placed
    pickle.dump(out, open({out!r}, "wb"))
""")


def _arrays(cf, shape, seed):
    cfg = dataclasses.replace(ref_reduced(ref_get_config("olmoe-1b-7b")),
                              n_experts=8, top_k=2, capacity_factor=cf)
    p = ref_tree_init(jax.random.PRNGKey(seed), RM.moe_decl(cfg),
                      jnp.float32)
    rng = np.random.default_rng(seed + 1)
    a = {k: np.asarray(v) for k, v in p.items()}
    a["x"] = rng.normal(size=shape).astype(np.float32)
    a["g"] = rng.normal(size=shape).astype(np.float32)
    return cfg, a


@pytest.fixture(scope="module")
def runs():
    cases, cfgs = {}, {}
    for seed, (name, (cf, shape)) in enumerate(CASES.items()):
        cfgs[name], a = _arrays(cf, shape, seed)
        cases[name] = (cf, a)
    probe = np.arange(np.prod(PROBE_SHAPE), dtype=np.int32).reshape(
        PROBE_SHAPE)
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(dict(cases=cases, probe=probe,
                             placements=PLACEMENTS,
                             placed_shape=PLACED_SHAPE), f)
        res = subprocess.run(
            [sys.executable, "-c", _REFERENCE.format(
                src=os.path.abspath(SRC), inp=inp, out=out, shape=SHAPE,
                names=NAMES)],
            capture_output=True, text=True, timeout=DEADLINE_S)
        assert res.returncode == 0, res.stderr[-3000:]
        with open(out, "rb") as f:
            ref = pickle.load(f)
    port = M.spawn_mesh(J.run_all, SHAPE, NAMES, backend="gloo",
                        device_type="cpu", timeout_s=DEADLINE_S,
                        args=(cases, probe))
    return dict(ref=ref, port=port, cases=cases, cfgs=cfgs, probe=probe)


MESH = M.AbstractMesh(SHAPE, NAMES)
RANKS = range(int(np.prod(SHAPE)))


def _assemble(blocks, spec, shape):
    """The global array from every rank's block under ``spec`` (a rank
    replicated with another must hold the same bits)."""
    full = np.full(shape, np.nan, np.float32)
    for r, blk in enumerate(blocks):
        view = local_block(full, spec, MESH, r)
        held = ~np.isnan(view)
        np.testing.assert_array_equal(view[held], blk[held])
        view[...] = blk
    assert not np.isnan(full).any()
    return full


def _grad_close(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL_REL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("profile,branch", [("tp", "tp"), ("fsdp", "a2a")])
def test_moe_matches_reference_under_mesh(runs, case, profile, branch):
    """y under each profile equals the reference's under the same mesh
    and profile at the reference's bar, and at cf 8 its single-device y
    (a rank's capacity is taken from its own tokens)."""
    ranks = [r[case, profile] for r in runs["port"]]
    assert all(r["branch"] == branch for r in ranks)
    y_ref = runs["ref"][case, profile][0]
    y = _assemble([r["y"] for r in ranks], ranks[0]["xspec"], y_ref.shape)
    np.testing.assert_allclose(y, y_ref, **Y_TOL)
    if CASES[case][0] == 8.0:   # no drops: the mesh changes no capacity
        np.testing.assert_allclose(y, runs["ref"][case, "local"][0], **Y_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_moe_gradients_match_reference_under_mesh(runs, case, profile):
    """∂ sum(y·g) / ∂(x, w_router, w_in, w_out) against `jax.grad` under
    the mesh: x's blocks whole; a weight's parts summed over the ranks
    holding its block (the data axes for an expert slice, all for
    w_router)."""
    ranks = [r[case, profile] for r in runs["port"]]
    ref_p, ref_x = runs["ref"][case, profile][1]
    _grad_close(_assemble([r["gx"] for r in ranks], ranks[0]["xspec"],
                          ref_x.shape), ref_x, "x")
    router = np.zeros_like(ref_p["w_router"])
    for r in ranks:
        router = router + r["g_router"]
    _grad_close(router, ref_p["w_router"], "w_router")
    for key, got in (("w_in", "g_in"), ("w_out", "g_out")):
        full = np.zeros_like(ref_p[key])
        for rank, r in enumerate(ranks):
            local_block(full, J.EXPERT_SPEC, MESH, rank)[...] += r[got]
        _grad_close(full, ref_p[key], key)


def _ref_keeps(cfg, a, block, cap):
    """The reference's kept pairs of a block of tokens (its dispatch,
    src/repro/models/moe.py:66-88, in jnp), flat (token, k) order."""
    t = block.shape[0] * block.shape[1]
    xt = jnp.asarray(block).reshape(t, -1)
    logits = jnp.einsum("td,de->te", xt, jnp.asarray(a["w_router"]))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jax.ops.segment_sum(jnp.ones_like(sorted_e), sorted_e,
                                 num_segments=cfg.n_experts)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(t * cfg.top_k) - starts[sorted_e]
    keep = np.zeros(t * cfg.top_k, bool)
    keep[np.asarray(order)] = np.asarray(pos < cap)
    return keep


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_drop_sets_match_reference(runs, case, profile):
    """The pairs kept: under a2a each rank's own tokens at cap max(4,
    T_loc·k·cf // E) per (expert, source rank); under tp, the union of
    the model ranks' kept pairs of their experts is the reference's
    dispatch of the data block at cap max(8, ·).  At cf 1.25 both drop."""
    cfg, (cf, a) = runs["cfgs"][case], runs["cases"][case]
    ranks = [r[case, profile] for r in runs["port"]]
    spec = ranks[0]["xspec"]
    dropped = 0
    for rank, r in enumerate(ranks):
        block = local_block(a["x"], spec, MESH, rank)
        t = block.shape[0] * block.shape[1]
        if profile == "fsdp":
            got = r["valid"]
            want = _ref_keeps(cfg, a, block, max(4, int(t * 2 * cf) // 8))
        else:
            d, _ = M._block(MESH, rank, ("data",))
            if rank % SHAPE[1]:
                continue
            got = np.logical_or.reduce([ranks[d * SHAPE[1] + j]["valid"]
                                        for j in range(SHAPE[1])])
            want = _ref_keeps(cfg, a, block, max(8, int(t * 2 * cf) // 8))
        np.testing.assert_array_equal(got, want)
        dropped += int((~want).sum())
    assert (dropped > 0) == (cf < 8)


@pytest.mark.parametrize("case", list(CASES))
def test_collective_bytes(runs, case):
    """a2a moves two (E, cap, D) f32 buffers each way (forward, backward)
    and gathers nothing; tp exchanges no all-to-all and gathers the
    (T, D) output from the 4 ranks of its "model" subgroup in the forward
    and the x cotangent in the backward."""
    cfg, (cf, a) = runs["cfgs"][case], runs["cases"][case]
    b, s, d = a["x"].shape
    for r in runs["port"]:
        t_a2a = b * s // 8
        cap = max(4, int(t_a2a * 2 * cf) // 8)
        assert r[case, "fsdp"]["a2a_bytes"] == 4 * 8 * cap * d * 4
        assert r[case, "fsdp"]["gathered_bytes"] == 0
        t_tp = b * s // 2
        assert r[case, "tp"]["a2a_bytes"] == 0
        assert r[case, "tp"]["gathered_bytes"] == 2 * 4 * t_tp * d * 4


def test_all_to_all_matches_jax(runs):
    """`all_to_all` over "model" of each rank's (4, 3) integer block
    equals `jax.lax.all_to_all(t, "model", 0, 0, tiled=False)` under
    shard_map, block for block."""
    want = runs["ref"]["probe"]
    for rank, r in enumerate(runs["port"]):
        np.testing.assert_array_equal(
            r["probe"], local_block(want, (("data", "model"),), MESH, rank))


def test_expert_blocks_are_local_blocks(runs):
    """Each rank's experts are its block of w_in under ("model", None,
    None), the block jax's placement gives its device."""
    a = runs["cases"]["cf8"][1]
    placed = runs["ref"]["placed"]
    for rank, r in enumerate(runs["port"]):
        np.testing.assert_array_equal(
            r["cf8", "tp"]["w_in"],
            local_block(a["w_in"], J.EXPERT_SPEC, MESH, rank))
        lo, hi = placed[J.EXPERT_SPEC, rank][0]
        np.testing.assert_array_equal(r["cf8", "tp"]["w_in"],
                                      a["w_in"][lo:hi])


@pytest.mark.parametrize("spec", PLACEMENTS, ids=str)
def test_local_block_matches_jax_placement(runs, spec):
    """`local_block` gives each rank the index ranges jax's
    ``NamedSharding.devices_indices_map`` gives the device at its mesh
    position, for one- and two-axis entries in either order."""
    full = np.arange(np.prod(PLACED_SHAPE)).reshape(PLACED_SHAPE)
    for rank in RANKS:
        want = full[tuple(slice(lo, hi) for lo, hi
                          in runs["ref"]["placed"][spec, rank])]
        np.testing.assert_array_equal(local_block(full, spec, MESH, rank),
                                      want)
