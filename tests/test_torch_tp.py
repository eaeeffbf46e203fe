"""Model-parallel LM training (`repro_torch.sharding.spmd`, the sharded
`launch.train.train`) against `repro.launch.train.train` on the same
mesh and profile.

The port runs on 8 spawned gloo CPU ranks (`spawn_mesh`, once per mesh
shape, each rank running tests/torch_tp_jobs.py's `run_cases`); the
reference once in a subprocess on 8 forced CPU devices, its own
``train`` with ``build`` wrapped to record each step's metrics and the
parameters it starts from (a fresh ``train``, and so fresh jits, for
each mesh and profile: jit's cache does not key on them).  The port
starts from those very parameters (`from_reference`, cut by `build`).
Cases: reduced Qwen2 and reduced OLMoE on (2, 4) and (4, 2) ("data",
"model") meshes under "tp" and "fsdp", and the head-padded dense config
(6 → 8 Q heads over 2 KV heads, vocab 250 → 256) on (2, 4): 3 steps of
8 × 32 tokens, AdamW at its defaults; and OLMoE under Adafactor, Qwen2 in
2 microbatches.  The sequence split under "fsdp" (batches of 4 on (2,
4), rows over "data" only, positions over "model"): Qwen2, OLMoE at one
MoE layer and cf 8, Qwen2 with KV chunks of 4 under a rank's block of 8,
and OLMoE at 30 positions ("model" does not divide it: rows replicated
over "model"), with a witness of each rank's block and gathers; and
reduced Pixtral (4 patch embeddings and 12 tokens, the first rank's
block all prefix) through each package's ``build`` and its step, 3 steps
on the same batches.

Bars: losses and grad norms rtol 1e-5 (the sums split over ranks round
in another order); each rank's blocks after the last step against
`block_of` the reference's leaves at rtol 1e-4 and atol 1e-4 × the
leaf's largest update over the run, except where a gradient is rounding
noise: AdamW (eps 1e-8) steps such an element by up to lr either way,
so every element also passes within twice the summed learning rates of
the run (the K bias, whose gradient the softmax's shift invariance
makes near zero, takes that bar).  OLMoE's capacity is a rank's, so its
losses depend on the mesh: each mesh's are the reference's on it.  The
port on 8 ranks against itself on one rank (dense: the same losses and
blocks at the same bars); the subgroup collectives against the
gather-everything composition bit for bit; `make_host_mesh`,
`make_mesh_for` and `make_production_mesh` against the reference's
rules; `constrain`; every family past the family gate, refused on a mesh
only by `check_ranks` outside the mesh's process group."""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import mesh as M
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.ft.checkpoint import global_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import build, train
from repro_torch.models.params import tree_paths, tree_pspecs
from repro_torch.launch import specs as TS
from repro_torch.sharding import block_of, constrain, mesh_context, \
    profile_context, put_block

import torch_tp_jobs as J

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 420.0
NAMES = ("data", "model")
STEPS, BATCH, SEQ = 3, 8, 32
LOSS_RTOL = 1e-5
P_RTOL, P_UPDATE = 1e-4, 1e-4
CASES = [(f"{arch}/{shape[0]}x{shape[1]}/{profile}", arch, shape, profile,
          {}) for arch in ("qwen2-1.5b", "olmoe-1b-7b")
         for shape in ((2, 4), (4, 2)) for profile in ("tp", "fsdp")]
CASES += [("padded/2x4/tp", "padded", (2, 4), "tp", {}),
          # Adafactor's row / column means and update RMS over split leaves
          ("olmoe-1b-7b/2x4/tp/adafactor", "olmoe-1b-7b", (2, 4), "tp",
           {"optimizer": "adafactor"}),
          # each microbatch split over the ranks as the reference splits it
          ("qwen2-1.5b/4x2/tp/mb2", "qwen2-1.5b", (4, 2), "tp",
           {"microbatches": 2})]
ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "padded", "pixtral-12b") \
    + tuple(J.VARIANTS)
# a batch of 4 on (2, 4) under "fsdp": its rows split over "data" only
# (the reference's prefix rule), its 32 positions over "model" (the
# reference's "seq" rule) — 8 a rank
SPLIT = ("qwen2-1.5b/2x4/fsdp/b4", "qwen2-1.5b", (2, 4), "fsdp",
         {"batch": 4})
# the same split for OLMoE (its MoE layer gathers the rows' sequence) and
# for Qwen2 with KV chunks of 4 under a rank's block of 8; at 30
# positions, which "model" does not divide, the rows stay replicated
SEQ_CASES = [("olmoe-1l/2x4/fsdp/b4", "olmoe-1l", (2, 4), "fsdp",
              {"batch": 4}),
             ("qwen2-chunk/2x4/fsdp/b4", "qwen2-chunk", (2, 4), "fsdp",
              {"batch": 4}),
             ("olmoe-1l/2x4/fsdp/b4/s30", "olmoe-1l", (2, 4), "fsdp",
              {"batch": 4, "seq": 30})]

# reduced Pixtral under "fsdp" on (2, 4): 4 rows of 4 patch embeddings
# and 12 tokens, 4 positions a rank — the first rank's block all prefix,
# no label — through each package's ``build`` and its step on the same
# batches (the reference's ``train`` feeds tokens only)
PREFIX = ("pixtral-12b/2x4/fsdp/b4", "pixtral-12b", (2, 4), "fsdp",
          {"batches": J.prefix_batches(J.config("pixtral-12b"), STEPS)})

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import pickle, sys
    sys.path.insert(0, {src!r})
    import dataclasses
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config, reduced
    from repro.configs.base import ModelConfig
    from repro.launch import mesh as RLM
    import repro.launch.train as RT
    from repro.ft import elastic as RE
    from repro.sharding.rules import profile_context

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

    def config(arch):
        if arch == "padded":
            return ModelConfig(**args["padded"])
        if arch in args["variants"]:
            base, kw = args["variants"][arch]
            return dataclasses.replace(reduced(get_config(base)), **kw)
        return reduced(get_config(arch))

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
        # Pixtral: RT.train feeds no patch embeddings
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.launch import specs as S
        from repro.sharding.rules import mesh_context
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

    out = {{"init": {{}}}}
    for name, arch, shape, profile, opts in args["cases"]:
        mesh = Mesh(np.asarray(jax.devices()).reshape(shape),
                    ("data", "model"))
        opts = dict(opts)
        batch = opts.pop("batch", args["batch"])
        seq = opts.pop("seq", args["seq"])
        with profile_context(profile):
            if "batches" in opts:
                state, hist = build_and_step(config(arch), mesh,
                                             opts["batches"])
            else:
                state, hist = RT.train(config(arch), mesh,
                                       steps=args["steps"], batch=batch,
                                       seq=seq, log_fn=lambda *a: None,
                                       **opts)
        out["init"][arch] = rec["init"]
        out[name] = {{"losses": hist,
                     "grad_norms": [float(m["grad_norm"])
                                    for m in rec["metrics"]],
                     "lrs": [float(m["lr"]) for m in rec["metrics"]],
                     "params": paths(jax.device_get(state.params))}}
    devs = jax.devices()
    out["meshes"] = {{}}
    for n in (8, 6, 4):
        for mp in (2, 4):
            for pods in (1, 2):
                try:
                    m = RE.make_mesh_for(devs[:n], model_parallel=mp,
                                         pods=pods)
                except Exception:
                    out["meshes"]["for", n, mp, pods] = "raises"
                    continue
                if m.devices.size == 0:
                    out["meshes"]["for", n, mp, pods] = "empty"
                    continue
                ids = np.vectorize(lambda d: d.id)(m.devices)
                out["meshes"]["for", n, mp, pods] = (tuple(m.axis_names),
                                                     ids.tolist())
    for mp in (1, 2, 3, 4, 8, 16):
        m = RLM.make_host_mesh(mp)
        ids = np.vectorize(lambda d: d.id)(m.devices)
        out["meshes"]["host", mp] = (tuple(m.axis_names), ids.tolist())
    try:
        RLM.make_production_mesh()
    except RuntimeError as e:
        out["production"] = str(e)
    pickle.dump(out, open({out!r}, "wb"))
""")


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(dict(cases=CASES + [SPLIT] + SEQ_CASES + [PREFIX],
                             steps=STEPS,
                             batch=BATCH, seq=SEQ, padded=J.PADDED,
                             variants=J.VARIANTS), f)
        res = subprocess.run(
            [sys.executable, "-c", _REFERENCE.format(
                src=os.path.abspath(SRC), inp=inp, out=out)],
            capture_output=True, text=True, timeout=DEADLINE_S)
        assert res.returncode == 0, res.stderr[-3000:]
        with open(out, "rb") as f:
            ref = pickle.load(f)
    init = {arch: _nest(ref["init"][arch]) for arch in ARCHS}
    port = {}
    for shape in ((2, 4), (4, 2)):
        cases = [(name, arch, init[arch], profile, STEPS,
                  opts.get("batch", BATCH), opts.get("seq", SEQ),
                  {k: v for k, v in opts.items()
                   if k not in ("batch", "seq")})
                 for name, arch, s, profile, opts in CASES + [SPLIT]
                 + SEQ_CASES if s == shape]
        prefix = (PREFIX[0], init[PREFIX[1]], PREFIX[4]["batches"]) \
            if shape == PREFIX[2] else None
        port[shape] = M.spawn_mesh(
            J.run_cases, shape, NAMES, backend="gloo", device_type="cpu",
            timeout_s=DEADLINE_S, args=(cases, shape == (2, 4), 0, prefix))
    return dict(ref=ref, port=port, init=init)


def _nest(flat):
    from repro_torch.models.params import nest
    return nest(flat)


def _specs(arch, shape, profile):
    mesh = M.AbstractMesh(shape, NAMES)
    with profile_context(profile):
        return mesh, tree_paths(tree_pspecs(TS.model_decl(J.config(arch)),
                                            mesh))


def _noise_bar(ref_case):
    """Twice the summed learning rates of the run: AdamW's bound on how
    far an element whose gradient is rounding noise may step (Adafactor's
    update RMS is clipped to 1, its elements' steps alike)."""
    return 2.0 * sum(ref_case["lrs"]) * 1.01


def _hold_blocks(ranks, want, init, arch, shape, profile, noise):
    """Each rank's blocks against `block_of` the whole leaves ``want``."""
    mesh, specs = _specs(arch, shape, profile)
    for path, spec in specs.items():
        full = np.asarray(want[path])
        update = float(np.abs(full - np.asarray(init[path])).max())
        for rank, r in enumerate(ranks):
            got = r["blocks"][path]
            blk = block_of(full, spec, mesh, rank)
            bar = P_RTOL * np.abs(blk) + P_UPDATE * update
            bar = np.maximum(bar, noise) if path.endswith("attn/bk") \
                else bar
            bad = np.abs(got - blk) > bar
            assert not bad.any(), (path, rank, int(bad.sum()),
                                   float(np.abs(got - blk).max()), update)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_train_matches_reference_on_mesh(runs, case):
    """Losses, grad norms and every rank's final blocks against the
    reference's ``train`` on the same mesh and profile."""
    name, arch, shape, profile, opts = case
    ref = runs["ref"][name]
    ranks = [r[name] for r in runs["port"][shape]]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                   rtol=LOSS_RTOL)
    _hold_blocks(ranks, ref["params"], runs["ref"]["init"][arch], arch,
                 shape, profile, _noise_bar(ref))


def test_moe_losses_depend_on_the_mesh(runs):
    """OLMoE's capacity is per rank: its losses differ between (2, 4) and
    (4, 2) under "tp", in the reference and alike in the port."""
    ref = runs["ref"]
    a, b = "olmoe-1b-7b/2x4/tp", "olmoe-1b-7b/4x2/tp"
    assert abs(ref[a]["losses"][1] - ref[b]["losses"][1]) > 1e-3
    port_a = runs["port"][(2, 4)][0][a]["losses"]
    port_b = runs["port"][(4, 2)][0][b]["losses"]
    np.testing.assert_allclose(port_a, ref[a]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port_b, ref[b]["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "padded"])
def test_mesh_step_matches_one_rank(runs, arch):
    """The 8-rank (2, 4) "tp" run against the port's own one-rank
    ``train`` from the same parameters."""
    cfg = J.config(arch)
    norms = []
    state, losses = train(cfg, None, steps=STEPS, batch=BATCH, seq=SEQ,
                          device="cpu",
                          params=J.whole_model(cfg, runs["init"][arch]),
                          log_fn=lambda *a: None,
                          on_step=lambda i, m: norms.append(
                              float(m["grad_norm"])))
    name = f"{arch}/2x4/tp"
    ranks = [r[name] for r in runs["port"][(2, 4)]]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=LOSS_RTOL)
    whole = {k: v.detach().numpy() for k, v in tree_paths(
        J.sharded_checkpoint_tree(state).params).items()}
    _hold_blocks(ranks, whole, runs["ref"]["init"][arch], arch, (2, 4),
                 "tp", _noise_bar(runs["ref"][name]))


def test_backward_on_another_thread(runs):
    """A rematted block's recompute runs where autograd runs the
    backward — for CUDA tensors its device thread, which sees none of the
    forward's contexts: the gradients are the same as on the forward's
    thread (the recompute re-enters the mesh and profile)."""
    assert all(r["thread"] for r in runs["port"][(2, 4)])


def test_collectives_bytes_by_kind(runs):
    """Under "tp" a rank gathers parameters, reduce-scatters their
    cotangents and all-reduces activations over "model"; under "fsdp"
    (Qwen2) it all-reduces no activation over "model" — its psums are the
    loss, the grad norm and the norm scales' gradients."""
    for r in runs["port"][(2, 4)]:
        tp = r["qwen2-1.5b/2x4/tp"]["bytes"]
        fsdp = r["qwen2-1.5b/2x4/fsdp"]["bytes"]
        assert tp["param_gather_bytes"] > 0 and tp["reduce_scatter_bytes"] > 0
        assert fsdp["param_gather_bytes"] > 0
        assert tp["psum_bytes"] > 10 * fsdp["psum_bytes"]
        assert tp["all_to_all_bytes"] == fsdp["all_to_all_bytes"] == 0
        assert r["olmoe-1b-7b/2x4/fsdp"]["bytes"]["all_to_all_bytes"] > 0


@pytest.mark.parametrize("axes", [("model",), ("data",), ("data", "model"),
                                  ("model", "data")], ids=str)
def test_subgroup_collectives_equal_composition(runs, axes):
    """`psum`, `all_gather` and `reduce_scatter` on the axes' subgroup
    equal a gather from every rank composed in process, bit for bit."""
    for r in runs["port"][(2, 4)]:
        for what, (got, want) in r["collectives"][axes].items():
            if got is None:
                continue
            assert torch.equal(got, want), (axes, what)


def test_gather_param_backward_is_reduce_scatter(runs):
    ranks = runs["port"][(2, 4)]
    full = ranks[0]["collectives"]["gather_param"][0]
    weights = torch.arange(full.numel(), dtype=torch.float32).reshape(
        full.shape)
    for rank, r in enumerate(ranks):
        got_full, grad = r["collectives"]["gather_param"]
        assert torch.equal(got_full, full)
        # every rank's cotangent is the same weights: summed over 8
        want = M.sum_in_order([weights] * 8).chunk(8, 0)[rank]
        assert torch.equal(grad, want)


def test_meshes_match_reference_rules(runs):
    """`make_host_mesh(mp)` for mp in {1, 2, 3, 4, 8, 16} and
    `make_mesh_for` for 8, 6 and 4 ranks at model_parallel 2 or 4 and pods
    1 or 2: the reference's shapes, names and rank order (its device
    ids); where its mesh holds no device (4 ranks, 4 a replica, 2 pods:
    no data rank), the port raises."""
    want = runs["ref"]["meshes"]
    for r in runs["port"][(2, 4)]:
        got = r["meshes"]
        assert set(got) == set(want)
        for key in want:
            if want[key] in ("raises", "empty"):
                assert got[key] == "raises", key
            else:
                assert got[key] == (tuple(want[key][0]), want[key][1]), key


def test_production_mesh_raises_below_256_ranks(runs):
    assert "needs 256" in runs["ref"]["production"]
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)


def test_elastic_remesh_gives_local_blocks(runs):
    """`elastic_remesh` (2, 4) → (4, 2): each rank's blocks of every leaf
    of the train state, under the same placements, on the new mesh."""
    ranks = runs["port"][(2, 4)]
    cfg = J.config("qwen2-1.5b")
    old, new = M.AbstractMesh((2, 4), NAMES), M.AbstractMesh((4, 2), NAMES)
    with profile_context("tp"):
        specs = tree_paths(TS.train_state_pspecs(cfg, "adamw", old))
    for path, spec in specs.items():
        blocks = [r["remesh"]["old"][path] for r in ranks]
        full = np.zeros(global_shape(blocks[0].shape, spec, old),
                        blocks[0].dtype)
        for rank, blk in enumerate(blocks):
            put_block(full, blk, spec, old, rank)
        for rank, r in enumerate(ranks):
            np.testing.assert_array_equal(r["remesh"]["new"][path],
                                          block_of(full, spec, new, rank))


def test_constrain_checks_the_block():
    mesh = M.AbstractMesh((2, 4), NAMES)
    x = torch.zeros(4, 16, 8)
    with mesh_context(mesh):
        assert constrain(x, "batch", "seq", "act_mlp",
                         shape=(8, 16, 32)) is x
        with pytest.raises(ValueError, match="not the"):
            constrain(x, "batch", "seq", "act_mlp", shape=(8, 16, 8))
        with pytest.raises(ValueError, match="global shape"):
            constrain(x, "batch", "seq", "act_mlp")
    assert constrain(x, "batch", "seq", "act_mlp") is x     # no mesh


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b",
                                  "whisper-medium"])
def test_other_families_raise_on_a_mesh(arch):
    """Mamba2, the hybrid and the encoder–decoder pass the family gate as
    the dense decoder does: on a mesh of which this process is no rank,
    `build` and `train` raise `spmd.check_ranks`' error, and nothing
    else (tests/test_torch_tp_families.py trains them on a mesh)."""
    cfg = treduced(tget_config(arch))
    mesh = M.AbstractMesh((2, 4), NAMES)
    with pytest.raises(RuntimeError, match="this process is none of them"):
        build(cfg, mesh, device="cpu")
    with pytest.raises(RuntimeError, match="this process is none of them"):
        train(cfg, mesh, steps=1, batch=8, seq=8, device="cpu")


def _hold_case(runs, case):
    """Losses, grad norms and every rank's final blocks of ``case``
    against the reference's."""
    name, arch, shape, profile, _ = case
    want = runs["ref"][name]
    ranks = runs["port"][shape]
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[name]["grad_norms"],
                                   want["grad_norms"], rtol=LOSS_RTOL)
    _hold_blocks([r[name] for r in ranks], want["params"],
                 runs["ref"]["init"][arch], arch, shape, profile,
                 _noise_bar(want))


def test_batch_replicated_over_model_matches_reference(runs):
    """A batch of 4 on (2, 4) under "fsdp" splits its rows over "data"
    only (the reference's rule), and its 32 positions over "model" (the
    reference's "seq" rule, 8 a rank: the ranks on "model" no longer
    replicate each other's work): the losses and grad norms are the
    reference's on the same mesh, every rank's final blocks too."""
    _hold_case(runs, SPLIT)
    for r in runs["port"][SPLIT[2]]:
        assert r[SPLIT[0]]["bytes"]["seq_gather_bytes"] > 0


@pytest.mark.parametrize("case", SEQ_CASES, ids=[c[0] for c in SEQ_CASES])
def test_sequence_split_matches_reference(runs, case):
    """OLMoE's MoE layer on the gathered sequence, Qwen2's KV-chunked
    softmax over the gathered K/V from a rank's offset, and a length
    "model" does not divide (rows replicated over it, the MoE layer's
    parts summed both ways): the reference's "fsdp" ``train`` on the
    same mesh, at the file's bars."""
    _hold_case(runs, case)
    moved = [r[case[0]]["bytes"]["seq_gather_bytes"]
             for r in runs["port"][case[2]]]
    split = case[4].get("seq", SEQ) % case[2][1] == 0
    assert all((m > 0) == split for m in moved), moved


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1l"])
def test_each_rank_holds_its_block_of_the_sequence(runs, arch):
    """The split on: a rank's hidden state holds S/"model" = 8 of 32
    positions from its coordinate on "model" times 8, and its K/V (and
    MoE input) gathers move bytes; at 30 positions the rows are whole on
    every rank and nothing is gathered."""
    model = 4
    for rank, r in enumerate(runs["port"][(2, 4)]):
        shape, blk, moved = r["witness"][arch][32]
        assert shape == (2, 32 // model, 64) and moved > 0
        assert blk == (("model",), 32, (rank % model) * 8, 8)
        shape, blk, moved = r["witness"][arch][30]
        assert shape == (2, 30, 64) and blk is None and moved == 0


def test_prefix_only_block_trains_as_one_rank(runs):
    """Reduced Pixtral's 4 patch embeddings and 12 tokens under "fsdp"
    on (2, 4): 4 positions a rank, the first rank's all prefix and no
    label — it still runs its part of every collective in the backward,
    and the step's loss and grad norm are one rank's."""
    cfg = J.config("pixtral-12b")
    whole = J.DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
    state, step = build(cfg, device="cpu", params=whole)
    _, m = step(state, J.prefix_batch(cfg))
    for r in runs["port"][(2, 4)]:
        np.testing.assert_allclose(r["prefix"], (float(m["loss"]),
                                                 float(m["grad_norm"])),
                                   rtol=LOSS_RTOL)


def test_prefix_split_matches_reference(runs):
    """Reduced Pixtral's patch embeddings under the split: the first
    rank's block all prefix, the others' prefix embeddings at their
    global positions, K/V gathered over "model" — the losses, grad norms
    and every rank's final blocks of 3 steps are the reference's sharded
    step's on the same mesh, at the file's bars."""
    _hold_case(runs, PREFIX)
    for r in runs["port"][PREFIX[2]]:
        assert r[PREFIX[0]]["bytes"]["seq_gather_bytes"] > 0


def test_scatter_seq_is_gather_seqs_transpose(runs):
    """`scatter_seq` over "model" keeps this rank's block (dim 1) of the
    partials summed in rank order, and its backward gathers the
    cotangent blocks along that dim."""
    def t(rank):                        # torch_tp_jobs.collectives' draw
        return torch.tensor(np.random.default_rng(rank).normal(
            size=(8, 4)).astype(np.float32))
    weights = 1 + torch.arange(8, dtype=torch.float32).reshape(8, 1)
    for rank, r in enumerate(runs["port"][(2, 4)]):
        blk, grad = r["collectives"]["scatter_seq"]
        first, m = rank - rank % 4, rank % 4
        want = M.sum_in_order([t(j) for j in range(first, first + 4)])
        assert torch.equal(blk, want[:, m:m + 1])
        assert torch.equal(grad, weights.expand(8, 4))
