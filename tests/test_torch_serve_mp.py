"""Sharded serving (`repro_torch.serve.decode` on a sharded model) against
the reference's jitted ``make_prefill`` / ``make_serve_step`` with its
parameters, batch and caches placed by ``param_pspecs`` /
``batch_pspecs`` / ``cache_pspecs`` on the same mesh and profile.

The port runs on 8 spawned gloo CPU ranks of a (2, 4) ("data", "model")
mesh (`spawn_mesh`, once; each rank runs tests/torch_serve_jobs.py's
`run_cases`), the reference in a subprocess on 8 forced CPU devices
over a `jax.sharding.Mesh` (auto axes: `jax.make_mesh`'s explicit axes
make the reference's embedding raise), which writes its parameters
first and serves while the port's ranks do.  Cases: reduced Qwen2, OLMoE, Mamba2, Zamba2
and Whisper under "tp" with batches of 8 and 1 and under "fsdp" with 8
and 2 (2 is split over "data" only: the dense and MoE prefills split its
8 positions over "model", 2 a rank, K/V gathered into every rank's
cache block; the other families and the decode steps replicate it over
"model"), a prompt of 8 positions into a 16-slot cache, the greedy token
of the prefill and 3 decode steps.  The port starts from the reference's
parameters (`from_reference`, cut by `launch.train.shard_model`).

Bars: every rank's block of the prefill's last-position f32 logits (its
rows; its vocabulary block under "tp") within 1e-5 of the reference's
(rtol and atol), and the 4 greedy tokens of the global batch equal on
every rank.  OLMoE's capacity is a rank's, so its tokens depend on the
mesh: each case's are the reference's on it.  Where the reference
refuses its own placements (`REFERENCE_REFUSES`: its MoE ``shard_map``
at a batch of 1 under "tp", whose row does not split over "data"; the
SSM conv cache under "fsdp" at a batch of 8, whose placement names
"model" twice), its unsharded jit is the yardstick: one replicated row,
and a layer without capacity, compute alike on any mesh."""
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
from repro_torch.sharding import local_block, profile_context
from repro_torch.sharding.spmd import rows_axes

import torch_serve_jobs as J

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 420.0
SHAPE, NAMES = (2, 4), ("data", "model")
SEQ, MAX_LEN, STEPS = 8, 16, 3
RTOL = ATOL = 1e-5
ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "mamba2-2.7b", "zamba2-7b",
         "whisper-medium")
CASES = [(f"{arch}/{profile}/b{b}", arch, profile, b) for arch in ARCHS
         for profile, bs in (("tp", (8, 1)), ("fsdp", (8, 2)))
         for b in bs]
# the cases whose sharded jit the reference refuses, and why: its MoE
# shard_map takes rows that split over "data"; its cache_pspecs places a
# conv state's channels over "model" where the batch already took it
REFERENCE_REFUSES = {
    ("olmoe-1b-7b", "tp", 1): "not evenly divisible",
    ("mamba2-2.7b", "fsdp", 8): "DuplicateSpecError",
    ("zamba2-7b", "fsdp", 8): "DuplicateSpecError"}

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import pickle, sys
    sys.path.insert(0, {src!r})
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeCell
    from repro.launch import specs as S
    from repro.models.params import tree_init
    from repro.serve import make_prefill, make_serve_step
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

    def ns(mesh, specs):
        return jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda s: isinstance(s, P))

    def serve(cfg, params, batch, sharded, mesh):
        b = batch["tokens"].shape[0]
        prefill = make_prefill(cfg, args["max_len"])
        step = make_serve_step(cfg)
        if sharded:
            cell = ShapeCell("case", args["seq"], b, "prefill")
            psh = ns(mesh, S.param_pspecs(cfg, mesh))
            bsh = ns(mesh, S.batch_pspecs(cfg, cell, mesh))
            bsh = {{k: bsh[k] for k in batch}}
            logits, caches = jax.jit(prefill, in_shardings=(psh, bsh))(
                params, batch)
            csh = ns(mesh, S.cache_pspecs(cfg, caches, b, mesh))
            tsh = NamedSharding(mesh, S._bspec(b, mesh, None))
            caches = jax.device_put(caches, csh)
            step = jax.jit(step, in_shardings=(psh, csh, tsh),
                           out_shardings=(tsh, csh))
        else:
            logits, caches = jax.jit(prefill)(params, batch)
            step = jax.jit(step)
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)
        toks = [tok]
        for _ in range(args["steps"]):
            tok, caches = step(params, caches, tok)
            toks.append(np.asarray(tok))
        return {{"logits": np.asarray(logits, np.float32),
                 "tokens": np.concatenate(toks, 1)}}

    mesh = Mesh(np.asarray(jax.devices()).reshape({shape}), {names})
    params = {{arch: tree_init(jax.random.key(0), S.model_decl(
        reduced(get_config(arch)))) for arch in args["archs"]}}
    pickle.dump({{arch: paths(jax.device_get(p))
                 for arch, p in params.items()}},
                open({params!r} + ".tmp", "wb"))
    os.replace({params!r} + ".tmp", {params!r})
    out = {{}}
    for name, arch, profile, b in args["cases"]:
        cfg = reduced(get_config(arch))
        batch = args["batches"][name]
        try:
            with profile_context(profile), mesh_context(mesh), mesh:
                out[name] = serve(cfg, params[arch], batch, True, mesh)
            out[name]["sharded"] = True
        except Exception as e:
            out[name] = serve(cfg, params[arch], batch, False, mesh)
            out[name]["sharded"] = f"{{type(e).__name__}}: {{e}}"
    pickle.dump(out, open({out!r}, "wb"))
""")


def _batch(arch, b, seed):
    cfg = J.config(arch)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, SEQ)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)
                                   ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.models.params import nest
    batches = {name: _batch(arch, b, i)
               for i, (name, arch, _, b) in enumerate(CASES)}
    deadline = time.monotonic() + DEADLINE_S
    with tempfile.TemporaryDirectory() as tmp:
        inp, out, pp = (os.path.join(tmp, f) for f in
                        ("in.pkl", "out.pkl", "params.pkl"))
        with open(inp, "wb") as f:
            pickle.dump(dict(cases=CASES, archs=ARCHS, batches=batches,
                             seq=SEQ, max_len=MAX_LEN, steps=STEPS), f)
        ref_proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE.format(
                src=os.path.abspath(SRC), inp=inp, out=out, params=pp,
                shape=SHAPE, names=NAMES)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            # the port starts from the reference's draw, as soon as it is
            # written, and serves while the reference does
            while not os.path.exists(pp) and ref_proc.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
            assert os.path.exists(pp), ref_proc.communicate()[1][-3000:]
            with open(pp, "rb") as f:
                params = {a: nest(t) for a, t in pickle.load(f).items()}
            cases = [(name, arch, params[arch], profile, batches[name],
                      MAX_LEN, STEPS) for name, arch, profile, _ in CASES]
            port = M.spawn_mesh(J.run_cases, SHAPE, NAMES, backend="gloo",
                                device_type="cpu", timeout_s=DEADLINE_S,
                                args=(cases,))
            _, err = ref_proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if ref_proc.poll() is None:
                ref_proc.kill()
        assert ref_proc.returncode == 0, err[-3000:]
        with open(out, "rb") as f:
            ref = pickle.load(f)
    return dict(ref=ref, port=port)


def _logits_spec(arch, profile, b):
    cfg = J.config(arch)
    mesh = M.AbstractMesh(SHAPE, NAMES)
    with profile_context(profile):
        rows = rows_axes(b, mesh)
    vocab = "model" if profile == "tp" else None
    return mesh, (rows if rows else None, None, vocab)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_serving_matches_reference(runs, case):
    name, arch, profile, b = case
    want = runs["ref"][name]
    if want["sharded"] is not True:
        assert (arch, profile, b) in REFERENCE_REFUSES, want["sharded"]
        assert REFERENCE_REFUSES[arch, profile, b] in want["sharded"]
    mesh, spec = _logits_spec(arch, profile, b)
    for rank, got in enumerate(runs["port"]):
        got = got[name]
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=f"{name} rank {rank}")
        np.testing.assert_allclose(
            got["logits"], local_block(want["logits"], spec, mesh, rank),
            rtol=RTOL, atol=ATOL, err_msg=f"{name} rank {rank}")


def test_fsdp_prefill_splits_the_sequence(runs):
    """Under "fsdp" at a batch of 2 (rows over "data" only) the dense and
    MoE prefills gather their sequence's K/V (and the MoE layer's input)
    over "model"; at a batch of 8, and for the SSM, hybrid and
    encoder–decoder families, nothing is gathered so."""
    for name, arch, profile, b in CASES:
        moved = [r[name]["bytes"]["seq_gather_bytes"] for r in runs["port"]]
        split = profile == "fsdp" and b == 2 and arch in ("qwen2-1.5b",
                                                          "olmoe-1b-7b")
        assert all((m > 0) == split for m in moved), (name, moved)


def test_decode_moves_what_its_layout_needs(runs):
    """Under "tp" a step's collectives are the row-parallel sums and the
    vocabulary-parallel argmax (gathered, `mesh.psum` / `all_gather`);
    under "fsdp" the storage gathers of the parameters."""
    for name, arch, profile, b in CASES:
        moved = runs["port"][0][name]["bytes"]
        if profile == "tp":
            assert moved["psum_bytes"] > 0, name
        else:
            assert moved["param_gather_bytes"] > 0, name
        assert moved["gathered_bytes"] > 0, name
