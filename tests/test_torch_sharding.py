"""`repro_torch.sharding.rules`, the shape side of `repro_torch.launch.specs`
and the placement parts of `repro_torch.models` against the reference's.

Placements are computed on both sides without devices: the reference's
on `repro.compat.abstract_mesh`, the port's on
`repro_torch.mesh.AbstractMesh`, at the production meshes (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model"), under both
profiles, for all ten archs.  A reference ``PartitionSpec`` and a port
tuple are compared after padding both to the leaf's rank with ``None``
(on jax 0.9.0 ``PartitionSpec(None) != PartitionSpec()``), leaf for leaf
in `jax.tree_util`'s order.  The abstract trees are the port's ``meta``
tensors against ``jax.eval_shape``'s ShapeDtypeStructs, shape and dtype,
leaf for leaf — Kimi-K2's 1,027 B parameters included."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from conftest import seeded_cases
import repro.configs as RC
import repro.launch.specs as RS
import repro.models.attention as RA
import repro.sharding.rules as RR
from repro.compat import abstract_mesh as ref_abstract_mesh
from repro.models.params import tree_init as ref_tree_init
from repro.optim.optimizers import make as ref_make_opt
import repro_torch.configs as TC
import repro_torch.launch.specs as TS
import repro_torch.models.attention as TA
import repro_torch.sharding.rules as TR
from repro_torch.mesh import AbstractMesh
from repro_torch.models.params import (from_reference, reference_layout,
                                       tree_paths)
from repro_torch.optim import make as make_opt

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("tp", "fsdp")


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _leaves(tree):
    """The port tree's leaves in `jax.tree_util`'s order: dict keys
    sorted, lists and NamedTuples in order; a plain tuple (a placement)
    or a tensor is a leaf."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and hasattr(tree, "_fields")):
        return [l for t in tree for l in _leaves(t)]
    return [tree]


def _pad(spec, rank):
    spec = tuple(spec)
    assert len(spec) <= rank, (spec, rank)
    return spec + (None,) * (rank - len(spec))


def _same_specs(got, want, abstract, what):
    got, want, ab = _leaves(got), _ref_leaves(want), _leaves(abstract)
    assert len(got) == len(want) == len(ab), (what, len(got), len(want),
                                              len(ab))
    for i, (g, w, a) in enumerate(zip(got, want, ab)):
        assert TR.is_spec(g), (what, i, g)
        assert _pad(g, a.ndim) == _pad(w, a.ndim), (what, i, g, w, a.shape)


def _same_abstract(got, want, what):
    got, want = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "meta", (what, i)
        assert tuple(g.shape) == tuple(w.shape), (what, i, g.shape, w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), \
            (what, i, g.dtype, w.dtype)


def _cells(cfg, kinds):
    return [c for c in TC.SHAPES
            if c.kind in kinds and TC.cell_applicable(cfg, c) is None]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_placements_match_reference(arch, profile, mesh_name):
    """Params, AdamW and Adafactor states, train states, batches (every
    train / prefill cell) and caches (every decode cell) placed as the
    reference places them."""
    shape, names = MESHES[mesh_name]
    tmesh, rmesh = AbstractMesh(shape, names), ref_abstract_mesh(shape,
                                                                  names)
    tcfg, rcfg = TC.get_config(arch), RC.get_config(arch)
    with TR.profile_context(profile), RR.profile_context(profile):
        params = TS.abstract_params(tcfg)
        _same_specs(TS.param_pspecs(tcfg, tmesh),
                    RS.param_pspecs(rcfg, rmesh), params, "params")
        for opt in ("adamw", "adafactor"):
            state = TS.abstract_train_state(tcfg, make_opt(opt))
            _same_specs(TS.opt_pspecs(tcfg, opt, tmesh),
                        RS.opt_pspecs(rcfg, opt, rmesh), state.opt_state,
                        opt)
            _same_specs(TS.train_state_pspecs(tcfg, opt, tmesh),
                        RS.train_state_pspecs(rcfg, opt, rmesh), state,
                        "train state " + opt)
        for cell in _cells(tcfg, ("train", "prefill")):
            _same_specs(TS.batch_pspecs(tcfg, cell, tmesh),
                        RS.batch_pspecs(rcfg, cell, rmesh),
                        TS.batch_inputs(tcfg, cell), cell.name)
        for cell in _cells(tcfg, ("decode",)):
            caches, _ = TS.decode_inputs(tcfg, cell)
            ref_caches, _ = RS.decode_inputs(rcfg, cell)
            b = cell.global_batch
            _same_specs(TS.cache_pspecs(tcfg, caches, b, tmesh),
                        RS.cache_pspecs(rcfg, ref_caches, b, rmesh), caches,
                        cell.name)
            assert TS._bspec(b, tmesh, None) == \
                tuple(RS._bspec(b, rmesh, None)), cell.name


@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_abstract_trees_match_eval_shape(arch):
    """abstract_params, abstract_train_state (AdamW, Adafactor),
    batch_inputs, abstract_caches and decode_inputs: meta tensors of
    jax.eval_shape's shapes and dtypes, leaf for leaf."""
    tcfg, rcfg = TC.get_config(arch), RC.get_config(arch)
    _same_abstract(TS.abstract_params(tcfg), RS.abstract_params(rcfg),
                   "params")
    for opt in ("adamw", "adafactor"):
        _same_abstract(TS.abstract_train_state(tcfg, make_opt(opt)),
                       RS.abstract_train_state(rcfg, ref_make_opt(opt)),
                       opt)
    for cell in _cells(tcfg, ("train", "prefill")):
        _same_abstract(TS.batch_inputs(tcfg, cell),
                       RS.batch_inputs(rcfg, cell), cell.name)
    for cell in _cells(tcfg, ("decode",)):
        _same_abstract(list(TS.decode_inputs(tcfg, cell)),
                       RS.decode_inputs(rcfg, cell), cell.name)
        _same_abstract(TS.abstract_caches(tcfg, 4, 64),
                       RS.abstract_caches(rcfg, 4, 64), "caches 4 × 64")


def test_kimi_abstract_state_allocates_nothing():
    """Kimi-K2's 1,027 B parameters and its Adafactor state build as
    meta tensors: nothing is allocated."""
    cfg = TC.get_config("kimi-k2-1t-a32b")
    state = TS.abstract_train_state(cfg, make_opt("adafactor"))
    leaves = _leaves(state)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in _leaves(state.params)) > 1.0e12


def test_rules_tables_match_reference():
    assert TR.LOGICAL_RULES == RR.LOGICAL_RULES
    assert TR.FSDP_RULES == RR.FSDP_RULES
    assert set(TR.PROFILES) == set(RR.PROFILES)
    for name in TR.PROFILES:
        assert TR.PROFILES[name] == RR.PROFILES[name]


def test_mesh_and_profile_contexts():
    """Contexts nest and restore; an unknown profile raises; data_axes
    reads the active mesh."""
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert TR.get_mesh() is None and TR.get_profile() == "tp"
    assert TR.data_axes() == ("data",)
    with TR.mesh_context(mesh) as m:
        assert m is mesh and TR.get_mesh() is mesh
        assert TR.data_axes() == ("pod", "data")
        with TR.profile_context("fsdp"):
            assert TR.get_profile() == "fsdp"
            with TR.mesh_context(None):
                assert TR.get_mesh() is None
            assert TR.get_mesh() is mesh
        assert TR.get_profile() == "tp"
    assert TR.get_mesh() is None
    with pytest.raises(ValueError):
        TR.set_profile("zero")
    with pytest.raises(ValueError):
        with TR.profile_context("zero"):
            pass


_LOGICAL = sorted((k for k in TR.LOGICAL_RULES if k is not None)) + [None]


def _gen_logical(rng):
    n = int(rng.integers(1, 5))
    logical = tuple(_LOGICAL[int(i)] for i in
                    rng.integers(0, len(_LOGICAL), n))
    dims = (None if rng.random() < 0.2 else
            tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 8, 12, 16], n)))
    return logical, dims, PROFILES[int(rng.integers(0, 2))]


def _check_logical(case):
    logical, dims, profile = case
    tmesh = AbstractMesh((2, 4), ("data", "model"))
    rmesh = ref_abstract_mesh((2, 4), ("data", "model"))
    with TR.profile_context(profile), RR.profile_context(profile):
        want = RR.logical_to_spec(logical, rmesh, dims=dims)
        got = TR.logical_to_spec(logical, tmesh, dims=dims)
        with TR.mesh_context(tmesh), RR.mesh_context(rmesh):
            assert TR.logical_to_spec(logical, dims=dims) == got
    assert got == tuple(want), case


if HAVE_HYPOTHESIS:
    _logical_st = st.lists(st.sampled_from(_LOGICAL), min_size=1,
                           max_size=4)

    @settings(max_examples=200, deadline=None)
    @given(_logical_st.flatmap(lambda lg: st.tuples(
        st.just(tuple(lg)),
        st.one_of(st.none(), st.tuples(*[st.sampled_from(
            [1, 2, 3, 4, 6, 8, 12, 16]) for _ in lg])),
        st.sampled_from(PROFILES))))
    def test_logical_to_spec_matches_reference(case):
        """Drawn logical tuples and dims on a (2, 4) mesh, divisibility
        trims and the one-dim-per-axis rule included."""
        _check_logical(case)
else:
    @seeded_cases(_gen_logical, n=200)
    def test_logical_to_spec_matches_reference(case):
        _check_logical(case)


@pytest.mark.parametrize("model", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_kv_logical_and_cache_logical_match_reference(arch, model):
    tcfg, rcfg = TC.get_config(arch), RC.get_config(arch)
    assert TA.cache_logical(tcfg, model) == RA.cache_logical(rcfg, model)
    shape, names = (2, model), ("data", "model")
    with TR.mesh_context(AbstractMesh(shape, names)), \
            RR.mesh_context(ref_abstract_mesh(shape, names)):
        assert TA._kv_logical(tcfg) == RA._kv_logical(rcfg)
    assert TA._kv_logical(tcfg) == "kv_heads"


def test_local_blocks_tile_the_tensor():
    """Every rank's blocks of a leaf under its placement tile the leaf:
    each element held by as many ranks as the placement replicates it
    over, and blocks of replicated ranks equal."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    t = torch.arange(8 * 12 * 4).reshape(8, 12, 4)
    for spec in [("data", "model"), (("data", "model"),), (None, "data"),
                 (("model", "data"), None, None), ()]:
        seen = torch.zeros_like(t)
        for r in range(8):
            seen[tuple(slice(b.start, b.stop) for b in _index(t, spec, mesh,
                                                              r))] += 1
        named = {a for e in spec for a in TR.spec_axes(e)}
        rep = int(np.prod([s for a, s in zip(("data", "model"), (2, 4))
                           if a not in named]))
        assert (seen == rep).all(), spec
    with pytest.raises(ValueError):
        TR.local_block(torch.zeros(6, 2), ("model",), mesh, 0)


def _index(t, spec, mesh, rank):
    """The slices `local_block` takes, read off an index tensor."""
    out = []
    for i in range(t.ndim):
        ix = torch.arange(t.shape[i]).reshape(
            [-1 if j == i else 1 for j in range(t.ndim)]).expand(t.shape)
        blk = TR.local_block(ix, spec, mesh, rank)
        out.append(slice(int(blk.min()), int(blk.max()) + 1))
    return out


@pytest.mark.parametrize("profile", PROFILES)
def test_from_reference_gives_each_rank_its_blocks(profile):
    """`from_reference(..., decl=, mesh=, rank=)`: each of the port's
    per-layer parts of reduced OLMoE is the rank's block of the whole
    part under its leaf's placement (the layer axes never split), and
    some leaves do split."""
    rcfg = RC.reduced(RC.get_config("olmoe-1b-7b"))
    tcfg = TC.reduced(TC.get_config("olmoe-1b-7b"))
    decl = TS.model_decl(tcfg)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_tree_init(jax.random.PRNGKey(0), RS.model_decl(rcfg)))
    mesh = AbstractMesh((2, 4), ("data", "model"))
    whole = from_reference(tree, "cpu")
    with TR.profile_context(profile):
        specs = tree_paths(TS.param_pspecs(tcfg, mesh))
        split = 0
        for rank in range(8):
            got = from_reference(tree, "cpu", decl=decl, mesh=mesh,
                                 rank=rank)
            assert set(got) == set(whole)
            for path, (shape, keys) in reference_layout(decl).items():
                for key in keys:
                    lead = len(shape) - whole[key].ndim
                    assert all(e is None for e in specs[path][:lead])
                    want = TR.local_block(whole[key], specs[path][lead:],
                                          mesh, rank)
                    torch.testing.assert_close(got[key], want, rtol=0,
                                               atol=0)
                    split += got[key].shape != whole[key].shape
        assert split > 0
    with pytest.raises(ValueError):
        from_reference(tree, "cpu", mesh=mesh, rank=0)


def test_abstract_like():
    tree = {"a": torch.zeros(3, 2), "b": [torch.ones(4, dtype=torch.int32)],
            "c": TA.KVCache(torch.zeros(1, 2, 3, 4), torch.zeros(1, 2, 3, 4),
                            0)}
    out = TR.abstract_like(tree, torch.bfloat16)
    assert out["a"].device.type == "meta" and out["a"].shape == (3, 2)
    assert out["b"][0].dtype == torch.bfloat16
    assert isinstance(out["c"], TA.KVCache) and out["c"].length == 0
    assert TR.abstract_like(tree)["b"][0].dtype == torch.int32


def test_pspec_collapses_one_axis_tuples_as_partition_spec():
    for entries in [(("data",), None), (("pod", "data"), "model"), (None,),
                    ((), "data")]:
        assert TR.pspec(*entries) == tuple(P(*entries))
