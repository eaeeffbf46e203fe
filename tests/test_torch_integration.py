"""`repro_torch.integration` (FCM router init, curriculum bucketing) and
`repro_torch.sharding.data_axes` against `repro`'s.

tests/test_integration.py's two cases run on the port as they run on the
reference (driver race on).  Then both packages fit from the same
injected draws (the reference's `jax.random` sample and seed rows, the
driver off, so no wall-clock race picks a branch; reference backend
``jnp``, port ``torch``): router columns and centers within rtol 2e-3 /
atol 2e-4 (tests/test_torch_core.py's centers bar), bucket ids equal,
ambiguity within 1e-5, sampler batches identical."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.integration as RI
import repro.integration.curriculum as RCur
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core.bigfcm import BigFCMConfig as RefConfig
from repro.models import transformer as rtf
from repro.models.params import tree_init as ref_tree_init
from repro.sharding.rules import data_axes as ref_data_axes
import repro_torch.integration as TI
import repro_torch.integration.curriculum as TCur
from repro_torch.configs import get_config, reduced
from repro_torch.core import BigFCMConfig, hard_assign
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.data.synth import make_blobs
from repro_torch.models.params import ParamTree, PDecl
from repro_torch.sharding import data_axes
from torch_mesh_jobs import one_rank_mesh

CENTERS = dict(rtol=2e-3, atol=2e-4)


def _moe_cfgs():
    kw = dict(n_experts=8, top_k=2)
    return (dataclasses.replace(ref_reduced(ref_get_config("olmoe-1b-7b")),
                                **kw),
            dataclasses.replace(reduced(get_config("olmoe-1b-7b")), **kw))


def _reference_draws(cfg, n):
    """The reference fit's sample and seed indices (`bigfcm.py:_fit_array`
    and `_initial_centers`)."""
    k_sample, k_seed = jax.random.split(jax.random.PRNGKey(cfg.seed))
    lam = min(cfg.sample_size, n)
    sample_idx = np.asarray(jax.random.choice(k_sample, n, (lam,),
                                              replace=False))
    seed_idx = np.asarray(jax.random.choice(k_seed, lam, (cfg.n_clusters,),
                                            replace=False))
    return sample_idx, seed_idx


def _router_tree(rcfg, dtype=torch.float32):
    """The reference's OLMoE-reduced params with a blob embedding table:
    (reference tree, the same as a torch tree, the table as numpy)."""
    params = ref_tree_init(jax.random.PRNGKey(0), rtf.decl(rcfg), jnp.float32)
    tab, _ = make_blobs(rcfg.vocab_padded, rcfg.d_model, rcfg.n_experts,
                        spread=0.1, sep=2.0, seed=3)
    params["embed"]["table"] = jnp.asarray(tab)
    tree = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=dtype), params)
    return params, tree, tab


def test_fcm_router_init_coherent_routing():
    """tests/test_integration.py:23 on the port."""
    rcfg, cfg = _moe_cfgs()
    _, tree, tab = _router_tree(rcfg)
    emb = tree["embed"]["table"]
    seeded, res = TI.fcm_router_init(
        tree, cfg, emb,
        fcm_cfg=BigFCMConfig(n_clusters=cfg.n_experts, combiner_eps=1e-6,
                             max_iter=200, sample_size=128, backend="torch"),
        device="cpu")
    assert res.centers.shape == (cfg.n_experts, cfg.d_model)
    w = seeded["stages"][0]["moe"]["w_router"]
    assert w.shape[0] == cfg.n_layers - cfg.first_dense
    assert torch.equal(w[0], w[1])
    cluster = hard_assign(emb, res.centers).numpy()
    agree = float(((emb @ w[0]).argmax(1).numpy() == cluster).mean())
    assert agree > 0.9, agree
    # the input tree is left as it was; other leaves are carried over
    assert seeded["stages"][0]["moe"]["w_in"] is \
        tree["stages"][0]["moe"]["w_in"]
    assert not torch.equal(tree["stages"][0]["moe"]["w_router"][0], w[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fcm_router_init_matches_reference(dtype):
    rcfg, cfg = _moe_cfgs()
    params, tree, tab = _router_tree(rcfg, dtype)
    kw = dict(n_clusters=8, m=2.0, combiner_eps=1e-6, reducer_eps=1e-8,
              max_iter=200, sample_size=128, use_driver=False)
    want, rres = RI.fcm_router_init(
        params, rcfg, jnp.asarray(tab),
        fcm_cfg=RefConfig(backend="jnp", **kw), scale=0.5)
    sample_idx, seed_idx = _reference_draws(RefConfig(**kw), tab.shape[0])
    got, res = TI.fcm_router_init(
        tree, cfg, tab, fcm_cfg=BigFCMConfig(backend="torch", **kw),
        scale=0.5, sample_idx=sample_idx, seed_idx=seed_idx, device="cpu")
    np.testing.assert_allclose(res.centers.numpy(), np.asarray(rres.centers),
                               **CENTERS)
    w, w_ref = got["stages"][0]["moe"]["w_router"], \
        want["stages"][0]["moe"]["w_router"]
    assert w.dtype == dtype and tuple(w.shape) == w_ref.shape
    np.testing.assert_allclose(w.float().numpy(),
                               np.asarray(w_ref, np.float32),
                               rtol=CENTERS["rtol"] + (
                                   2 ** -8 if dtype == torch.bfloat16
                                   else 0), atol=CENTERS["atol"])
    # unit columns × scale: (v / ‖v‖)ᵀ · 0.5
    v = res.centers / (torch.linalg.norm(res.centers, dim=-1,
                                         keepdim=True) + 1e-8)
    assert torch.equal(w[0], (0.5 * v.T).to(dtype))


def test_fcm_router_init_sets_module_routers():
    """An `nn.Module`: every parameter named ``…w_router`` is set in
    place, (D, E) or stacked (L, D, E), in its own dtype."""
    rcfg, cfg = _moe_cfgs()
    _, _, tab = _router_tree(rcfg)
    d, e = cfg.d_model, cfg.n_experts
    mod = ParamTree({"stages": {"moe": {"w_router": PDecl((3, d, e),
                                                          (None,) * 3)}},
                     "head": {"w_router": PDecl((d, e), (None, None))},
                     "other": {"w": PDecl((d,), (None,))}},
                    dtype=torch.float32, device="cpu")
    kw = dict(n_clusters=e, sample_size=128, use_driver=False,
              backend="torch")
    got, res = TI.fcm_router_init(mod, cfg, tab, fcm_cfg=BigFCMConfig(**kw),
                                  device="cpu")
    assert got is mod
    tree = {"stages": [{"moe": {"w_router": torch.zeros(3, d, e)}}]}
    want, _ = TI.fcm_router_init(tree, cfg, tab, fcm_cfg=BigFCMConfig(**kw),
                                 device="cpu")
    assert torch.equal(mod.stages.moe.w_router,
                       want["stages"][0]["moe"]["w_router"])
    assert torch.equal(mod.head.w_router, mod.stages.moe.w_router[0])
    assert bool((mod.other.w == 0).all())
    with pytest.raises(ValueError, match="experts"):
        TI.fcm_router_init(tree, cfg, tab, fcm_cfg=BigFCMConfig(
            **{**kw, "n_clusters": e + 1}), device="cpu")


def test_curriculum_buckets_and_sampler():
    """tests/test_integration.py:47 on the port."""
    x, labels = make_blobs(2000, 16, 4, spread=0.3, sep=5.0, seed=0)
    bucket, amb, res = TI.curriculum_buckets(
        torch.from_numpy(x), 4,
        fcm_cfg=BigFCMConfig(n_clusters=4, combiner_eps=1e-6,
                             max_iter=200, sample_size=256, backend="torch"),
        device="cpu")
    bucket, amb = bucket.numpy(), amb.numpy()
    assert bucket.shape == (2000,) and amb.shape == (2000,)
    assert 0.0 <= amb.min() and amb.max() <= 1.0 + 1e-6
    assert clustering_accuracy(labels, bucket, 4) > 0.95

    batches = list(TI.CurriculumSampler(bucket, amb, batch=64))
    assert all(len(b) == 64 for b in batches)
    for b in batches:
        assert len(np.unique(bucket[b])) == 1
    rr = list(TI.CurriculumSampler(bucket, amb, batch=64,
                                   order="round_robin"))
    assert all(len(b) == 64 for b in rr)


@pytest.mark.parametrize("m,n_buckets", [(2.0, 4), (1.5, 6)])
def test_curriculum_matches_reference(m, n_buckets):
    x, _ = make_blobs(2000, 16, n_buckets, spread=0.6, sep=3.0, seed=1)
    kw = dict(n_clusters=n_buckets, m=m, combiner_eps=1e-6, max_iter=200,
              sample_size=256, use_driver=False)
    rb, ra, rres = RI.curriculum_buckets(
        jnp.asarray(x), n_buckets, fcm_cfg=RefConfig(backend="jnp", **kw))
    sample_idx, seed_idx = _reference_draws(RefConfig(**kw), 2000)
    b, a, res = TI.curriculum_buckets(
        x, n_buckets, fcm_cfg=BigFCMConfig(backend="torch", **kw),
        sample_idx=sample_idx, seed_idx=seed_idx, device="cpu")
    np.testing.assert_allclose(res.centers.numpy(), np.asarray(rres.centers),
                               **CENTERS)
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=0, atol=1e-5)
    assert b.dtype == torch.int64 and a.dtype == torch.float32
    for order in ("cohesion", "round_robin"):
        want = list(RI.CurriculumSampler(np.asarray(rb), np.asarray(ra),
                                         batch=48, order=order, seed=3))
        got = list(TI.CurriculumSampler(b.numpy(), a.numpy(), batch=48,
                                        order=order, seed=3))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_sequence_embeddings_match_reference(dtype, jdtype, monkeypatch):
    """The table's dtype out, as ``jnp.mean`` over a ``take`` gives (bf16
    within one bf16 rounding); row blocks change nothing."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(300, 24)).astype(np.float32) * 0.2
    tokens = rng.integers(0, 300, (37, 19))
    want = RCur.sequence_embeddings(jnp.asarray(table, jdtype),
                                    jnp.asarray(tokens, jnp.int32))
    tab = torch.tensor(table, dtype=dtype)
    got = TCur.sequence_embeddings(tab, torch.from_numpy(tokens))
    assert got.dtype == dtype and got.shape == (37, 24)
    rtol = 2 ** -8 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=1e-7)
    monkeypatch.setattr(TCur, "_GATHER_BYTES", 5 * 19 * 24 * 4)
    assert torch.equal(TCur.sequence_embeddings(tab, tokens), got)


@pytest.mark.parametrize("names", [("data",), ("pod", "data"),
                                   ("data", "model"), ("pod", "data",
                                                       "model")])
def test_data_axes_matches_reference(names):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(names)),
                names)
    assert data_axes(types.SimpleNamespace(mesh_dim_names=names)) == \
        ref_data_axes(mesh)
    assert data_axes() == data_axes(None) == ("data",)


def test_integration_on_a_one_rank_mesh():
    """``mesh=`` passes through to `bigfcm_fit`: on a 1-rank mesh (the
    single-device branch) both functions give the no-mesh answers."""
    x, _ = make_blobs(400, 8, 4, spread=0.3, seed=2)
    cfg = BigFCMConfig(n_clusters=4, sample_size=128, use_driver=False,
                       backend="torch")
    _, mcfg = _moe_cfgs()
    mcfg = dataclasses.replace(mcfg, n_experts=4)
    tree = {"w_router": torch.zeros(8, 4)}
    plain = (TI.curriculum_buckets(x, 4, fcm_cfg=cfg, device="cpu"),
             TI.fcm_router_init(tree, mcfg, x, fcm_cfg=cfg, device="cpu"))
    with one_rank_mesh() as mesh:
        meshed = (TI.curriculum_buckets(x, 4, fcm_cfg=cfg, mesh=mesh),
                  TI.fcm_router_init(tree, mcfg, x, fcm_cfg=cfg, mesh=mesh))
    assert torch.equal(meshed[0][0], plain[0][0])
    assert torch.equal(meshed[0][1], plain[0][1])
    assert torch.equal(meshed[1][0]["w_router"], plain[1][0]["w_router"])
