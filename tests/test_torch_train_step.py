"""`repro_torch.train.make_train_step`, remat and `launch.train.build`
against `repro`'s, on the CPU at the reduced configs: three train steps
with AdamW and Adafactor at microbatches 1 and 2 (params and optimizer
state in the reference's layout), remat on and off bit for bit, one step
of every reduced arch under tests/test_archs_smoke.py:33-47's bars, and
examples/moe_router_init.py's flow.  Helpers and bars: see
tests/test_torch_train.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.specs import model_decl as ref_model_decl
from repro.models import transformer as rtf
from repro.models.params import tree_init as ref_tree_init
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.train import init_train_state as ref_init_state
from repro.train import make_train_step as ref_make_step
import repro_torch.configs as TC
from repro_torch.models import DecoderLM, EncDecLM
from repro_torch.optim import adafactor, adamw
from repro_torch.train import (init_train_state, make_train_step,
                               train_state_from_reference,
                               train_state_to_reference)

from test_torch_train import (ADAM_EPS, GRAD_REL, LOSS_REL, NOISE, STEP,
                              _batch, _cfgs, _close_tree, _model)


# ---------------------------------------------------------- train step ---

@pytest.mark.parametrize("arch,opt,microbatches", [
    ("qwen2-1.5b", "adamw", 1), ("qwen2-1.5b", "adamw", 2),
    ("qwen2-1.5b", "adafactor", 1), ("qwen2-1.5b", "adafactor", 2),
    ("zamba2-7b", "adafactor", 1), ("olmoe-1b-7b", "adamw", 2)])
def test_train_steps_match_reference(arch, opt, microbatches):
    """Three steps with an active clip (0.5 against norms of 4–8), the
    cosine schedule's warmup: params and optimizer state in the
    reference's layout."""
    rcfg, tcfg = _cfgs(arch)
    kw = {"eps": ADAM_EPS} if opt == "adamw" else {}
    r_opt = {"adamw": ref_adamw, "adafactor": ref_adafactor}[opt](**kw)
    t_opt = {"adamw": adamw, "adafactor": adafactor}[opt](**kw)
    params = ref_tree_init(jax.random.PRNGKey(0), ref_model_decl(rcfg))
    from repro.optim import cosine_schedule as rcos
    from repro_torch.optim import cosine_schedule as tcos
    r_step = jax.jit(ref_make_step(
        rcfg, r_opt, lambda s: rcos(s, peak=1e-2, warmup=2, total=6),
        grad_clip=0.5, microbatches=microbatches))
    t_step = make_train_step(
        tcfg, t_opt, lambda s: tcos(s, peak=1e-2, warmup=2, total=6),
        grad_clip=0.5, microbatches=microbatches)
    rs = ref_init_state(params, r_opt)
    ts = train_state_from_reference(
        tcfg, jax.tree_util.tree_map(np.asarray, rs), device="cpu")
    for k in range(3):
        batch = _batch(rcfg, b=4, seed=10 + k)
        rs, rm = r_step(rs, {kk: jnp.asarray(v) for kk, v in batch.items()})
        ts, tm = t_step(ts, batch)
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_REL)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=GRAD_REL)
        assert float(tm["grad_norm"]) > 0.5          # the clip is active
        assert float(tm["lr"]) == float(rm["lr"])
        assert int(tm["step"]) == int(rm["step"]) == k
    got = train_state_to_reference(ts)
    assert int(got["step"]) == int(rs.step) == 3
    _close_tree(jax.tree_util.tree_map(lambda t: t.numpy(), got["params"]),
                rs.params, skip=NOISE, **STEP)
    _close_tree(jax.tree_util.tree_map(lambda t: t.numpy(),
                                       got["opt_state"]),
                rs.opt_state, **STEP)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-7b", "olmoe-1b-7b",
                                  "whisper-medium"])
def test_remat_on_and_off_bit_equal(arch):
    """Recomputing each block (each hybrid period, each encoder and
    decoder block) in the backward pass changes no bit of a step."""
    out = []
    for remat in (True, False):
        _, tcfg = _cfgs(arch, remat=remat)
        cls = EncDecLM if tcfg.family == "encdec" else DecoderLM
        model = cls(tcfg, torch.Generator().manual_seed(0), device="cpu")
        model.requires_grad_(True)
        st = init_train_state(model, adamw())
        step = make_train_step(tcfg, adamw(), lambda s: 1e-3)
        for k in range(2):
            st, m = step(st, _batch(tcfg, seed=k))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: v.clone() for k, v in model.state_dict().items()}))
    (l1, n1, p1), (l2, n2, p2) = out
    assert l1 == l2 and n1 == n2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_remat_recomputes_blocks():
    """With remat a block's activations are not kept for the backward
    pass: only each block's input is saved across the stage."""
    counts = {}
    for remat in (True, False):
        _, tcfg = _cfgs("qwen2-1.5b", remat=remat)
        model = DecoderLM(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
        model.requires_grad_(True)
        n = [0]

        def pack(t):
            n[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(torch.zeros(2, 16, dtype=torch.int32))
        counts[remat] = n[0]
    assert counts[True] < counts[False] / 4, counts


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_smoke_train_step(arch):
    """tests/test_archs_smoke.py:33-47 on the port: one step, a finite
    loss within 0.5 of ln(vocab), finite parameters."""
    cfg = TC.reduced(TC.get_config(arch))
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    model = cls(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.requires_grad_(True)
    opt = adamw()
    state = init_train_state(model, opt)
    step = make_train_step(cfg, opt, lambda s: 1e-3)
    state, metrics = step(state, _batch(cfg))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), (arch, loss)
    assert loss == pytest.approx(np.log(cfg.vocab), rel=0.5)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert int(state.step) == 1


def test_moe_router_init_flow_trains():
    """examples/moe_router_init.py's flow on the port: a reduced olmoe
    with 16 experts, top-4, its embedding table a blob mixture; routers
    seeded from the table's fit (the reference's draws injected, against
    the reference's seeded routers); five steps through
    `launch.train.build` — the same five steps as the reference's — and
    the loss falls."""
    from repro.core.bigfcm import BigFCMConfig as RefConfig
    from repro.integration import fcm_router_init as ref_router_init
    from repro_torch.core import BigFCMConfig
    from repro_torch.data.synth import make_blobs
    from repro_torch.integration import fcm_router_init
    from repro_torch.launch.train import build
    rcfg, tcfg = _cfgs("olmoe-1b-7b", n_experts=16, top_k=4)
    params = ref_tree_init(jax.random.PRNGKey(0), rtf.decl(rcfg))
    tab, _ = make_blobs(rcfg.vocab_padded, rcfg.d_model, rcfg.n_experts,
                        spread=0.15, sep=1.0, seed=3)
    params["embed"]["table"] = jnp.asarray(tab * rcfg.d_model ** -0.5)
    kw = dict(n_clusters=16, combiner_eps=1e-6, max_iter=200,
              sample_size=256, use_driver=False)
    seeded, _ = ref_router_init(params, rcfg,
                                params["embed"]["table"].astype(jnp.float32),
                                fcm_cfg=RefConfig(backend="jnp", **kw),
                                scale=4.0)
    k_sample, k_seed = jax.random.split(jax.random.PRNGKey(0))
    n = tab.shape[0]
    sample_idx = np.asarray(jax.random.choice(k_sample, n, (256,),
                                              replace=False))
    seed_idx = np.asarray(jax.random.choice(k_seed, 256, (16,),
                                            replace=False))
    model = _model(tcfg, params)
    fcm_router_init(model, tcfg, np.asarray(params["embed"]["table"]),
                    fcm_cfg=BigFCMConfig(backend="torch", **kw), scale=4.0,
                    sample_idx=sample_idx, seed_idx=seed_idx, device="cpu")
    w_ref = np.asarray(seeded["stages"][0]["moe"]["w_router"])
    for l, blk in enumerate(model.stages[0].layers):
        np.testing.assert_allclose(blk.moe.w_router.detach().numpy(),
                                   w_ref[l], rtol=2e-3, atol=2e-4)
    # the same five steps: the port through `launch.train.build` from its
    # seeded model, the reference's `make_train_step` with build's
    # optimizer and schedule from the same weights (its `build` jits over
    # a mesh, which raises ShardingTypeError on jax 0.9.0 here)
    state, step_fn = build(tcfg, device="cpu", params=model)
    from repro.optim import cosine_schedule as rcos
    from repro_torch.models.params import to_reference
    start = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()),
        to_reference(model, ref_model_decl(rcfg)))
    r_state = ref_init_state(start, ref_adamw())
    r_step = jax.jit(ref_make_step(
        rcfg, ref_adamw(),
        lambda s: rcos(s, peak=3e-4, warmup=100, total=10_000)))
    tok = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (8, 32), 0,
                                        rcfg.vocab), np.int32)
    losses, r_losses = [], []
    for _ in range(5):
        state, m = step_fn(state, {"tokens": tok, "labels": tok})
        r_state, rm = r_step(r_state, {"tokens": jnp.asarray(tok),
                                       "labels": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
        r_losses.append(float(rm["loss"]))
    assert losses[-1] < losses[0]
    # the seeded routers hold near-coinciding centers: 19–32 of the 256
    # tokens a layer sit within 1e-5 (relative) of a top-k tie, which each
    # package's f32 rounding breaks its own way — not an oracle below 1e-3
    np.testing.assert_allclose(losses, r_losses, rtol=1e-3)
