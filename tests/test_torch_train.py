"""`repro_torch.train` (`model_loss`, `make_train_step`), `lm_loss`, remat,
`data.lm` and the router-init training flow against `repro`'s, on the
CPU at the reduced configs (`configs.reduced`).

The reference's own random parameters (`tree_init`) are carried across
with `from_reference` (the train state with `train_state_from_reference`);
batches are made with numpy from seeds.  Bars, f32: losses rtol 1e-5;
every gradient within 1e-4 of its leaf's largest |g| (sums in another
order; the port's softmax and logsumexp gradients are formed by autograd
where jax has custom rules); three train steps' parameters and optimizer
state rtol 1e-4 / atol 1e-5 of the O(1) weights (the hybrid's SSD sums
its f32 chunks in another order), the attention key bias left out (its
gradient is zero in exact arithmetic: a softmax row is shift-invariant,
so each package steps it by its own normalized rounding noise).  There
AdamW runs with eps 1e-4: at its default 1e-8 an element whose gradient
sits at rounding level takes g/√v's step of up to lr either way in each
package, so no bar below lr holds; the default eps is held op by op on
equal gradients in tests/test_torch_optim.py.  tests/test_archs_smoke.py:33-47's bars
for one step of every reduced arch; remat on and off bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data.lm import synthetic_token_batches as ref_batches
from repro.launch.specs import model_decl as ref_model_decl
from repro.models import transformer as rtf
from repro.models.params import tree_init as ref_tree_init
from repro.train.step import model_loss as ref_model_loss
import repro_torch.configs as TC
from repro_torch.data.lm import synthetic_token_batches
from repro_torch.models import DecoderLM, EncDecLM
from repro_torch.models import transformer as ttf
from repro_torch.models.params import from_reference
from repro_torch.train.step import loss_and_grads, param_groups

LOSS_REL, GRAD_REL = 1e-5, 1e-4
STEP = dict(rtol=1e-4, atol=1e-5)
ADAM_EPS = 1e-4
# The attention key bias's gradient is zero in exact arithmetic (a
# softmax row is shift-invariant): each package's optimizer normalizes
# its own rounding noise into a step, so its value after a step is no
# oracle (its gradient is held in test_model_loss_and_grads_match_reference).
NOISE = ("attn/bk",)
LOSS_ARCHS = ("qwen2-1.5b", "gemma-7b", "olmoe-1b-7b", "kimi-k2-1t-a32b",
              "mamba2-2.7b", "zamba2-7b", "whisper-medium", "pixtral-12b")


def _cfgs(arch, **kw):
    return (dataclasses.replace(RC.reduced(RC.get_config(arch)), **kw),
            dataclasses.replace(TC.reduced(TC.get_config(arch)), **kw))


def _batch(cfg, b=2, s=16, seed=0):
    """tests/test_archs_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _model(cfg, ref_params):
    cls = EncDecLM if cfg.family == "encdec" else DecoderLM
    model = cls(cfg, device="cpu")
    model.load_state_dict(from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu"))
    model.requires_grad_(True)
    return model


def _flat(tree):
    """A reference tree as {"a/0/b": numpy array}."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = np.asarray(v, np.float32)
    return out


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close_tree(got, want, skip=(), **tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        if not k.endswith(skip):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ------------------------------------------------------------- lm_loss ---

@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("chunk", [8, 32, 12])
def test_lm_loss_matches_reference(chunk, tied):
    """Value and gradients (hidden states, head) of the chunked CE: chunk
    8 and 32 divide S = 32, 12 lowers to 8; vocab 250 pads to 256 (the
    masked columns)."""
    kw = dict(vocab=250, loss_chunk=chunk, tie_embeddings=tied)
    rcfg, tcfg = _cfgs("qwen2-1.5b", **kw)
    rng = np.random.default_rng(3)
    b, s, d = 2, 32, rcfg.d_model
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    labels = rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32)
    head_key = ("embed", "table") if tied else ("lm_head", "w")
    shape = (rcfg.vocab_padded, d) if tied else (d, rcfg.vocab_padded)
    w = (0.1 * rng.normal(size=shape)).astype(np.float32)

    def ref(h, w_):
        p = {head_key[0]: {head_key[1]: w_}}
        return rtf.lm_loss(rcfg, p, h, jnp.asarray(labels))
    want, (gh, gw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w))
    h_t = torch.tensor(hidden, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    got = ttf.lm_loss(tcfg, {head_key[0]: {head_key[1]: w_t}}, h_t,
                      torch.as_tensor(labels))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=LOSS_REL)
    for g_t, g_r in ((h_t.grad, gh), (w_t.grad, gw)):
        scale = float(np.abs(np.asarray(g_r)).max())
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_r), rtol=0,
                                   atol=GRAD_REL * scale)
    if rcfg.vocab_padded != rcfg.vocab:       # the padded rows learn nothing
        pad = w_t.grad[rcfg.vocab:] if tied else w_t.grad[:, rcfg.vocab:]
        assert not bool(pad.any())


def test_lm_loss_recomputes_each_chunk():
    """Under grad each chunk's logits are recomputed in the backward pass:
    no (B, chunk, V) tensor is saved for it."""
    _, tcfg = _cfgs("qwen2-1.5b", loss_chunk=8)
    h = torch.randn(2, 32, tcfg.d_model, requires_grad=True)
    w = torch.randn(tcfg.vocab_padded, tcfg.d_model, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = ttf.lm_loss(tcfg, {"embed": {"table": w}}, h,
                           torch.zeros(2, 32, dtype=torch.int32))
    assert not any(s[-1] == tcfg.vocab_padded and len(s) == 3
                   for s in saved), saved
    loss.backward()
    assert h.grad is not None and w.grad is not None


# ---------------------------------------------------------- model_loss ---

@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_model_loss_and_grads_match_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    params = ref_tree_init(jax.random.PRNGKey(0), ref_model_decl(rcfg))
    batch = _batch(rcfg)
    want, g_ref = jax.jit(jax.value_and_grad(
        lambda p: ref_model_loss(rcfg, p, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    ))(params)
    model = _model(tcfg, params)
    groups = param_groups(model)
    drops = []
    if tcfg.is_moe:         # olmoe at cf 1.25 drops pairs in this batch
        from repro_torch.models import moe
        for stage in model.stages:
            for blk in stage.layers:
                if "moe" in blk._modules:
                    blk.moe.register_forward_hook(
                        lambda mod, a, out: drops.append(
                            moe.dropped_pairs(tcfg, mod, a[0].detach())))
    got, grads = loss_and_grads(tcfg, model, groups, _tensors(batch))
    if arch == "olmoe-1b-7b":
        assert sum(drops) > 0, drops
    assert float(got) == pytest.approx(float(want), rel=LOSS_REL)
    g_ref = _flat(g_ref)
    assert set(grads) == set(g_ref)
    for path, ts in grads.items():
        g = torch.stack(ts).reshape(groups[path].shape).numpy()
        scale = float(np.abs(g_ref[path]).max())
        np.testing.assert_allclose(g, g_ref[path], rtol=0,
                                   atol=GRAD_REL * scale + 1e-12,
                                   err_msg=path)


def test_moe_drops_pairs_under_grad():
    """Under grad the dispatch keeps its drops: tokens that all route to
    the same experts overflow their capacity, a token whose every pair
    was dropped gets an exact zero gradient (the trash row stays out of
    the graph), and the kept ones a finite, non-zero one."""
    _, tcfg = _cfgs("olmoe-1b-7b")
    from repro_torch.models import moe
    model = DecoderLM(tcfg, torch.Generator().manual_seed(0), device="cpu")
    blk = model.stages[-1].layers[0].moe
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(1, 1, tcfg.d_model, generator=gen)
         + 1e-3 * torch.randn(2, 16, tcfg.d_model, generator=gen))
    x.requires_grad_(True)
    y = moe._moe_local(x, blk.w_router, blk.w_in, blk.w_out, cfg=tcfg)
    y.sum().backward()
    _, eidx = moe.route(tcfg, blk.w_router, x.detach().reshape(32, -1))
    dp = moe.dispatch(tcfg, eidx)
    kept = torch.zeros(32 * tcfg.top_k, dtype=torch.bool)
    kept[dp.order] = dp.valid
    kept = kept.reshape(32, tcfg.top_k).any(-1)
    g = x.grad.reshape(32, -1)
    assert int((~kept).sum()) > 0
    assert not bool(g[~kept].any())
    assert bool(torch.isfinite(g).all()) and bool(g[kept].abs().sum(-1)
                                                 .gt(0).all())


def test_serving_leaves_weights_frozen():
    """Without a trainer the weights take no gradient."""
    _, tcfg = _cfgs("qwen2-1.5b")
    model = DecoderLM(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())


def test_synthetic_token_batches_match_reference():
    for vocab, b, s in ((512, 4, 16), (151936, 2, 64), (100, 3, 5)):
        got = list(synthetic_token_batches(vocab, b, s, steps=4, seed=7))
        want = list(ref_batches(vocab, b, s, steps=4, seed=7))
        assert len(got) == len(want) == 4
        for (t, y), (rt, ry) in zip(got, want):
            assert t.dtype == rt.dtype == np.int32
            np.testing.assert_array_equal(t, rt)
            np.testing.assert_array_equal(y, ry)
