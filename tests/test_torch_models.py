"""`repro_torch.models` / `serve.decode` / `configs` against `repro`'s.

The reference's own random parameters (`repro.models.params.tree_init`)
are carried across with `from_reference`; inputs are made with numpy
from seeds.  Parity with the reference at f32: hidden states and logits
within rtol 1e-4 / atol 1e-5, greedy tokens equal wherever the
reference's top-two logit gap exceeds that bound.  In bf16 (the
configs' own dtypes): `_sdpa` to f32 rounding, the model bit for bit
but for one-ulp flips against the reference evaluated op by op.  The
port against itself (decode vs forward, chunked vs full, GQA) at the
reference's own bars (tests/test_models.py: 5e-3 / 5e-4, 2e-3 / 2e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.attention as RA
import repro.models.layers as RL
from repro.launch.specs import model_decl as ref_model_decl
from repro.models import transformer as rtf
from repro.models.params import n_params as ref_n_params
from repro.models.params import tree_init as ref_tree_init
from repro.serve import decode as rdec
import repro_torch.configs as TC
import repro_torch.models.attention as TA
import repro_torch.models.layers as TL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import DecoderLM, encdec as tencdec
from repro_torch.models import transformer as ttf
from repro_torch.models.params import (ParamTree, from_reference, n_params,
                                       to_state, tree_init)
from repro_torch.serve import decode as tdec

RTOL, ATOL = 1e-4, 1e-5          # port vs reference, f32
DENSE = ("starcoder2-7b", "stablelm-12b", "qwen2-1.5b", "gemma-7b",
         "pixtral-12b")
PADDED = dict(name="padded", family="dense", n_layers=2, d_model=48,
              n_heads=6, n_kv_heads=2, d_ff=96, vocab=250, head_dim=8,
              qkv_bias=True, compute_dtype="float32",
              param_dtype="float32", attn_chunk=0, head_pad_quantum=4)


def _cfgs(case):
    """(reference config, port config) for a parity case: a dense
    arch's reduced config; "padded" (6 Q heads → 8 over 2 KV heads,
    vocab 250 → 256: the dead heads and the vocab mask); "chunked"
    (qwen2 reduced with KV blocks of 8: the online softmax in forward,
    cached prefill and decode)."""
    if case == "padded":
        from repro.configs.base import ModelConfig as RMC
        return RMC(**PADDED), ModelConfig(**PADDED)
    arch = "qwen2-1.5b" if case == "chunked" else case
    ref, port = RC.reduced(RC.get_config(arch)), \
        TC.reduced(TC.get_config(arch))
    if case == "chunked":
        ref, port = (dataclasses.replace(c, attn_chunk=8)
                     for c in (ref, port))
    return ref, port


CASES = DENSE + ("padded", "chunked")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(case, seed=0, dtype="float32"):
    """The reference's params and the port's model carrying them, in
    ``dtype`` (weights and activations: the config's two dtypes)."""
    rcfg, tcfg = (dataclasses.replace(c, param_dtype=dtype,
                                      compute_dtype=dtype)
                  for c in _cfgs(case))
    params = ref_tree_init(jax.random.PRNGKey(seed), rtf.decl(rcfg),
                           jnp.dtype(dtype))
    model = DecoderLM(tcfg, device="cpu")
    model.load_state_dict(from_reference(   # bf16 → f32 → bf16 is exact
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
        device="cpu", dtype=getattr(torch, dtype)))
    return rcfg, tcfg, params, model


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_patches:
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ------------------------------------------------------ configs ----------

@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_config_copies_match_reference(arch):
    ref, port = RC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(TC.reduced(port)) == \
        dataclasses.asdict(RC.reduced(ref))
    for prop in ("hd", "n_heads_padded", "vocab_padded", "is_moe",
                 "is_attn_free", "supports_long_context"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for rcell, tcell in zip(RC.SHAPES, TC.SHAPES):
        assert dataclasses.asdict(rcell) == dataclasses.asdict(tcell)
        assert TC.cell_applicable(port, tcell) == \
            RC.cell_applicable(ref, rcell)
    assert ttf.stage_plan(port) == rtf.stage_plan(ref)


@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_n_params_matches_reference(arch):
    cfg = TC.get_config(arch)
    port = (tencdec.decl(cfg) if cfg.family == "encdec" else ttf.decl(cfg))
    assert n_params(port) == ref_n_params(ref_model_decl(RC.get_config(arch)))


# ------------------------------------------------------ params -----------

def test_from_reference_keys_follow_reference_paths():
    rcfg, tcfg, params, model = _models("qwen2-1.5b")
    state = from_reference(_np_tree(params), device="cpu")
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(
        state["stages.0.layers.3.attn.wq"].numpy(),
        np.asarray(params["stages"][0]["attn"]["wq"][3]))
    np.testing.assert_array_equal(state["embed.table"].numpy(),
                                  np.asarray(params["embed"]["table"]))
    assert state["stages.0.layers.1.attn.bq"].shape == \
        (tcfg.n_heads_padded * tcfg.hd,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_init_follows_reference_rules(dtype):
    """The reference's init rules, distribution for distribution: zeros
    and ones exact; normal leaves N(0, 1/fan_in); the embed table N(0,
    scale²); keys and shapes those of the model."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("starcoder2-7b")),
                              d_model=128, d_ff=256,
                              param_dtype=str(dtype).split(".")[1])
    tree = tree_init(torch.Generator().manual_seed(0), ttf.decl(cfg),
                     dtype, device="cpu")
    state = to_state(tree)
    model = DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert all(v.dtype == dtype for v in model.state_dict().values())
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k      # same generator, same draws
    stage = tree["stages"][0]
    assert bool((stage["ln1"]["scale"] == 1).all())
    assert bool((stage["ln1"]["bias"] == 0).all())
    assert bool((stage["attn"]["bq"] == 0).all())
    w = stage["mlp"]["w_in"].float()                   # (L, d, 2f)
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.02
    assert abs(float(w.mean())) < 0.01 / np.sqrt(cfg.d_model)
    t = tree["embed"]["table"].float()
    assert abs(float(t.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.02
    # the same generator state gives the same tree
    again = tree_init(torch.Generator().manual_seed(0), ttf.decl(cfg),
                      dtype, device="cpu")
    assert torch.equal(again["embed"]["table"], tree["embed"]["table"])


# ------------------------------------------------------ layers -----------

def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    x = _rand((2, 5, 24), 0, 3.0)
    p = {"scale": _rand((24,), 1) + 1.0, "bias": _rand((24,), 2)}
    if kind == "rmsnorm":
        p.pop("bias")
    want = getattr(RL, kind)({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = getattr(TL, kind)({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("theta,pos2d", [(1e4, False), (1e6, True)])
def test_rope_matches_reference(theta, pos2d):
    x = _rand((2, 7, 3, 16), 3)
    pos = np.arange(7, dtype=np.int32) + 5
    if pos2d:
        pos = np.stack([pos, pos + 11])
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    _close(TL.rope_frequencies(16, theta), RL.rope_frequencies(16, theta),
           rtol=1e-6, atol=0)


@pytest.mark.parametrize("act,bias", [("swiglu", False), ("geglu", False),
                                      ("gelu", True), ("swiglu", True)])
def test_mlp_matches_reference(act, bias):
    cfg = ModelConfig(name="m", family="dense", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=2, d_ff=24, vocab=32, act=act,
                      mlp_bias=bias)
    rng = np.random.default_rng(4)
    p = {k: rng.normal(size=d.shape).astype(np.float32) * 0.3
         for k, d in TL.mlp_decl(cfg).items()}
    x = _rand((2, 3, 16), 5)
    want = RL.mlp(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x))
    mod = TL.MLP(cfg, dtype=torch.float32, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    _close(mod(torch.from_numpy(x)), want)


def test_embed_unembed_match_reference():
    table = _rand((40, 8), 6)
    tok = np.random.default_rng(7).integers(0, 40, (2, 5)).astype(np.int32)
    _close(TL.embed({"table": torch.from_numpy(table)},
                    torch.from_numpy(tok), torch.float32),
           RL.embed({"table": jnp.asarray(table)}, jnp.asarray(tok),
                    jnp.float32), rtol=0, atol=0)
    h = _rand((2, 5, 8), 8)
    _close(TL.unembed({"table": torch.from_numpy(table)},
                      torch.from_numpy(h)),
           RL.unembed({"table": jnp.asarray(table)}, jnp.asarray(h)))


# ---------------------------------------------------- attention ----------

SDPA_CASES = [(0, 6, 6, 0, True), (4, 6, 16, 10, True), (4, 16, 16, 0, True),
              (8, 5, 12, 0, False), (4, 1, 16, 9, True)]


@pytest.mark.parametrize("chunk,sq,sk,q_offset,causal", SDPA_CASES)
def test_sdpa_matches_reference(chunk, sq, sk, q_offset, causal):
    """Full and KV-chunked paths (chunk 8 over 12 keys: no chunk divides,
    so the full path), GQA rep 3, decode's single query."""
    q, k, v = _rand((2, sq, 6, 8), 9), _rand((2, sk, 2, 8), 10), \
        _rand((2, sk, 2, 8), 11)
    want = RA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, q_offset=jnp.int32(q_offset),
                    scale=8 ** -0.5, chunk=chunk)
    got = TA._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), causal=causal, q_offset=q_offset,
                   scale=8 ** -0.5, chunk=chunk)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("chunk,sq,sk,q_offset,causal", SDPA_CASES)
def test_sdpa_bf16_matches_reference(chunk, sq, sk, q_offset, causal):
    """bf16 q, k, v, as served: f32 scores and P·V from bf16 operands,
    the scale and q·scale rounded to bf16, P rounded to bf16 before P·V
    (the reference's casts).  Equal up to the f32 sums' order: atol 1e-6
    at outputs of ~2, where a score, scale, q·scale or P left in the
    wrong dtype moves them by ~1e-3."""
    q, k, v = _rand((2, sq, 6, 8), 9), _rand((2, sk, 2, 8), 10), \
        _rand((2, sk, 2, 8), 11)
    want = RA._sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    causal=causal, q_offset=jnp.int32(q_offset),
                    scale=8 ** -0.5, chunk=chunk)
    got = TA._sdpa(*(torch.from_numpy(a).to(torch.bfloat16)
                     for a in (q, k, v)),
                   causal=causal, q_offset=q_offset, scale=8 ** -0.5,
                   chunk=chunk)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, rtol=0, atol=1e-6)


def test_head_mask_matches_reference():
    for case in ("padded", "qwen2-1.5b"):
        for full in (False, True):
            rcfg, tcfg = _cfgs(case)
            if full:
                rcfg, tcfg = RC.get_config("qwen2-1.5b"), \
                    TC.get_config("qwen2-1.5b")
            want = RA.head_mask(rcfg, jnp.float32)
            got = TA.head_mask(tcfg, torch.float32)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TA.head_mask(TC.get_config("qwen2-1.5b"), torch.float32).sum() \
        == 12


def test_attention_layer_with_cache_matches_reference():
    rcfg, tcfg = _cfgs("padded")
    p = ref_tree_init(jax.random.PRNGKey(2), RA.attention_decl(rcfg))
    mod = TA.Attention(tcfg, dtype=torch.float32, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    x = _rand((2, 5, tcfg.d_model), 12)
    y_ref, _ = RA.attention(rcfg, p, jnp.asarray(x))
    y, none = mod(torch.from_numpy(x))
    assert none is None
    _close(y, y_ref)
    rc = RA.init_cache(rcfg, 2, 12, jnp.float32)
    tc = TA.init_cache(tcfg, 2, 12, torch.float32)
    y_ref, rc = RA.attention(rcfg, p, jnp.asarray(x), cache=rc)
    y, tc = mod(torch.from_numpy(x), cache=tc)
    _close(y, y_ref)
    assert tc.length == int(rc.length) == 5
    _close(tc.k, rc.k)
    _close(tc.v, rc.v)
    with pytest.raises(ValueError, match="cache"):
        mod(torch.from_numpy(_rand((2, 8, tcfg.d_model), 13)), cache=tc)


# ---------------------------------------------- the model vs reference ---

@pytest.mark.parametrize("case", CASES)
def test_forward_and_logits_match_reference(case):
    rcfg, tcfg, params, model = _models(case)
    batch = _batch(tcfg, 2, 12, seed=1)
    pe = batch.get("patch_embeds")
    h_ref = rtf.forward(rcfg, params, jnp.asarray(batch["tokens"]),
                        prefix_embeds=None if pe is None else jnp.asarray(pe))
    h = model(torch.from_numpy(batch["tokens"]),
              prefix_embeds=None if pe is None else torch.from_numpy(pe))
    assert h.shape == h_ref.shape
    _close(h, h_ref)
    lg_ref = rtf.logits_fn(rcfg, params, h_ref)
    lg = ttf.logits_fn(tcfg, model, h)
    assert lg.shape == lg_ref.shape == (2, h.shape[1], tcfg.vocab_padded)
    _close(lg, lg_ref)
    if tcfg.vocab_padded != tcfg.vocab:
        assert bool((lg[..., tcfg.vocab:] == -1e30).all())


def _top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0], np.abs(top[..., 1])


@pytest.mark.parametrize("case", CASES)
def test_greedy_generate_matches_reference(case):
    """8 greedy tokens; a row may part from the reference only at a step
    whose top-two logit gap (the reference's forward over its own
    tokens) is within the parity bound, and is not compared after."""
    rcfg, tcfg, params, model = _models(case, seed=1)
    batch = _batch(tcfg, 3, 10, seed=2)
    want = np.asarray(rdec.greedy_generate(
        rcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
        max_new=8, max_len=32))
    got = tdec.greedy_generate(tcfg, model, batch, max_new=8, max_len=32,
                               device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    got = got.numpy()
    seq = np.concatenate([batch["tokens"], want[:, :-1]], axis=1)
    pe = batch.get("patch_embeds")
    h = rtf.forward(rcfg, params, jnp.asarray(seq),
                    prefix_embeds=None if pe is None else jnp.asarray(pe))
    gap, top = _top2_gap(rtf.logits_fn(rcfg, params, h)[:, -8:])
    for r in range(3):
        for t in range(8):
            if got[r, t] != want[r, t]:
                assert gap[r, t] <= 2 * (ATOL + RTOL * top[r, t]), \
                    (case, r, t, gap[r, t])
                break


@pytest.mark.parametrize("case", ["qwen2-1.5b", "padded", "chunked"])
def test_prefill_and_step_match_reference(case):
    rcfg, tcfg, params, model = _models(case, seed=2)
    batch = _batch(tcfg, 2, 9, seed=3)
    lg_ref, rc = rdec.make_prefill(rcfg, 24)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lg, tc = tdec.make_prefill(tcfg, 24)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(lg, lg_ref)
    assert ttf.caches_length(tc) == int(rtf.caches_length(rc)) == 9
    _close(tc[0].k, rc[0].k)
    tok = np.asarray(jnp.argmax(lg_ref, -1)).astype(np.int32)
    nxt_ref, rc = rdec.make_serve_step(rcfg)(params, rc, jnp.asarray(tok))
    nxt, tc = tdec.make_serve_step(tcfg)(model, tc, torch.from_numpy(tok))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref))
    _close(tc[0].v, rc[0].v)
    assert ttf.caches_length(tc) == 10


# ------------------------------------------- bf16, the served dtypes ---

def _bf16_close(got, want, min_equal, atol_rel):
    """bf16 results: at least ``min_equal`` of the elements bit-equal and
    none more than ``atol_rel`` of the largest |want| apart."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    live = want > -1e29                          # not the vocab-pad mask
    equal = float(np.mean(got[live] == want[live]))
    assert equal >= min_equal, equal
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol_rel * np.abs(want[live]).max())


@pytest.mark.parametrize("case", CASES)
def test_forward_bf16_matches_reference(case):
    """bf16 weights and activations (the configs' own dtypes).  Against
    the reference evaluated op by op (``jax.disable_jit``): the port
    rounds where each of its operations does, so hidden states and
    logits are bit-equal but for one-ulp flips where an f32 sum's order
    or a sin/cos differs — at least 95 % of the elements equal, none
    more than 2⁻⁶ of the largest apart.  Against the compiled
    reference, whose XLA fusions leave some of those roundings out: none
    more than 2⁻⁴ of the largest apart."""
    rcfg, tcfg, params, model = _models(case, dtype="bfloat16")
    batch = _batch(tcfg, 2, 12, seed=1)
    tok = batch["tokens"]
    pe = batch.get("patch_embeds")
    with torch.inference_mode():
        h = model(torch.from_numpy(tok),
                  prefix_embeds=None if pe is None else torch.from_numpy(pe))
        lg = ttf.logits_fn(tcfg, model, h)
    assert h.dtype == lg.dtype == torch.bfloat16
    ref_pe = None if pe is None else jnp.asarray(pe)
    with jax.disable_jit():
        h_op = rtf.forward(rcfg, params, jnp.asarray(tok),
                           prefix_embeds=ref_pe)
        lg_op = rtf.logits_fn(rcfg, params, h_op)
    _bf16_close(h, h_op, 0.95, 2.0 ** -6)
    _bf16_close(lg, lg_op, 0.95, 2.0 ** -6)
    h_jit = rtf.forward(rcfg, params, jnp.asarray(tok), prefix_embeds=ref_pe)
    _bf16_close(h, h_jit, 0.0, 2.0 ** -4)


@pytest.mark.parametrize("case", ["qwen2-1.5b", "padded", "chunked"])
def test_prefill_and_step_bf16_match_reference(case):
    """A bf16 cache: cached prefill and one decode step against the
    reference op by op, at `test_forward_bf16_matches_reference`'s
    bars; the step's token equal where the top-two gap is wider than
    that bar."""
    rcfg, tcfg, params, model = _models(case, seed=2, dtype="bfloat16")
    batch = _batch(tcfg, 2, 9, seed=3)
    with jax.disable_jit():
        lg_ref, rc = rdec.make_prefill(rcfg, 24)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        tok = np.asarray(jnp.argmax(lg_ref, -1)).astype(np.int32)
        nxt_ref, rc = rdec.make_serve_step(rcfg)(params, rc,
                                                 jnp.asarray(tok))
        h = rtf.forward(rcfg, params, jnp.asarray(
            np.concatenate([batch["tokens"], tok], 1)))[:, -1:]
        gap, top = _top2_gap(rtf.logits_fn(rcfg, params, h)[..., :tcfg.vocab])
    with torch.inference_mode():
        lg, tc = tdec.make_prefill(tcfg, 24)(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
        nxt, tc = tdec.make_serve_step(tcfg)(model, tc,
                                             torch.from_numpy(tok))
    assert tc[0].k.dtype == torch.bfloat16
    _bf16_close(lg, lg_ref, 0.95, 2.0 ** -6)
    _bf16_close(tc[0].k, rc[0].k, 0.95, 2.0 ** -6)
    _bf16_close(tc[0].v, rc[0].v, 0.95, 2.0 ** -6)
    wide = gap > 2 * 2.0 ** -6 * top
    np.testing.assert_array_equal(nxt.numpy()[wide], np.asarray(nxt_ref)[wide])


# ------------------------------------- the port against itself -----------

def _tiny(**kw):
    base = dict(name="tiny", family="dense", n_layers=3, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                compute_dtype="float32", param_dtype="float32", attn_chunk=0,
                qkv_bias=True)
    base.update(kw)
    return ModelConfig(**base)


@pytest.mark.parametrize("cfg", [_tiny(), _tiny(attn_chunk=8),
                                 ModelConfig(**PADDED)],
                         ids=["dense", "chunked", "padded"])
def test_decode_matches_forward(cfg):
    """tests/test_models.py:31's case (cached prefill of 8, then one token
    at a time) on the port."""
    model = DecoderLM(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
    with torch.inference_mode():
        h = model(tokens)
        caches = ttf.init_caches(cfg, 2, 32, torch.float32, device="cpu")
        h_pre, caches = model(tokens[:, :8], caches=caches)
        outs = [h_pre[:, -1]]
        for t in range(8, 16):
            h_t, caches = model(tokens[:, t:t + 1], caches=caches)
            outs.append(h_t[:, 0])
    _close(torch.stack(outs, 1), h[:, 7:16].numpy(), rtol=5e-3, atol=5e-4)


def test_chunked_attention_matches_full():
    model = DecoderLM(_tiny(), torch.Generator().manual_seed(1),
                      device="cpu")
    chunked = DecoderLM(_tiny(attn_chunk=8), device="cpu")
    chunked.load_state_dict(model.state_dict())
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 32)))
    _close(chunked(tokens), model(tokens).numpy(), rtol=2e-3, atol=2e-4)


def test_gqa_repetition_consistency():
    """n_kv_heads=n_heads (MHA) equals GQA with repeated KV weights."""
    cfg_g, cfg_m = _tiny(qkv_bias=False), _tiny(n_kv_heads=4,
                                                qkv_bias=False)
    g = DecoderLM(cfg_g, torch.Generator().manual_seed(3), device="cpu")
    state = dict(g.state_dict())
    for k, w in list(state.items()):
        if k.endswith(("attn.wk", "attn.wv")):
            d = w.shape[0]
            state[k] = torch.repeat_interleave(
                w.reshape(d, 2, 16), 2, dim=1).reshape(d, 64)
    m = DecoderLM(cfg_m, device="cpu")
    m.load_state_dict(state)
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 12)))
    _close(m(tokens), g(tokens).numpy(), rtol=2e-3, atol=2e-4)


# --------------------------------------------- not ported: raises 3b -----

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-2.7b", "zamba2-7b",
                                  "whisper-medium"])
def test_other_families_raise_naming_3b(arch):
    cfg = TC.reduced(TC.get_config(arch))
    for call in (lambda: DecoderLM(cfg, device="cpu"),
                 lambda: ttf.init_caches(cfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="item 3b"):
            call()
    if cfg.family == "encdec":
        for make in (lambda: tdec.make_prefill(cfg, 8),
                     lambda: tdec.make_serve_step(cfg)):
            with pytest.raises(NotImplementedError, match="item 3b"):
                make()
    learned = dataclasses.replace(TC.reduced(TC.get_config("qwen2-1.5b")),
                                  pos="learned")
    with pytest.raises(NotImplementedError, match="item 3b"):
        DecoderLM(learned, device="cpu")


def test_param_tree_reads_like_a_dict():
    rcfg, tcfg, params, model = _models("starcoder2-7b")
    block = model.stages[0].layers[0]
    assert isinstance(block.attn, ParamTree)
    assert "bq" in block.attn and "b_in" in block.mlp
    assert "lm_head" in model and "w" in model["lm_head"]
    assert block.attn["wq"] is block.attn.wq
