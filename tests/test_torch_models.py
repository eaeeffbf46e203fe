"""`repro_torch.models` / `serve.decode` / `configs` against `repro`'s:
the decoder families (dense, MoE, SSM, hybrid; the encoder–decoder is
tests/test_torch_encdec.py's).

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
# the other decoder families' reduced configs, and a dense one with
# learned positions (clamped at max_target_positions − 1)
FAMILIES = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "mamba2-2.7b", "zamba2-7b")
PADDED = dict(name="padded", family="dense", n_layers=2, d_model=48,
              n_heads=6, n_kv_heads=2, d_ff=96, vocab=250, head_dim=8,
              qkv_bias=True, compute_dtype="float32",
              param_dtype="float32", attn_chunk=0, head_pad_quantum=4)


def _cfgs(case):
    """(reference config, port config) for a parity case: a dense
    arch's reduced config; "padded" (6 Q heads → 8 over 2 KV heads,
    vocab 250 → 256: the dead heads and the vocab mask); "chunked"
    (qwen2 reduced with KV blocks of 8: the online softmax in forward,
    cached prefill and decode); "learned" (qwen2 reduced with learned
    positions in a 16-row table, so 24 positions clamp)."""
    if case == "padded":
        from repro.configs.base import ModelConfig as RMC
        return RMC(**PADDED), ModelConfig(**PADDED)
    arch = "qwen2-1.5b" if case in ("chunked", "learned") else case
    ref, port = RC.reduced(RC.get_config(arch)), \
        TC.reduced(TC.get_config(arch))
    if case == "chunked":
        ref, port = (dataclasses.replace(c, attn_chunk=8)
                     for c in (ref, port))
    if case == "learned":
        ref, port = (dataclasses.replace(c, pos="learned",
                                         max_target_positions=16)
                     for c in (ref, port))
    return ref, port


CASES = DENSE + ("padded", "chunked") + FAMILIES + ("learned",)


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


def _prompt(cfg, s):
    """A prompt length near ``s`` that the reference's SSD takes: past
    one chunk, whole chunks only (src/repro/models/mamba.py:84)."""
    if cfg.family in ("ssm", "hybrid") and s > cfg.ssm_chunk:
        return s - s % cfg.ssm_chunk
    return s


def _cache_tensors(caches):
    """The port's cache tensors in the reference's leaf order (dicts by
    sorted key; a `KVCache`'s k, v; a `MambaCache`'s conv, ssm)."""
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in _cache_tensors(caches[k])]
    if isinstance(caches, TA.KVCache):
        return [caches.k, caches.v]
    if isinstance(caches, tuple):           # MambaCache
        return list(caches)
    return [t for c in caches for t in _cache_tensors(c)]


def _ref_cache_arrays(caches):
    """The reference's cache arrays, lengths left out."""
    return [a for a in jax.tree_util.tree_leaves(caches) if a.ndim > 1]


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
    batch = _batch(tcfg, 3, _prompt(tcfg, 10), seed=2)
    want = np.asarray(rdec.greedy_generate(
        rcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
        max_new=8, max_len=32))
    got = tdec.greedy_generate(tcfg, model, batch, max_new=8, max_len=32,
                               device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    got = got.numpy()
    seq = np.concatenate([batch["tokens"], want[:, :-1]], axis=1)
    # the reference's SSD takes whole chunks: pad the (causal) forward
    pad = _prompt(tcfg, seq.shape[1] + tcfg.ssm_chunk) - seq.shape[1] \
        if tcfg.family in ("ssm", "hybrid") else 0
    seq = np.pad(seq, ((0, 0), (0, pad)))
    pe = batch.get("patch_embeds")
    h = rtf.forward(rcfg, params, jnp.asarray(seq),
                    prefix_embeds=None if pe is None else jnp.asarray(pe))
    gap, top = _top2_gap(
        rtf.logits_fn(rcfg, params, h)[:, h.shape[1] - pad - 8:
                                       h.shape[1] - pad])
    for r in range(3):
        for t in range(8):
            if got[r, t] != want[r, t]:
                assert gap[r, t] <= 2 * (ATOL + RTOL * top[r, t]), \
                    (case, r, t, gap[r, t])
                break


@pytest.mark.parametrize("case", ["qwen2-1.5b", "padded", "chunked",
                                  "learned"] + list(FAMILIES))
def test_prefill_and_step_match_reference(case):
    """Cached prefill and one decode step: logits, the next token, the
    fill length (a hybrid's from its first period's KV cache; an SSM's
    0, it has none) and every cache tensor — KV, conv and SSM states."""
    rcfg, tcfg, params, model = _models(case, seed=2)
    s = _prompt(tcfg, 9)
    batch = _batch(tcfg, 2, s, seed=3)
    lg_ref, rc = rdec.make_prefill(rcfg, 24)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lg, tc = tdec.make_prefill(tcfg, 24)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(lg, lg_ref)
    filled = 0 if tcfg.family == "ssm" else s
    assert ttf.caches_length(tc) == int(rtf.caches_length(rc)) == filled
    got, want = _cache_tensors(tc), _ref_cache_arrays(rc)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    for t, a in zip(got, want):
        _close(t, a)
    tok = np.asarray(jnp.argmax(lg_ref, -1)).astype(np.int32)
    nxt_ref, rc = rdec.make_serve_step(rcfg)(params, rc, jnp.asarray(tok))
    nxt, tc = tdec.make_serve_step(tcfg)(model, tc, torch.from_numpy(tok))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref))
    for t, a in zip(_cache_tensors(tc), _ref_cache_arrays(rc)):
        _close(t, a)
    assert ttf.caches_length(tc) == (0 if tcfg.family == "ssm" else s + 1)


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
    more than 2⁻⁴ of the largest apart.

    The other families' bars, op by op: at least half bit-equal, none
    more than 2⁻⁵ of the largest apart.  The SSD's f32 products and an
    expert's f32 sums run in another order than XLA's, so single bf16
    outputs flip by one ulp, and the reduced models (random weights,
    width 64) carry a flip on: at seeds 0–2, down to 63 % bit-equal and
    1.6 % of the largest apart (zamba2), 84 % and 1.1 % (kimi).  The
    compiled reference's fused roundings also move near-tied routing
    choices (up to 5 of 24 tokens at seeds 0–3), each by a whole
    expert's share, so the MoE families are held op by op only
    (tests/test_torch_moe.py holds the routing itself)."""
    rcfg, tcfg, params, model = _models(case, dtype="bfloat16")
    dense = case not in FAMILIES
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
    min_equal, rel = (0.95, 2.0 ** -6) if dense else (0.5, 2.0 ** -5)
    _bf16_close(h, h_op, min_equal, rel)
    _bf16_close(lg, lg_op, min_equal, rel)
    if not tcfg.is_moe:
        h_jit = rtf.forward(rcfg, params, jnp.asarray(tok),
                            prefix_embeds=ref_pe)
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


TINY_FAMS = {   # tests/test_models.py:12-18
    "moe": dict(family="moe", n_experts=8, top_k=2, capacity_factor=8.0,
                qkv_bias=False),
    "ssm": dict(family="ssm", d_ff=0, ssm_state=16, ssm_head_dim=16,
                ssm_chunk=4, qkv_bias=False),
    "hybrid": dict(family="hybrid", ssm_state=16, ssm_head_dim=16,
                   ssm_chunk=4, attn_period=2, n_layers=7, qkv_bias=False),
}


@pytest.mark.parametrize("cfg", [_tiny(), _tiny(attn_chunk=8),
                                 ModelConfig(**PADDED)]
                         + [_tiny(**kw) for kw in TINY_FAMS.values()],
                         ids=["dense", "chunked", "padded"] + list(TINY_FAMS))
def test_decode_matches_forward(cfg):
    """tests/test_models.py:31's case (cached prefill of 8, then one token
    at a time) on the port, for every decoder family."""
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


# ------------------------------------------------- caches and params ---

@pytest.mark.parametrize("arch", ["qwen2-1.5b"] + list(FAMILIES))
def test_init_caches_match_reference(arch):
    """Every stage's cache in the reference's layout: shapes and dtypes
    (KV and conv in the given dtype, the SSM state f32), zeros, length 0."""
    rcfg, tcfg = RC.reduced(RC.get_config(arch)), \
        TC.reduced(TC.get_config(arch))
    got = ttf.init_caches(tcfg, 3, 16, torch.bfloat16, device="cpu")
    want = rtf.init_caches(rcfg, 3, 16, jnp.bfloat16)
    ts, rs = _cache_tensors(got), _ref_cache_arrays(want)
    assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in ts] == \
        [(a.shape, str(a.dtype)) for a in rs]
    assert all(not bool(t.any()) for t in ts)
    assert ttf.caches_length(got) == int(rtf.caches_length(want)) == 0


def test_caches_length_finds_a_nested_kv_cache():
    """A hybrid's caches hold their KV cache inside each period's dict
    ({"attn", "mambas"}, sorted), as the reference's ``tree_leaves``
    finds it; an SSM's hold none."""
    kv = TA.KVCache(torch.zeros(1), torch.zeros(1), 7)
    mb = (torch.zeros(1), torch.zeros(1))
    assert ttf.caches_length([{"mambas": mb, "attn": kv}, mb]) == 7
    assert ttf.caches_length([mb, [{"x": mb}, {"y": kv}]]) == 7
    assert ttf.caches_length([mb]) == 0 and ttf.caches_length([]) == 0


@pytest.mark.parametrize("arch", list(FAMILIES) + ["learned"])
def test_from_reference_keys_per_family(arch):
    """The reference's tree of each family loads into the port's module
    key for key: stacked MoE and mamba stages, the period stage's doubly
    stacked mambas ((n_periods, attn_period, …) → ``stages.0.layers.<p>.
    mambas.<j>``), ``shared_attn`` once, learned ``pos_embed``."""
    rcfg, tcfg, params, model = _models(arch)
    state = from_reference(_np_tree(params), device="cpu")
    assert set(state) == set(model.state_dict())
    assert sum(v.numel() for v in state.values()) == \
        ref_n_params(rtf.decl(rcfg))
    if tcfg.family == "hybrid":
        np.testing.assert_array_equal(
            state["stages.0.layers.1.mambas.0.mamba.wz"].numpy(),
            np.asarray(params["stages"][0]["mambas"]["mamba"]["wz"][1, 0]))
        np.testing.assert_array_equal(
            state["stages.1.layers.0.ln1.scale"].numpy(),
            np.asarray(params["stages"][1]["ln1"]["scale"][0]))
        assert "shared_attn.attn.wq" in state
        assert not any(".attn." in k for k in state
                       if k.startswith("stages."))
    elif tcfg.is_moe:
        last = len(params["stages"]) - 1
        np.testing.assert_array_equal(
            state[f"stages.{last}.layers.1.moe.w_in"].numpy(),
            np.asarray(params["stages"][last]["moe"]["w_in"][1]))
    elif tcfg.pos == "learned":
        np.testing.assert_array_equal(state["pos_embed.table"].numpy(),
                                      np.asarray(params["pos_embed"]["table"]))


def test_hybrid_shares_one_attention_block():
    """zamba2's shared attention: one parameter set, applied at every
    period (each with its own KV cache).  Changing it changes the
    output; the periods' own modules hold no attention."""
    rcfg, tcfg, params, model = _models("zamba2-7b")
    stage = model.stages[0]
    assert len(stage.layers) == 2 and all(
        len(p.mambas) == tcfg.attn_period for p in stage.layers)
    calls = []
    hook = model.shared_attn.register_forward_hook(
        lambda mod, args, out: calls.append(mod.attn.wq.data_ptr()))
    tok = torch.from_numpy(_batch(tcfg, 1, 8, 0)["tokens"])
    with torch.inference_mode():
        h = model(tok)
        caches = ttf.init_caches(tcfg, 1, 16, torch.float32, device="cpu")
        model(tok, caches=caches)
    hook.remove()
    assert calls == [model.shared_attn.attn.wq.data_ptr()] * 4
    assert caches[0]["attn"].k.shape[0] == 2      # a KV cache a period
    assert bool(caches[0]["attn"].k[1].any())
    with torch.no_grad():
        model.shared_attn.attn.wo.mul_(2)
    with torch.inference_mode():
        assert not torch.allclose(model(tok), h)


def test_vocab_padding_masked():
    """tests/test_padding_profiles.py:76's reduced mamba2 case: vocab 500
    pads to 512, whose columns hold −1e30 and take no probability; the
    logits match the reference's."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("mamba2-2.7b")),
                              vocab=500)
    rcfg = dataclasses.replace(RC.reduced(RC.get_config("mamba2-2.7b")),
                               vocab=500)
    assert cfg.vocab_padded == 512
    params = ref_tree_init(jax.random.PRNGKey(0), rtf.decl(rcfg))
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(from_reference(_np_tree(params), device="cpu"))
    tok = np.random.default_rng(1).integers(0, 500, (2, 8)).astype(np.int32)
    with torch.inference_mode():
        logits = ttf.logits_fn(cfg, model, model(torch.from_numpy(tok)))
    assert logits.shape[-1] == 512
    assert bool((logits[..., 500:] == -1e30).all())
    assert float(torch.softmax(logits, -1)[..., 500:].max()) == 0.0
    _close(logits[..., :500], rtf.logits_fn(rcfg, params, rtf.forward(
        rcfg, params, jnp.asarray(tok)))[..., :500])


def test_param_tree_reads_like_a_dict():
    rcfg, tcfg, params, model = _models("starcoder2-7b")
    block = model.stages[0].layers[0]
    assert isinstance(block.attn, ParamTree)
    assert "bq" in block.attn and "b_in" in block.mlp
    assert "lm_head" in model and "w" in model["lm_head"]
    assert block.attn["wq"] is block.attn.wq
