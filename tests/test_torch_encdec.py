"""`repro_torch.models.encdec` (and attention's cross-attention) against
`repro.models.encdec` on the CPU.

Reduced whisper with the reference's own parameters carried across by
`from_reference`; frames and tokens made with numpy from seeds.  f32
within rtol 1e-4 / atol 1e-5; the port's decode against its own forward
at tests/test_models.py's 5e-3 / 5e-4; bf16 against the reference
evaluated op by op at tests/test_torch_models.py's bars."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.attention as RA
from repro.models import encdec as renc
from repro.models.params import tree_init as ref_tree_init
from repro.serve import decode as rdec
import repro_torch.configs as TC
import repro_torch.models.attention as TA
from repro_torch.configs.base import ModelConfig
from repro_torch.models import EncDecLM, encdec as tenc
from repro_torch.models.params import from_reference
from repro_torch.serve import decode as tdec

RTOL, ATOL = 1e-4, 1e-5


def _cfgs(**kw):
    return (dataclasses.replace(RC.reduced(RC.get_config("whisper-medium")),
                                **kw),
            dataclasses.replace(TC.reduced(TC.get_config("whisper-medium")),
                                **kw))


def _models(seed=0, dtype="float32", **kw):
    rcfg, tcfg = _cfgs(param_dtype=dtype, compute_dtype=dtype, **kw)
    params = ref_tree_init(jax.random.PRNGKey(seed), renc.decl(rcfg),
                           jnp.dtype(dtype))
    model = EncDecLM(tcfg, device="cpu")
    model.load_state_dict(from_reference(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
        device="cpu", dtype=getattr(torch, dtype)))
    return rcfg, tcfg, params, model


def _data(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# ------------------------------------------------- cross-attention -------

def _attn(heads, kv, chunk, bias, seed):
    kw = dict(name="x", family="encdec", n_layers=1, d_model=32,
              n_heads=heads, n_kv_heads=kv, d_ff=64, vocab=64, head_dim=8,
              qkv_bias=bias, pos="learned", attn_chunk=chunk,
              compute_dtype="float32", param_dtype="float32")
    from repro.configs.base import ModelConfig as RMC
    rcfg, tcfg = RMC(**kw), ModelConfig(**kw)
    p = ref_tree_init(jax.random.PRNGKey(seed), RA.attention_decl(rcfg))
    if bias:
        rng = np.random.default_rng(seed)
        p = {k: (jnp.asarray(rng.normal(size=v.shape), jnp.float32)
                 if k.startswith("b") else v) for k, v in p.items()}
    mod = TA.Attention(tcfg, dtype=torch.float32, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    return rcfg, tcfg, p, mod


@pytest.mark.parametrize("heads,kv,chunk,se,bias", [
    (4, 4, 0, 12, False), (4, 2, 0, 12, True), (4, 4, 8, 24, False),
    (4, 4, 8, 20, True)])
def test_cross_attention_matches_reference(heads, kv, chunk, se, bias):
    """``kv_input=``: K/V from the encoder sequence without bias, no RoPE,
    no mask; KV blocks when ``chunk`` divides S_enc (24 by 8), the full
    softmax when not (20 by 8, as Whisper's 1500 by 1024)."""
    rcfg, tcfg, p, mod = _attn(heads, kv, chunk, bias, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    enc = rng.normal(size=(2, se, 32)).astype(np.float32)
    y, none = mod(torch.from_numpy(x), causal=False,
                  kv_input=torch.from_numpy(enc))
    ry, _ = RA.attention(rcfg, p, jnp.asarray(x), causal=False,
                         kv_input=jnp.asarray(enc))
    assert none is None
    _close(y, ry)


@pytest.mark.parametrize("chunk,se", [(0, 12), (8, 24), (8, 20)])
def test_attention_with_kv_matches_reference(chunk, se):
    rcfg, tcfg, p, mod = _attn(4, 2, chunk, True, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    k = rng.normal(size=(2, se, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, se, 2, 8)).astype(np.float32)
    got = TA.attention_with_kv(tcfg, mod, torch.from_numpy(x),
                               torch.from_numpy(k), torch.from_numpy(v))
    want = RA.attention_with_kv(rcfg, p, jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(v))
    _close(got, want)


def test_whisper_frames_take_the_full_softmax():
    """1500 encoder positions are not a multiple of ``attn_chunk`` = 1024:
    the encoder's self-attention takes the full-softmax branch in both
    packages (reduced widths, Whisper's frame count and chunk)."""
    rcfg, tcfg, params, model = _models(seed=5, n_frames=1500,
                                        attn_chunk=1024, n_enc_layers=1)
    frames, _ = _data(tcfg, 1, 1, 6)
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(frames))
    _close(got, renc.encode(rcfg, params, jnp.asarray(frames)))


# ------------------------------------------------------- the model -------

def test_from_reference_keys_follow_reference_paths():
    rcfg, tcfg, params, model = _models()
    state = from_reference(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(
        state["dec_blocks.1.cross_attn.wk"].numpy(),
        np.asarray(params["dec_blocks"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(
        state["enc_blocks.0.mlp.w_in"].numpy(),
        np.asarray(params["enc_blocks"]["mlp"]["w_in"][0]))
    assert state["dec_pos.table"].shape == (tcfg.max_target_positions,
                                            tcfg.d_model)
    assert state["enc_pos.table"].shape == (tcfg.n_frames, tcfg.d_model)
    assert "lm_head.w" not in state          # tied


def test_encode_and_decode_match_reference():
    rcfg, tcfg, params, model = _models(seed=1)
    frames, tok = _data(tcfg, 2, 10, 2)
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(frames))
        h = model(torch.from_numpy(tok), enc)
        lg = tenc.logits_fn(tcfg, model, h)
    r_enc = renc.encode(rcfg, params, jnp.asarray(frames))
    r_h = renc.decode(rcfg, params, jnp.asarray(tok), r_enc)
    _close(enc, r_enc)
    _close(h, r_h)
    r_lg = renc.logits_fn(rcfg, params, r_h)
    assert lg.shape == r_lg.shape == (2, 10, tcfg.vocab_padded)
    _close(lg, r_lg)


def test_learned_positions_clamp_at_the_table():
    """Decoder positions past ``max_target_positions − 1`` take its last
    row, in both packages (a 6-row table, 9 tokens)."""
    rcfg, tcfg, params, model = _models(seed=2, max_target_positions=6)
    frames, tok = _data(tcfg, 1, 9, 3)
    with torch.inference_mode():
        h = model(torch.from_numpy(tok), model.encode(
            torch.from_numpy(frames)))
    r_h = renc.decode(rcfg, params, jnp.asarray(tok),
                      renc.encode(rcfg, params, jnp.asarray(frames)))
    _close(h, r_h)


def test_init_dec_caches_match_reference():
    rcfg, tcfg, params, model = _models(seed=3)
    frames, _ = _data(tcfg, 2, 1, 4)
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(frames))
        c = tenc.init_dec_caches(tcfg, model, enc, 2, 24, torch.float32)
    rc = renc.init_dec_caches(rcfg, params, renc.encode(
        rcfg, params, jnp.asarray(frames)), 2, 24, jnp.float32)
    assert c.self_kv.length == int(rc.self_kv.length[0]) == 0
    assert c.self_kv.k.shape == rc.self_kv.k.shape
    _close(c.cross_k, rc.cross_k)
    _close(c.cross_v, rc.cross_v)


def test_decode_matches_forward():
    """tests/test_models.py:107's case on the port: cached prefill of 8,
    then one token at a time, against one decoder forward over 16."""
    cfg = ModelConfig(name="t", family="encdec", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                      act="gelu", norm="layernorm", pos="learned",
                      n_enc_layers=2, n_frames=12, tie_embeddings=True,
                      compute_dtype="float32", param_dtype="float32",
                      attn_chunk=0, max_target_positions=64)
    model = EncDecLM(cfg, torch.Generator().manual_seed(5), device="cpu")
    frames, tok = _data(cfg, 2, 16, 5)
    frames, tok = torch.from_numpy(frames), torch.from_numpy(tok)
    with torch.inference_mode():
        enc = model.encode(frames)
        h = model(tok, enc)
        caches = tenc.init_dec_caches(cfg, model, enc, 2, 32, torch.float32)
        h_pre, caches = model(tok[:, :8], caches=caches)
        outs = [h_pre[:, -1]]
        for t in range(8, 16):
            h_t, caches = model(tok[:, t:t + 1], caches=caches)
            outs.append(h_t[:, 0])
    assert caches.self_kv.length == 16
    _close(torch.stack(outs, 1), h[:, 7:16].numpy(), 5e-3, 5e-4)


def test_prefill_and_step_match_reference():
    rcfg, tcfg, params, model = _models(seed=4)
    frames, tok = _data(tcfg, 2, 5, 6)
    batch = {"tokens": tok, "frames": frames}
    lg_ref, rc = rdec.make_prefill(rcfg, 24)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lg, tc = tdec.make_prefill(tcfg, 24)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(lg, lg_ref)
    assert tc.self_kv.length == int(rc.self_kv.length[0]) == 5
    _close(tc.self_kv.k, rc.self_kv.k)
    _close(tc.cross_v, rc.cross_v)
    nxt_tok = np.asarray(jnp.argmax(lg_ref, -1)).astype(np.int32)
    nxt_ref, rc = rdec.make_serve_step(rcfg)(params, rc,
                                             jnp.asarray(nxt_tok))
    nxt, tc = tdec.make_serve_step(tcfg)(model, tc,
                                         torch.from_numpy(nxt_tok))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref))
    _close(tc.self_kv.v, rc.self_kv.v)
    assert tc.self_kv.length == 6


def test_encdec_bf16_matches_reference():
    """bf16 weights and activations: encoder states and decoder logits
    against the reference op by op (``jax.disable_jit``), none more than
    2⁻⁶ of the largest apart.  The encoder states at least 95 %
    bit-equal; the logits at least 85 %: cross-attention's f32 P·V sums
    over the frames run in another order than XLA's (f32 ulps, within
    test_torch_models.py's 1e-6 on `_sdpa`), which flips about 1 % of
    its bf16 outputs by one ulp, and the decoder carries the flips on."""
    rcfg, tcfg, params, model = _models(seed=6, dtype="bfloat16")
    frames, tok = _data(tcfg, 2, 6, 7)
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(frames))
        lg = tenc.logits_fn(tcfg, model, model(torch.from_numpy(tok), enc))
    with jax.disable_jit():
        r_enc = renc.encode(rcfg, params, jnp.asarray(frames))
        r_lg = renc.logits_fn(rcfg, params, renc.decode(
            rcfg, params, jnp.asarray(tok), r_enc))
    for got, want, min_equal in ((enc, r_enc, 0.95), (lg, r_lg, 0.85)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        live = want > -1e29
        assert float(np.mean(got[live] == want[live])) >= min_equal
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6
                                   * np.abs(want[live]).max())


def test_model_classes_refuse_the_other_families():
    from repro_torch.models import DecoderLM
    with pytest.raises(ValueError, match="EncDecLM"):
        DecoderLM(TC.reduced(TC.get_config("whisper-medium")), device="cpu")
    with pytest.raises(ValueError, match="DecoderLM"):
        EncDecLM(TC.reduced(TC.get_config("olmoe-1b-7b")), device="cpu")


def test_greedy_generate_matches_reference():
    """8 greedy tokens of reduced whisper from 3 streams of frames and
    their prompts; a row may part from the reference only at a step whose
    top-two logit gap (the reference's decoder forward over its own
    tokens) is within the parity bound, and is not compared after."""
    rcfg, tcfg, params, model = _models(seed=8)
    frames, tok = _data(tcfg, 3, 4, 9)
    batch = {"tokens": tok, "frames": frames}
    want = np.asarray(rdec.greedy_generate(
        rcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
        max_new=8, max_len=32))
    got = tdec.greedy_generate(tcfg, model, batch, max_new=8, max_len=32,
                               device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    got = got.numpy()
    seq = np.concatenate([tok, want[:, :-1]], axis=1)
    enc = renc.encode(rcfg, params, jnp.asarray(frames))
    logits = np.asarray(renc.logits_fn(rcfg, params, renc.decode(
        rcfg, params, jnp.asarray(seq), enc))[:, -8:], np.float64)
    top = np.sort(logits, axis=-1)[..., -2:]
    gap = top[..., 1] - top[..., 0]
    for r in range(3):
        for t in range(8):
            if got[r, t] != want[r, t]:
                assert gap[r, t] <= 2 * (ATOL + RTOL * abs(top[r, t, 1]))
                break
