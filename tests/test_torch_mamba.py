"""`repro_torch.models.mamba` against `repro.models.mamba` on the CPU.

The SSD (`ssd_chunked`, `ssd_decode_step`) against the reference and
tests/test_mamba.py's sequential-recurrence oracle at that file's 2e-4,
at chunk sizes 4, 8 and 24, continued from an initial state; the causal
conv, its cache, and the whole Mamba2 block (prefill and decode) against
the reference's on the reference's own parameters, f32 at rtol 1e-4 /
atol 1e-5, bf16 against the reference evaluated op by op."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.mamba as RMB
from repro.models.params import tree_init as ref_tree_init
import repro_torch.configs as TC
import repro_torch.models.mamba as TMB

TOL = 2e-4                     # tests/test_mamba.py
RTOL, ATOL = 1e-4, 1e-5        # port vs reference, f32


def _inputs(b=2, s=24, h=3, p=4, n=5, seed=0):
    """tests/test_mamba.py's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32),
            rng.uniform(-1, 1, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


def _sequential(x, dt, a_log, bm, cm, d_skip, state=None):
    """The recurrence one position at a time, in float64."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    state = (np.zeros((b, h, n, p)) if state is None
             else np.asarray(state, np.float64))
    a = -np.exp(a_log.astype(np.float64))
    ys = []
    for t in range(s):
        da = np.exp(a * dt[:, t])
        xd = x[:, t] * dt[:, t][..., None]
        state = da[:, :, None, None] * state + \
            np.einsum("bhn,bhp->bhnp", bm[:, t], xd)
        y = np.einsum("bhn,bhnp->bhp", cm[:, t], state)
        ys.append(y + d_skip[None, :, None] * x[:, t])
    return np.stack(ys, 1), state


def _t(args):
    return [torch.from_numpy(a) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


def _close(got, want, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_ssd_chunked_matches_sequential_and_reference(chunk):
    args = _inputs()
    y, final = TMB.ssd_chunked(*_t(args), chunk=chunk)
    assert y.dtype == final.dtype == torch.float32
    y_seq, final_seq = _sequential(*args)
    _close(y, y_seq)
    _close(final, final_seq)
    y_ref, final_ref = RMB.ssd_chunked(*_j(args), chunk=chunk)
    _close(y, y_ref, RTOL, ATOL)
    _close(final, final_ref, RTOL, ATOL)


@pytest.mark.parametrize("chunk", [4, 8])
def test_ssd_initial_state_continuation(chunk):
    x, dt, a_log, bm, cm, d_skip = _t(_inputs(s=16))
    y_full, final_full = TMB.ssd_chunked(x, dt, a_log, bm, cm, d_skip,
                                         chunk=chunk)
    y1, s1 = TMB.ssd_chunked(x[:, :8], dt[:, :8], a_log, bm[:, :8],
                             cm[:, :8], d_skip, chunk=chunk)
    y2, s2 = TMB.ssd_chunked(x[:, 8:], dt[:, 8:], a_log, bm[:, 8:],
                             cm[:, 8:], d_skip, chunk=chunk, init_state=s1)
    _close(torch.cat([y1, y2], 1), y_full.numpy())
    _close(s2, final_full.numpy())
    ref = _j(_inputs(s=16))
    _, rs1 = RMB.ssd_chunked(*(a[:, :8] if a.ndim > 1 else a for a in ref),
                             chunk=chunk)
    ry2, rs2 = RMB.ssd_chunked(*(a[:, 8:] if a.ndim > 1 else a for a in ref),
                               chunk=chunk, init_state=rs1)
    _close(y2, ry2, RTOL, ATOL)
    _close(s2, rs2, RTOL, ATOL)


def test_ssd_decode_step_matches_sequential_and_reference():
    args = _inputs(s=6)
    y_seq, _ = _sequential(*args)
    x, dt, a_log, bm, cm, d_skip = _t(args)
    rx, rdt, ra, rb, rc, rd = _j(args)
    state = torch.zeros((2, 3, 5, 4))
    rstate = jnp.zeros((2, 3, 5, 4), jnp.float32)
    ys = []
    for t in range(6):
        y, state = TMB.ssd_decode_step(state, x[:, t], dt[:, t], a_log,
                                       bm[:, t], cm[:, t], d_skip)
        ry, rstate = RMB.ssd_decode_step(rstate, rx[:, t], rdt[:, t], ra,
                                         rb[:, t], rc[:, t], rd)
        _close(y, ry, RTOL, ATOL)
        ys.append(y)
    _close(torch.stack(ys, 1), y_seq)
    _close(state, rstate, RTOL, ATOL)


def test_ssd_rejects_a_partial_chunk():
    with pytest.raises(ValueError, match="chunks of 8"):
        TMB.ssd_chunked(*_t(_inputs(s=12)), chunk=8)


def test_segsum_and_softplus_match_reference():
    x = np.random.default_rng(1).normal(size=(2, 3, 6)).astype(np.float32)
    got = TMB._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(RMB._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6, atol=1e-6)
    v = np.concatenate([np.linspace(-40, 40, 81), [-1e-3, 0.0, 1e-3, 25.0]])
    np.testing.assert_allclose(
        TMB.softplus(torch.from_numpy(v.astype(np.float32))).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(v, jnp.float32))),
        rtol=1e-6, atol=1e-7)


def _cfgs(**kw):
    rcfg = dataclasses.replace(RC.reduced(RC.get_config("mamba2-2.7b")),
                               **kw)
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("mamba2-2.7b")),
                               **kw)
    return rcfg, tcfg


def _block(rcfg, tcfg, seed, dtype=jnp.float32):
    """The reference's mixer params (A_log, dt_bias and conv_b drawn, not
    their zeros, so every path carries weight) and the port's `Mamba`."""
    decl = RMB.mamba_decl(rcfg)
    p = ref_tree_init(jax.random.PRNGKey(seed), decl, dtype)
    rng = np.random.default_rng(seed)
    for k in ("A_log", "dt_bias", "conv_b"):
        p[k] = jnp.asarray(rng.uniform(-0.5, 0.5, decl[k].shape), dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    mod = TMB.Mamba(tcfg, dtype=tdt, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
                         for k, v in p.items()})
    return p, mod


def test_conv_causal_and_its_cache_match_reference():
    """The depthwise conv over a whole sequence, and the same sequence
    in two pieces carried by its conv state: both against the
    reference's, the pieces against the whole."""
    rcfg, tcfg = _cfgs()
    p, mod = _block(rcfg, tcfg, 2)
    ch = mod.conv_w.shape[1]
    xbc = np.random.default_rng(3).normal(size=(2, 9, ch)).astype(np.float32)
    out, state = TMB._conv_causal(mod, torch.from_numpy(xbc))
    rout, rstate = RMB._conv_causal(p, jnp.asarray(xbc))
    _close(out, rout, RTOL, ATOL)
    _close(state, rstate, 0, 0)
    zero = torch.zeros((2, tcfg.ssm_conv - 1, ch))
    a, sa = TMB._conv_causal(mod, torch.from_numpy(xbc[:, :5]), zero)
    b, sb = TMB._conv_causal(mod, torch.from_numpy(xbc[:, 5:]), sa)
    _close(torch.cat([a, b], 1), out.numpy(), 0, 1e-6)
    _close(sb, state.numpy(), 0, 0)
    rb, rsb = RMB._conv_causal(p, jnp.asarray(xbc[:, 5:]),
                               jnp.asarray(sa.numpy()))
    _close(b, rb, RTOL, ATOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_block_matches_reference(groups):
    """The mixer over 8 positions without a cache; then with a cache, a
    cached prefill of 4 (chunked SSD from the zero state) and four
    single-token steps (the decode step and the conv cache), each
    against the reference's, caches included."""
    rcfg, tcfg = _cfgs(ssm_groups=groups)
    p, mod = _block(rcfg, tcfg, 4)
    x = np.random.default_rng(5).normal(size=(2, 8, tcfg.d_model)).astype(
        np.float32)
    y, none = mod(torch.from_numpy(x))
    ry, _ = RMB.mamba_block(rcfg, p, jnp.asarray(x))
    assert none is None
    _close(y, ry, RTOL, ATOL)
    cache = TMB.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    rcache = RMB.init_mamba_cache(rcfg, 2, jnp.float32)
    assert cache.conv.shape == rcache.conv.shape
    assert cache.ssm.shape == rcache.ssm.shape and \
        cache.ssm.dtype == torch.float32
    for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 7), (7, 8)):
        yc, cache = mod(torch.from_numpy(x[:, lo:hi]), cache)
        ryc, rcache = RMB.mamba_block(rcfg, p, jnp.asarray(x[:, lo:hi]),
                                      cache=rcache)
        _close(yc, ryc, RTOL, ATOL)
        _close(cache.conv, rcache.conv, RTOL, ATOL)
        _close(cache.ssm, rcache.ssm, RTOL, ATOL)
        _close(yc, y[:, lo:hi].numpy(), 5e-3, 5e-4)   # decode vs forward


def test_mamba_block_bf16_matches_reference():
    """bf16 weights and activations (the SSD in f32 inside): against the
    reference evaluated op by op, at least 95 % of the outputs bit-equal
    and none more than 2⁻⁶ of the largest apart."""
    rcfg, tcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    p, mod = _block(rcfg, tcfg, 6, jnp.bfloat16)
    x = np.random.default_rng(7).normal(size=(2, 8, tcfg.d_model)).astype(
        np.float32)
    with torch.inference_mode():
        y, _ = mod(torch.from_numpy(x).to(torch.bfloat16))
    with jax.disable_jit():
        ry, _ = RMB.mamba_block(rcfg, p, jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    ry = np.asarray(ry, np.float32)
    got = y.float().numpy()
    assert float(np.mean(got == ry)) >= 0.95
    np.testing.assert_allclose(got, ry, rtol=0,
                               atol=2.0 ** -6 * np.abs(ry).max())


def test_mamba_dims_and_decl_match_reference():
    for arch in ("mamba2-2.7b", "zamba2-7b"):
        for red in (False, True):
            rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
            if red:
                rcfg, tcfg = RC.reduced(rcfg), TC.reduced(tcfg)
            assert TMB.mamba_dims(tcfg) == RMB.mamba_dims(rcfg)
            assert {k: (d.shape, d.init) for k, d in
                    TMB.mamba_decl(tcfg).items()} == \
                {k: (d.shape, d.init) for k, d in
                 RMB.mamba_decl(rcfg).items()}
