"""`repro_torch.models.moe` against `repro.models.moe` on the CPU.

The reference's own parameters (`repro.models.params.tree_init`) and
seeded numpy inputs go through both.  f32 outputs within rtol 2e-3 /
atol 2e-4 (tests/test_moe.py); expert choices and drop sets equal at
tight capacity (cf 0.5), except for a token whose k-th and (k+1)-th
probabilities lie within rounding of each other; in bf16 the port
against the reference evaluated op by op, with
tests/test_torch_models.py's bars."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.moe as RM
from repro.configs.base import ModelConfig as RMC
from repro.models.params import tree_init as ref_tree_init
import repro_torch.configs as TC
import repro_torch.models.moe as TM
from repro_torch.configs.base import ModelConfig

RTOL, ATOL = 2e-3, 2e-4


def _cfgs(**kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=16, vocab=64, n_experts=8, top_k=2,
                capacity_factor=8.0, compute_dtype="float32",
                param_dtype="float32")
    base.update(kw)
    return RMC(**base), ModelConfig(**base)


def _params(rcfg, seed, dtype=jnp.float32):
    """The reference's params and the port's `MoE` module carrying them."""
    p = ref_tree_init(jax.random.PRNGKey(seed), RM.moe_decl(rcfg), dtype)
    tcfg = ModelConfig(**dataclasses.asdict(rcfg))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    mod = TM.MoE(tcfg, dtype=tdt, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         .to(tdt) for k, v in p.items()})
    return p, mod


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _ref_dispatch(cfg, p, x):
    """The reference's routing and capacity (src/repro/models/moe.py:
    132-152 at one rank), in jnp: (probs (T, E), eidx (T, k), valid
    (T·k,) in the flat (token, k) order)."""
    t = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(t, -1)
    logits = jnp.einsum("td,de->te", xt, p["w_router"].astype(xt.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    cap = max(8, int(t * cfg.top_k * cfg.capacity_factor) // cfg.n_experts)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jax.ops.segment_sum(jnp.ones_like(sorted_e), sorted_e,
                                 num_segments=cfg.n_experts)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(t * cfg.top_k) - starts[sorted_e]
    valid = np.zeros(t * cfg.top_k, bool)
    valid[np.asarray(order)] = np.asarray(pos < cap)
    return np.asarray(probs), np.asarray(eidx), valid


def _near_tied(probs, k, tol=1e-6):
    """Tokens whose k-th and (k+1)-th probabilities lie within ``tol``
    (relative) of each other: their k-th choice is rounding's."""
    top = np.sort(probs.astype(np.float64), axis=-1)[:, ::-1]
    return np.abs(top[:, k - 1] - top[:, k]) <= tol * top[:, k - 1]


# ------------------------------------------------------- the layer -------

MOE_CASES = {"cf8": {}, "tight": dict(capacity_factor=0.5),
             "top1": dict(top_k=1, n_experts=4),
             "shared": dict(n_shared_experts=1),
             "shared2_tight": dict(n_shared_experts=2, capacity_factor=0.5)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_reference(case):
    rcfg, tcfg = _cfgs(**MOE_CASES[case])
    p, mod = _params(rcfg, 0)
    x = _x((2, 16, 32), 1)
    want = RM.moe(rcfg, p, jnp.asarray(x))
    got = mod(torch.from_numpy(x))
    assert got.shape == (2, 16, 32) and got.dtype == torch.float32
    _close(got, want)


def test_moe_matches_dense_oracle():
    """tests/test_moe.py's oracle: every token through its top-k experts,
    no capacity, plain numpy loops."""
    rcfg, tcfg = _cfgs()
    p, mod = _params(rcfg, 0)
    x = _x((2, 6, 32), 0)
    xt = x.reshape(-1, 32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt @ np.asarray(
        p["w_router"])), -1))
    eidx = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    gate = np.take_along_axis(probs, eidx, -1)
    gate = gate / gate.sum(-1, keepdims=True)
    wi, wo = np.asarray(p["w_in"]), np.asarray(p["w_out"])
    want = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(2):
            u, g = np.split(xt[t] @ wi[eidx[t, j]], 2)
            want[t] += gate[t, j] * ((u * (g / (1 + np.exp(-g))))
                                     @ wo[eidx[t, j]])
    _close(mod(torch.from_numpy(x)), want.reshape(2, 6, 32))


@pytest.mark.parametrize("cf,shape", [(0.5, (2, 16, 32)), (0.5, (4, 40, 32)),
                                      (1.25, (3, 32, 32)), (8.0, (2, 8, 32))])
def test_expert_choices_and_drops_match_reference(cf, shape):
    """The same experts chosen for every token and the same (token,
    expert) pairs dropped past capacity; a token near a tie at its k-th
    choice is exempt (its choice and its pairs)."""
    rcfg, tcfg = _cfgs(capacity_factor=cf)
    p, mod = _params(rcfg, 2)
    x = _x(shape, 3)
    probs, eidx_ref, valid_ref = _ref_dispatch(rcfg, p, x)
    xt = torch.from_numpy(x).reshape(-1, 32)
    gate, eidx = TM.route(tcfg, mod.w_router, xt)
    dp = TM.dispatch(tcfg, eidx)
    valid = np.zeros(eidx.numel(), bool)
    valid[dp.order.numpy()] = dp.valid.numpy()
    ok = ~_near_tied(probs, tcfg.top_k)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(eidx.numpy()[ok], eidx_ref[ok])
    if ok.all():   # a near tie may move another token's rank in its expert
        np.testing.assert_array_equal(valid, valid_ref)
    assert dp.cap == max(8, int(np.prod(shape[:2]) * 2 * cf) // 8)
    if cf < 1:
        assert (~valid_ref).sum() > 0      # the case drops pairs
    np.testing.assert_array_equal(
        TM.dropped_pairs(tcfg, mod, torch.from_numpy(x)), (~valid_ref).sum())
    _close(gate, np.take_along_axis(probs, eidx_ref, -1)
           / np.take_along_axis(probs, eidx_ref, -1).sum(-1, keepdims=True))


def test_top_k_keeps_lower_index_on_ties():
    """`jax.lax.top_k`'s order: ties to the lower index, whatever their
    place; bf16 values tie often."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 5, (64, 16)).astype(np.float32) / 4
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        vals, idx = TM.top_k(torch.from_numpy(x).to(dt), 6)
        rv, ri = jax.lax.top_k(jnp.asarray(x, jdt), 6)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(vals.float().numpy(),
                                      np.asarray(rv, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_matches_jax(dtype):
    x = _x((5, 64), 5, 3.0)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    got = TM.softmax(torch.from_numpy(x).to(tdt))
    want = jax.nn.softmax(jnp.asarray(x, jdt), -1)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-6 if dtype == "float32" else 0,
                               atol=0 if dtype == "float32" else 2 ** -9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_load_matches_reference(dtype):
    """The histogram of the top-k of a softmax taken in the logits' own
    dtype (bf16 here: many ties, each to the lower expert)."""
    rcfg, tcfg = _cfgs(compute_dtype=dtype, param_dtype=dtype)
    jdt = jnp.dtype(dtype)
    p, mod = _params(rcfg, 6, jdt)
    x = _x((2, 10, 32), 7)
    want = np.asarray(RM.router_load(rcfg, p, jnp.asarray(x, jdt)))
    got = TM.router_load(tcfg, mod, torch.from_numpy(x).to(mod.w_router.dtype))
    assert got.sum() == 2 * 10 * tcfg.top_k
    np.testing.assert_array_equal(got.numpy(), want)


def _bf16_close(got, want, min_equal, atol_rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    equal = float(np.mean(got == want))
    assert equal >= min_equal, equal
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol_rel * np.abs(want).max())


@pytest.mark.parametrize("case", ["cf8", "tight", "shared"])
def test_moe_bf16_matches_reference(case):
    """bf16 weights and activations: against the reference evaluated op
    by op (``jax.disable_jit``), whose scatter-add sums each token's k
    weighted outputs in ascending expert order, rounding after each add
    — the port's combine.  At least 95 % of the outputs bit-equal, none
    more than 2⁻⁶ of the largest apart."""
    rcfg, tcfg = _cfgs(compute_dtype="bfloat16", param_dtype="bfloat16",
                       top_k=4, **MOE_CASES[case])
    p, mod = _params(rcfg, 8, jnp.bfloat16)
    x = _x((2, 16, 32), 9)
    with jax.disable_jit():
        want = RM.moe(rcfg, p, jnp.asarray(x, jnp.bfloat16))
    got = mod(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want, 0.95, 2.0 ** -6)


def test_combine_adds_in_expert_order():
    """The combine's bf16 sum: each token's k contributions added one at
    a time in ascending expert order, from the first — not as one f32
    sum rounded once, nor in choice order."""
    rcfg, tcfg = _cfgs(compute_dtype="bfloat16", param_dtype="bfloat16",
                       top_k=4)
    p, mod = _params(rcfg, 10, jnp.bfloat16)
    x = torch.from_numpy(_x((1, 24, 32), 11)).to(torch.bfloat16)
    xt = x.reshape(24, 32)
    gate, eidx = TM.route(tcfg, mod.w_router, xt)
    outs = []
    for t in range(24):
        terms = []
        for j in range(4):
            e = int(eidx[t, j])
            y = TM._expert_ffn(mod.w_in[e:e + 1], mod.w_out[e:e + 1],
                               xt[t][None, None])[0, 0]
            terms.append((e, y * gate[t, j].to(torch.bfloat16)))
        acc = None
        for _, term in sorted(terms, key=lambda et: et[0]):
            acc = term if acc is None else acc + term
        outs.append(acc)
    want = torch.stack(outs)
    got = TM.moe(tcfg, mod, x).reshape(24, 32)
    assert torch.equal(got, want)


def test_shared_experts_kimi_reduced():
    """Reduced kimi (one shared expert): the port matches the reference,
    and zeroing the shared weights changes the output."""
    rcfg = dataclasses.replace(RC.reduced(RC.get_config("kimi-k2-1t-a32b")),
                               capacity_factor=8.0)
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("kimi-k2-1t-a32b")),
                               capacity_factor=8.0)
    assert tcfg.n_shared_experts == 1
    p, mod = _params(rcfg, 12)
    x = _x((2, 6, tcfg.d_model), 13)
    y = mod(torch.from_numpy(x))
    _close(y, RM.moe(rcfg, p, jnp.asarray(x)))
    with torch.no_grad():
        mod.w_shared_in.zero_()
    assert not np.allclose(mod(torch.from_numpy(x)).numpy(), y.numpy())


def test_moe_module_reads_like_a_dict():
    rcfg, tcfg = _cfgs(n_shared_experts=1)
    _, mod = _params(rcfg, 0)
    assert set(dict(mod.named_parameters())) == set(TM.moe_decl(tcfg))
    assert "w_shared_in" in mod and mod["w_in"].shape == (8, 32, 32)
    assert TM.capacity(tcfg, 16) == 32 and TM.capacity(tcfg, 1) == 8


def test_expert_groups_give_the_same_products(monkeypatch):
    """The experts run in groups under FFN_GROUP_ELEMS (the f32 holds at
    full width, where an expert's rows reach every token): one expert a
    group gives the same result bit for bit."""
    rcfg, tcfg = _cfgs(capacity_factor=0.5)
    p, mod = _params(rcfg, 14)
    x = torch.from_numpy(_x((2, 16, 32), 15))
    whole = mod(x)
    monkeypatch.setattr(TM, "FFN_GROUP_ELEMS", 1)
    assert torch.equal(mod(x), whole)
