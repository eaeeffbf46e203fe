"""`repro_torch.optim` against `repro.optim`: the optimizers, the global
norm and its clip, and the schedules.

The port's optimizers take the reference's leaves as `Group`s — each
stacked leaf split into the per-layer tensors a model holds — so one tree
of stacked leaves, made with numpy from a seed, feeds both: leaves of ndim
2, 3 and 4, a hybrid period's (P, A, …) leaves of vectors and of
matrices, an (L, E, d, f) expert leaf, and per-layer vectors stacked (L,
D), which Adafactor factors across the layers as the reference does.
Five steps with the same gradients and learning rates; the parameters and
the state, carried back to the reference's layout, are compared.

Bars: elementwise arithmetic (AdamW, SGD) is the reference's op by op in
f32, but XLA's compiled update may contract a product and a sum into one
rounding and its f32 ``pow`` / ``cos`` may part from torch's by an ulp:
rtol 6e-7 (an ulp a step over five steps) with atol 1e-7 (an ulp of the
O(1) operands where p − lr·step cancels) on the parameters and the
moments; the cosine schedule within an ulp of its peak (the warmup ramp
bit for bit).  Adafactor's means and update RMS are f32
sums taken in another order: rtol 2e-6 / atol 1e-7.  tests/test_infra.py:76-106's own
cases run on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as RO
import repro_torch.optim as TO
from repro_torch.optim import Group

ELEMENTWISE = dict(rtol=6e-7, atol=1e-7)
FACTORED = dict(rtol=2e-6, atol=1e-7)

# path → (stacked shape, stacked axes the parts drop)
LEAVES = {
    "embed/table": ((12, 6), 0),           # one part, ndim 2
    "final_norm/scale": ((6,), 0),          # one part, a vector: unfactored
    "stages/0/ln1/scale": ((3, 6), 1),      # per-layer vectors: factored
    "stages/0/attn/wq": ((3, 6, 5), 1),     # per-layer matrices
    "stages/0/moe/w_in": ((2, 4, 6, 5), 1),  # (L, E, d, f) experts
    "stages/1/mambas/A_log": ((2, 3, 4), 2),    # (P, A, h) vectors
    "stages/1/mambas/wz": ((2, 3, 6, 5), 2),    # (P, A, d, f) matrices
}
STEPS = 5


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {p: (scale * rng.normal(size=shape)).astype(np.float32)
            for p, (shape, _) in LEAVES.items()}


def _groups(flat, dtype=torch.float32):
    out = {}
    for p, arr in flat.items():
        shape, lead = LEAVES[p]
        t = torch.tensor(arr, dtype=dtype)
        parts = t.reshape((-1,) + tuple(shape[lead:])) if lead else t[None]
        out[p] = Group(tuple(shape), tuple(x.clone() for x in parts))
    return out


def _grads(flat, dtype=torch.float32):
    return {p: list(g.parts) for p, g in _groups(flat, dtype).items()}


def _stacked(groups):
    return {p: torch.stack(list(g.parts)).reshape(g.shape).float().numpy()
            for p, g in groups.items()}


def _lr(step):
    return RO.cosine_schedule(step, peak=3e-2, warmup=2, total=STEPS)


def _run(make_ref, make_port, dtype=torch.float32, jdtype=jnp.float32):
    """STEPS steps of both optimizers from the same params and grads →
    (reference params, reference state, port params, port state)."""
    ref_opt, port_opt = make_ref(), make_port()
    rp = {p: jnp.asarray(a, jdtype) for p, a in _tree(0).items()}
    rs = ref_opt.init(rp)
    tp = _groups(_tree(0), dtype)
    ts = port_opt.init(tp)
    upd = jax.jit(ref_opt.update)
    for k in range(STEPS):
        g = _tree(100 + k, scale=10.0 ** (k % 3 - 1))
        lr = _lr(k)
        rp, rs = upd({p: jnp.asarray(a, jdtype) for p, a in g.items()},
                     rs, rp, lr)
        tp, ts = port_opt.update(_grads(g, dtype), ts, tp,
                                 TO.cosine_schedule(k, peak=3e-2, warmup=2,
                                                    total=STEPS))
    return rp, rs, tp, ts


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _check_state(ref_state, port_state, tp, **tol):
    carried = TO.state_to_reference(port_state, tp)
    for key, val in carried.items():
        if key == "count":
            assert int(val) == int(ref_state["count"])
            continue
        for p in LEAVES:
            if isinstance(val[p], dict):
                for k, t in val[p].items():
                    _close(t.float().numpy(), ref_state[key][p][k], **tol)
            else:
                _close(val[p].float().numpy(), ref_state[key][p], **tol)
    # and back: the port's state rebuilt from the reference's
    ref_np = {k: (v if k == "count" else {
        p: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v[p])
        for p in LEAVES}) for k, v in ref_state.items()}
    again = TO.state_to_reference(TO.state_from_reference(ref_np, tp), tp)
    for key, val in again.items():
        if key != "count":
            for p in LEAVES:
                for want, got in zip(jax.tree_util.tree_leaves(ref_np[key][p]),
                                     jax.tree_util.tree_leaves(
                                         jax.tree_util.tree_map(
                                             lambda t: t.numpy(), val[p]))):
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype):
    rp, rs, tp, ts = _run(
        lambda: RO.adamw(state_dtype=getattr(jnp, state_dtype)),
        lambda: TO.adamw(state_dtype=getattr(torch, state_dtype)))
    for p, want in rp.items():
        _close(_stacked(tp)[p], want, **ELEMENTWISE)
    tol = ELEMENTWISE if state_dtype == "float32" else dict(rtol=2 ** -8,
                                                            atol=0)
    _check_state(rs, ts, tp, **tol)
    assert ts["mu"]["stages/0/attn/wq"][0].dtype == getattr(torch,
                                                            state_dtype)


def test_adafactor_matches_reference():
    rp, rs, tp, ts = _run(RO.adafactor, TO.adafactor)
    for p, want in rp.items():
        _close(_stacked(tp)[p], want, **FACTORED)
    _check_state(rs, ts, tp, **FACTORED)
    # the stacked (L, D) norm leaf is factored across its layers
    m = ts["m"]
    assert set(m["stages/0/ln1/scale"]) == {"vr", "vc"}
    assert tuple(m["stages/0/ln1/scale"]["vr"].shape) == (3,)
    assert tuple(m["stages/0/ln1/scale"]["vc"].shape) == (6,)
    assert tuple(m["stages/1/mambas/A_log"]["vc"].shape) == (2, 4)
    assert set(m["final_norm/scale"]) == {"v"}


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_matches_reference(momentum):
    rp, rs, tp, ts = _run(lambda: RO.sgd(momentum),
                          lambda: TO.sgd(momentum))
    for p, want in rp.items():
        _close(_stacked(tp)[p], want, **ELEMENTWISE)
    if momentum is None:
        assert ts == {} and rs == {}
    else:
        _check_state(rs, ts, tp, **ELEMENTWISE)


def test_adamw_bf16_params_round_once():
    """bf16 parameters: the update in f32, rounded once to bf16, as the
    reference's ``p_n.astype(p.dtype)``."""
    rp, _, tp, _ = _run(RO.adamw, TO.adamw, dtype=torch.bfloat16,
                        jdtype=jnp.bfloat16)
    for p, want in rp.items():
        got = _stacked(tp)[p]
        _close(got, np.asarray(want, np.float32), rtol=2 ** -8, atol=0)


def test_make_names_the_three():
    for name in ("adamw", "adafactor", "sgd"):
        assert isinstance(TO.make(name), TO.Optimizer)


def test_global_norm_and_clip_match_reference():
    g = _tree(7, scale=3.0)
    want = float(RO.global_norm({p: jnp.asarray(a) for p, a in g.items()}))
    grads = _grads(g)
    assert float(TO.global_norm(grads)) == pytest.approx(want, rel=1e-6)
    ref_c, ref_n = RO.clip_by_global_norm(
        {p: jnp.asarray(a) for p, a in g.items()}, 1.0)
    got, n = TO.clip_by_global_norm(grads, 1.0)
    assert float(n) == pytest.approx(float(ref_n), rel=1e-6)
    for p, ts in got.items():
        _close(torch.stack(ts).reshape(LEAVES[p][0]).numpy(), ref_c[p],
               rtol=2e-6, atol=0)
    # bf16 gradients come back in bf16, scaled in f32
    gb = _grads(g, torch.bfloat16)
    TO.clip_by_global_norm(gb, 1.0)
    assert gb["embed/table"][0].dtype == torch.bfloat16
    # below the bar: untouched
    small = _grads(_tree(8, scale=1e-3))
    before = [t.clone() for ts in small.values() for t in ts]
    TO.clip_by_global_norm(small, 1e3)
    after = [t for ts in small.values() for t in ts]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 5), (5, 5),
                                         (100, 10_000)])
def test_schedules_match_reference(warmup, total):
    steps = list(range(0, min(total + 3, 40))) + [total - 1, total,
                                                  total + 7]
    for s in steps:
        want = np.float32(RO.cosine_schedule(jnp.int32(s), peak=3e-4,
                                             warmup=warmup, total=total))
        got = TO.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                 peak=3e-4, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        # XLA's and torch's f32 cos part by an ulp, which 1 + cos keeps
        # in absolute terms: within an ulp of the peak
        assert abs(got.item() - want.item()) <= np.spacing(np.float32(3e-4)), \
            (s, got.item(), want.item())
        w_want = np.float32(RO.linear_warmup(jnp.int32(s), warmup, 1e-3))
        assert TO.linear_warmup(s, warmup, 1e-3).item() == w_want.item()


# ------------------------------- tests/test_infra.py:76-106 on the port ---

def test_clip_by_global_norm():
    g = {"w": torch.full((4,), 10.0)}
    clipped, norm = TO.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(TO.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape():
    lr0 = float(TO.cosine_schedule(0, peak=1.0, warmup=10, total=100))
    lr_peak = float(TO.cosine_schedule(10, peak=1.0, warmup=10, total=100))
    lr_end = float(TO.cosine_schedule(100, peak=1.0, warmup=10, total=100))
    assert lr0 < lr_peak
    assert lr_end == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("optname", ["adamw", "adafactor"])
def test_optimizers_reduce_quadratic(optname):
    opt = TO.make(optname)
    w = torch.tensor([3.0, -2.0], requires_grad=True)
    params = {"w": w}
    state = opt.init(params)
    for _ in range(50):
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state = opt.update({"w": g}, state, params, 0.1)
    assert float(w.detach().abs().max()) < 1.0
