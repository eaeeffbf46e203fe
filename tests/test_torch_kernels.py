"""`repro_torch.kernels` against `repro.kernels`: the plain versions of the
Hopper FCM kernel, and the wrappers on CPU tensors.  The kernel itself is
tested on a card by tests/test_torch_cuda.py.

Inputs come from numpy seeds and go to both packages.  Tolerances are
those of tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fcm_update import fcm_sweep_pallas
from repro.kernels.ops import accumulate_chunks as ref_accumulate_chunks
from repro.kernels.ref import fcm_accumulate_ref as jnp_accumulate_ref
from repro.kernels.ref import fcm_sweep_ref as jnp_sweep_ref
from repro_torch.kernels import ops
from repro_torch.kernels.fcm_update import (fcm_accumulate_cuda,
                                            fcm_accumulate_ref,
                                            fcm_sweep_cuda, fcm_sweep_ref)

SHAPES = [
    (64, 2, 2), (100, 130, 7), (257, 4, 3), (1000, 18, 10),
    (2048, 28, 50), (31, 41, 23), (512, 8, 129),
]
OFF_LANE_SHAPES = [
    (300, 130, 131), (200, 129, 140), (96, 257, 129), (513, 131, 200),
]
M_SWEEP = [1.05, 1.2, 2.0, 3.0]


def _inputs(n, d, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(0.1, 3.0, size=(n,)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, rtol, atol):
    for g, e in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.cpu()), np.asarray(e),
                                   rtol=rtol, atol=atol)


# -------------------------------------------------- plain vs reference ---

@pytest.mark.parametrize("n,d,c", [(64, 2, 2), (100, 130, 7), (31, 41, 23),
                                   (300, 130, 131)])
def test_plain_sweep_matches_pallas_interpret(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    want = fcm_sweep_pallas(*_j(x, w, v), 2.0, interpret=True)
    _close(fcm_sweep_ref(*_t(x, w, v), 2.0), want, 3e-4, 3e-5)


@pytest.mark.parametrize("n,d,c", SHAPES)
def test_plain_sweep_matches_ref_shapes(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    _close(fcm_sweep_ref(*_t(x, w, v), 2.0), jnp_sweep_ref(*_j(x, w, v), 2.0),
           3e-4, 3e-5)


@pytest.mark.parametrize("n,d,c", OFF_LANE_SHAPES)
def test_plain_sweep_matches_ref_off_lane(n, d, c):
    x, w, v = _inputs(n, d, c, n * 7 + d + c)
    _close(fcm_sweep_ref(*_t(x, w, v), 2.0), jnp_sweep_ref(*_j(x, w, v), 2.0),
           3e-4, 3e-4)


@pytest.mark.parametrize("n,d,c", SHAPES + OFF_LANE_SHAPES)
def test_plain_accumulate_matches_ref(n, d, c):
    x, w, v = _inputs(n, d, c, n + d + c)
    _close(fcm_accumulate_ref(*_t(x, w, v), 2.0),
           jnp_accumulate_ref(*_j(x, w, v), 2.0), 3e-4, 3e-3)


@pytest.mark.parametrize("m", M_SWEEP)
def test_plain_sweep_matches_ref_m(m):
    x, w, v = _inputs(500, 12, 6, 7)
    _close(fcm_sweep_ref(*_t(x, w, v), m), jnp_sweep_ref(*_j(x, w, v), m),
           5e-4, 5e-5)


def test_accumulate_chunks_equals_single_sweep():
    """Raw accumulators from chunk slices sum to the whole; the port's
    chunked sweep also matches the reference's."""
    x, w, v = _inputs(900, 11, 5, 17)
    cuts = [0, 250, 600, 900]
    xt, wt, vt = _t(x, w, v)
    got = ops.accumulate_chunks([xt[a:b] for a, b in zip(cuts, cuts[1:])],
                                [wt[a:b] for a, b in zip(cuts, cuts[1:])],
                                vt, 2.0)
    _close(got, [e.numpy() for e in ops.fcm_sweep_kernel(xt, wt, vt, 2.0)],
           1e-5, 1e-5)
    xj, wj, vj = _j(x, w, v)
    want = ref_accumulate_chunks([xj[a:b] for a, b in zip(cuts, cuts[1:])],
                                 [wj[a:b] for a, b in zip(cuts, cuts[1:])],
                                 vj, 2.0, accumulate_fn=lambda *a, **k:
                                 jnp_accumulate_ref(*a[:4]))
    _close(got, want, 1e-5, 1e-5)


def test_wrappers_on_cpu_take_plain_path_and_launch_nothing():
    x, w, v = _t(*_inputs(300, 13, 6, 3))
    fcm_accumulate_cuda.launches = fcm_sweep_cuda.launches = 0
    for got, want in ((fcm_sweep_cuda(x, w, v, 1.2), fcm_sweep_ref(x, w, v, 1.2)),
                      (fcm_accumulate_cuda(x, w, v, 1.2),
                       fcm_accumulate_ref(x, w, v, 1.2))):
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    assert fcm_accumulate_cuda.launches == 0
    assert fcm_sweep_cuda.launches == 0
