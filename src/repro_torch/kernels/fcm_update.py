"""The Hopper FCM accumulation kernels' wrappers and their plain versions.

Counterpart of `repro.kernels.fcm_update` (the Pallas TPU kernel) and
`repro.kernels.ref` (its oracles).  The kernels are CUDA C++ for
``sm_90a``: the single-model sweep in ``csrc/fcm_accumulate.cu`` and the
tenant-stacked sweep (the reference's ``jax.vmap`` of the Pallas kernel)
in ``csrc/fcm_batched.cu``; each source note says what it replaces, what
bounds it and how it is laid out.

* ``fcm_accumulate_cuda`` / ``fcm_sweep_cuda`` — the single-model
  wrappers, x (N, d), w (N,), centers (C, d).
* ``fcm_accumulate_batched_cuda`` / ``fcm_sweep_batched_cuda`` — the
  tenant-stacked wrappers, x (T, N, d), w (T, N), centers (T, C, d), m
  a scalar or one fuzzifier per tenant (T,).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version.  Each wrapper counts its kernel launches in its
``launches`` attribute.  ``fcm_accumulate_ref`` / ``fcm_sweep_ref`` and
``fcm_accumulate_batched_ref`` / ``fcm_sweep_batched_ref`` are the plain
PyTorch versions, written as `repro.kernels.ref` writes its oracles (the
direct ‖x−v‖², not the kernels' expansion).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_D2_FLOOR = 1e-12
BLOCK = 256          # threads per CTA; the kernel's q reduction needs a power of 2
_P = ctypes.c_void_p
_I = ctypes.c_int


def fcm_accumulate_ref(x, w, centers, m: float = 2.0):
    """Plain raw accumulators (v_num, w_i, q)."""
    x = x.float()
    w = w.float()
    v = centers.float()
    d2 = torch.clamp(torch.sum((x[:, None, :] - v[None, :, :]) ** 2, dim=-1),
                     min=_D2_FLOOR)
    expo = 1.0 / (m - 1.0)
    logd = torch.log(d2)
    lmin = torch.min(logd, dim=-1, keepdim=True).values
    r = torch.exp(-expo * (logd - lmin))
    u = r / torch.sum(r, dim=-1, keepdim=True)
    wum = torch.pow(u, m) * w[:, None]
    return wum.T @ x, torch.sum(wum, dim=0), torch.sum(wum * d2)


def fcm_sweep_ref(x, w, centers, m: float = 2.0):
    """Plain Alg.-1 sweep (v_new, w_i, q): the accumulate version plus
    the one deferred normalization."""
    v_num, w_i, q = fcm_accumulate_ref(x, w, centers, m)
    return v_num / torch.clamp(w_i, min=_D2_FLOOR)[:, None], w_i, q


def _fuzzifiers(m, tenants: int, device) -> torch.Tensor:
    """``m`` (a number, or one value per tenant) as a (T,) f32 tensor."""
    m = torch.as_tensor(m, dtype=torch.float32, device=device)
    if m.dim() == 0:
        return m.expand(tenants)
    if m.shape != (tenants,):
        raise ValueError(f"m has shape {tuple(m.shape)}; expected a scalar "
                         f"or one fuzzifier per tenant ({tenants},)")
    return m


def fcm_accumulate_batched_ref(x, w, centers, m=2.0):
    """Plain raw accumulators per tenant: (v_num (T, C, d), w_i (T, C),
    q (T,)) for x (T, N, d), w (T, N), centers (T, C, d), m a scalar or
    (T,)."""
    x = x.float()
    w = w.float()
    v = centers.float()
    mt = _fuzzifiers(m, x.shape[0], x.device)[:, None, None]
    d2 = torch.clamp(
        torch.sum((x[:, :, None, :] - v[:, None, :, :]) ** 2, dim=-1),
        min=_D2_FLOOR)                                    # (T, N, C)
    expo = 1.0 / (mt - 1.0)
    logd = torch.log(d2)
    lmin = torch.min(logd, dim=-1, keepdim=True).values
    r = torch.exp(-expo * (logd - lmin))
    u = r / torch.sum(r, dim=-1, keepdim=True)
    wum = torch.pow(u, mt) * w[:, :, None]
    return (wum.transpose(1, 2) @ x, torch.sum(wum, dim=1),
            torch.sum(wum * d2, dim=(1, 2)))


def fcm_sweep_batched_ref(x, w, centers, m=2.0):
    """Plain tenant-stacked sweep (v_new, w_i, q), each with leading T."""
    v_num, w_i, q = fcm_accumulate_batched_ref(x, w, centers, m)
    return v_num / torch.clamp(w_i, min=_D2_FLOOR)[..., None], w_i, q


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fcm_accumulate")
    lib.fcm_error_string.argtypes = [_I]
    lib.fcm_error_string.restype = ctypes.c_char_p
    lib.fcm_tile_rows.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.fcm_tile_rows.restype = _I
    lib.fcm_grid_size.argtypes = [ctypes.c_longlong, _I, _I, _I, _I,
                                  ctypes.POINTER(_I)]
    lib.fcm_grid_size.restype = _I
    lib.fcm_accumulate.argtypes = [
        _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float,
        ctypes.c_float, _I, _I, _I, _P, _P, _P, _P, _I, _P]
    lib.fcm_accumulate.restype = _I
    return lib


@functools.cache
def _batched_lib() -> ctypes.CDLL:
    lib = build.load("fcm_batched")
    lib.fcm_batched_error_string.argtypes = [_I]
    lib.fcm_batched_error_string.restype = ctypes.c_char_p
    lib.fcm_batched_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, ctypes.POINTER(_I),
        ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.fcm_batched_plan.restype = _I
    lib.fcm_batched_accumulate.argtypes = [
        _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _I,
        _I, _I, _P, _P, _P, _P, _I, _P]
    lib.fcm_batched_accumulate.restype = _I
    return lib


def _check(err: int, what: str, kernel: str = "fcm_accumulate") -> None:
    if err:
        lib = _lib() if kernel == "fcm_accumulate" else _batched_lib()
        msg = getattr(lib, f"{kernel}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} kernel: {what} failed with CUDA "
                           f"error {err} ({msg})")


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, n: int, d: int, c: int):
    """(tile rows T, grid) for one shape on one card: the largest tile
    whose V, x tile and d²/wum tiles fit in shared memory, and a
    persistent grid of as many CTAs as the card holds at once."""
    lib = _lib()
    t, g = _I(0), _I(0)
    _check(lib.fcm_tile_rows(d, c, BLOCK, ctypes.byref(t)), "fcm_tile_rows")
    if t.value == 0:
        raise ValueError(
            f"fcm_accumulate kernel: C*d = {c}*{d} centers do not fit in "
            "shared memory; a C-tiled variant is on the roadmap")
    _check(lib.fcm_grid_size(n, d, c, t.value, BLOCK, ctypes.byref(g)),
           "fcm_grid_size")
    return t.value, g.value


def _check_inputs(kernel: str, x, w, centers, dims) -> None:
    """Device, type and rank checks shared by both kernels' wrappers."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} kernel: x on {x.device}, not CUDA")
    for name, a, dim in zip(("x", "w", "centers"), (x, w, centers), dims):
        if a.device != x.device:
            raise ValueError(f"{kernel} kernel: {name} on {a.device}, "
                             f"x on {x.device}")
        if not a.is_floating_point():
            raise TypeError(f"{kernel} kernel: {name} has dtype "
                            f"{a.dtype}, expected a floating type")
        if a.dim() != dim:
            raise ValueError(f"{kernel} kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {dim} dims")


def _launch(x, w, centers, m: float, normalize: bool):
    _check_inputs("fcm_accumulate", x, w, centers, (2, 1, 2))
    n, d = x.shape
    c = centers.shape[0]
    if w.shape[0] != n or centers.shape[1] != d or c == 0 or d == 0:
        raise ValueError(
            "fcm_accumulate kernel: shapes x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, centers "
            f"{tuple(centers.shape)} do not form (N, d), (N,), (C, d)")
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    v = centers.to(torch.float32).contiguous()
    dev = x.device
    with torch.cuda.device(dev):
        t, grid = _plan(dev.index, n, d, c)
        part = torch.empty((grid, c * d + c + 1), dtype=torch.float32,
                           device=dev)
        out_v = torch.empty((c, d), dtype=torch.float32, device=dev)
        out_w = torch.empty((c,), dtype=torch.float32, device=dev)
        out_q = torch.empty((), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fcm_accumulate(
            x.data_ptr(), w.data_ptr(), v.data_ptr(), n, d, c, float(m),
            1.0 / (m - 1.0), t, grid, BLOCK, part.data_ptr(),
            out_v.data_ptr(), out_w.data_ptr(), out_q.data_ptr(),
            int(normalize), stream)
    _check(err, "launch")
    return out_v, out_w, out_q


def fcm_accumulate_cuda(x, w, centers, m: float = 2.0):
    """Raw Alg.-1 accumulators (v_num (C, d), w_i (C,), q ()) — the
    streaming entry, normalization deferred so partials from chunks add.

    x: (N, d), w: (N,), centers: (C, d), any float type (cast to f32)."""
    if x.device.type == "cpu":
        return fcm_accumulate_ref(x, w, centers, m)
    out = _launch(x, w, centers, m, normalize=False)
    fcm_accumulate_cuda.launches += 1
    return out


def fcm_sweep_cuda(x, w, centers, m: float = 2.0):
    """Alg.-1 sweep (v_new, w_i, q): the accumulate entry with the
    normalization v_num / max(w_i, 1e-12) fused into its final reduce."""
    if x.device.type == "cpu":
        return fcm_sweep_ref(x, w, centers, m)
    out = _launch(x, w, centers, m, normalize=True)
    fcm_sweep_cuda.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _batched_plan(device_index: int, tenants: int, n: int, d: int, c: int):
    """(tile rows, row splits per tenant, shared-memory bytes) for one
    tenant-stacked shape on one card."""
    t, splits, smem = _I(0), _I(0), _I(0)
    _check(_batched_lib().fcm_batched_plan(
        tenants, n, d, c, BLOCK, ctypes.byref(t), ctypes.byref(splits),
        ctypes.byref(smem)), "fcm_batched_plan", "fcm_batched")
    if t.value == 0:
        raise ValueError(
            f"fcm_batched kernel: C*d = {c}*{d} centers do not fit in "
            "shared memory; a C-tiled variant is on the roadmap")
    return t.value, splits.value, smem.value


def _launch_batched(x, w, centers, m, normalize: bool):
    _check_inputs("fcm_batched", x, w, centers, (3, 2, 3))
    tenants, n, d = x.shape
    c = centers.shape[1]
    if (tuple(w.shape) != (tenants, n) or centers.shape[0] != tenants
            or centers.shape[2] != d or min(tenants, n, c, d) == 0):
        raise ValueError(
            "fcm_batched kernel: shapes x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, centers "
            f"{tuple(centers.shape)} do not form (T, N, d), (T, N), "
            "(T, C, d) with T, N, C, d >= 1")
    if tenants >= 2 ** 31:
        raise ValueError(f"fcm_batched kernel: {tenants} tenants exceed the "
                         "grid's 2^31 - 1")
    dev = x.device
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    v = centers.to(torch.float32).contiguous()
    mt = _fuzzifiers(m, tenants, dev).contiguous()
    with torch.cuda.device(dev):
        t, splits, smem = _batched_plan(dev.index, tenants, n, d, c)
        part = torch.empty((tenants * splits, c * d + c + 1),
                           dtype=torch.float32, device=dev)
        out_v = torch.empty((tenants, c, d), dtype=torch.float32, device=dev)
        out_w = torch.empty((tenants, c), dtype=torch.float32, device=dev)
        out_q = torch.empty((tenants,), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _batched_lib().fcm_batched_accumulate(
            x.data_ptr(), w.data_ptr(), v.data_ptr(), mt.data_ptr(), tenants,
            n, d, c, t, splits, smem, BLOCK, part.data_ptr(),
            out_v.data_ptr(), out_w.data_ptr(), out_q.data_ptr(),
            int(normalize), stream)
    _check(err, "launch", "fcm_batched")
    return out_v, out_w, out_q


def fcm_accumulate_batched_cuda(x, w, centers, m=2.0):
    """Raw accumulators per tenant (v_num (T, C, d), w_i (T, C), q (T,))
    in one launch.  x: (T, N, d), w: (T, N) with zeros on phantom rows,
    centers: (T, C, d), m: a scalar or (T,)."""
    if x.device.type == "cpu":
        return fcm_accumulate_batched_ref(x, w, centers, m)
    out = _launch_batched(x, w, centers, m, normalize=False)
    fcm_accumulate_batched_cuda.launches += 1
    return out


def fcm_sweep_batched_cuda(x, w, centers, m=2.0):
    """Tenant-stacked sweep (v_new, w_i, q) in one launch, the per-tenant
    normalization fused into the kernel's final reduce."""
    if x.device.type == "cpu":
        return fcm_sweep_batched_ref(x, w, centers, m)
    out = _launch_batched(x, w, centers, m, normalize=True)
    fcm_sweep_batched_cuda.launches += 1
    return out


fcm_accumulate_cuda.launches = 0
fcm_sweep_cuda.launches = 0
fcm_accumulate_batched_cuda.launches = 0
fcm_sweep_batched_cuda.launches = 0
