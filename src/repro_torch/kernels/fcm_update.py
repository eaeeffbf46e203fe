"""The Hopper FCM accumulation kernel's wrappers and their plain versions.

Counterpart of `repro.kernels.fcm_update` (the Pallas TPU kernel) and
`repro.kernels.ref` (its oracles).  The kernel is CUDA C++ for ``sm_90a``
in ``csrc/fcm_accumulate.cu``; its source note says what it replaces,
what bounds it and how it is laid out.

* ``fcm_accumulate_cuda`` / ``fcm_sweep_cuda`` — the wrappers.  A CUDA
  tensor launches the kernel (or raises); a CPU tensor takes the plain
  version.  Each counts its kernel launches in its ``launches``
  attribute.
* ``fcm_accumulate_ref`` / ``fcm_sweep_ref`` — the plain PyTorch
  versions, written as `repro.kernels.ref` writes its oracles (the
  direct ‖x−v‖², not the kernel's expansion).
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


def _check(err: int, what: str) -> None:
    if err:
        msg = _lib().fcm_error_string(err).decode()
        raise RuntimeError(f"fcm_accumulate kernel: {what} failed with CUDA "
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


def _launch(x, w, centers, m: float, normalize: bool):
    if x.device.type != "cuda":
        raise ValueError(f"fcm_accumulate kernel: x on {x.device}, not CUDA")
    for name, a, dim in (("x", x, 2), ("w", w, 1), ("centers", centers, 2)):
        if a.device != x.device:
            raise ValueError(f"fcm_accumulate kernel: {name} on {a.device}, "
                             f"x on {x.device}")
        if not a.is_floating_point():
            raise TypeError(f"fcm_accumulate kernel: {name} has dtype "
                            f"{a.dtype}, expected a floating type")
        if a.dim() != dim:
            raise ValueError(f"fcm_accumulate kernel: {name} has shape "
                             f"{tuple(a.shape)}, expected {dim} dims")
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


fcm_accumulate_cuda.launches = 0
fcm_sweep_cuda.launches = 0
