"""Calibrated backend auto-selection — the cache behind ``"auto"``.

Counterpart of `repro.perf.calibrate`: its race rules on the CPU, the
kernel rule below on the card.  ``resolve_backend("auto", device=...,
shape=...)`` asks `calibrated_backend_name`, which runs a **one-shot
timed race** of every registered sweep backend at the request's shape
bucket on the request's device, persists the winner in the calibration
file (format, bucket rule and wipe/refresh story in the
`repro_torch.perf` package docstring), and answers from the in-process
memo → disk cache → fresh race, in that order.  The memo is keyed by
(device, bucket), so a CPU winner never answers a CUDA call.
`engine.backend.default_backend_name` (the device rule) is only the
fallback when calibration is disabled (``REPRO_AUTO_CALIBRATE=0``) or
the perf layer itself fails.

The race **gates on parity**: each candidate's sweep is checked against
the ``torch`` oracle on the race data, and a backend whose objective or
centers deviate beyond ``parity_rtol`` is disqualified however fast it
ran — that is how ``torch_bf16`` earns its place.  Near-ties go to the
incumbent (the 5 % dethrone margin).

On a CPU device these are the reference's rules: every backend may win,
the incumbent is the ``torch`` oracle, and a backend that raises is
recorded and loses.  On a CUDA device the port keeps its sweeps on its
hand-written kernels (`pick_winner`): every backend is timed, but only
the kernel backends (``SweepBackend.kernel``) may win, the incumbent is
the device rule's ``hopper``, and a kernel backend that fails parity
raises `KernelParityError` — a wrong kernel is a fault, not a loser —
which `resolve_backend` passes on.  A kernel backend that raises in the
race makes the race raise too (a kernel that cannot be built or launched
on the card raises; `resolve_backend` then warns once and takes the
device rule, whose ``hopper`` raises again at the sweep).
"""
from __future__ import annotations

import functools
import json
import os
import platform
import tempfile
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..device import resolve_device

FORMAT_VERSION = 1
CALIB_NAME = "calibration_torch.json"
ENV_DIR = "REPRO_CALIB_DIR"
ENV_DISABLE = "REPRO_AUTO_CALIBRATE"

# representative bucket when the caller has no shape in hand (the
# reference's t11 engine-bench batch shape's bucket)
DEFAULT_SHAPE = (4096, 8, 16)
_RACE_N_CAP = 4096            # rows a race actually runs, however big
_N_LO, _N_HI = 256, 1 << 20   # the bucket clamp on n

_MEMO: Dict[Tuple[str, str], str] = {}   # (device, bucket_key) -> winner

DeviceLike = Union[str, torch.device]

__all__ = ["KernelParityError", "shape_bucket", "bucket_key", "race_shape",
           "race_backends", "pick_winner",
           "calibrated_backend_name", "calibration_dir",
           "calibration_path", "load_calibration", "store_calibration",
           "cached_peaks", "clear_memory_cache", "wipe", "device_key"]


# ------------------------------------------------------------- buckets ---

def _pow2_ceil(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length() if v > 1 else 1


def shape_bucket(n: int, c: int, d: int) -> Tuple[int, int, int]:
    """The shape-bucket rule: every dim rounds UP to the next power of
    two, n clamped to [256, 2**20] — one measured winner serves every
    shape in its bucket."""
    return (min(max(_pow2_ceil(n), _N_LO), _N_HI),
            _pow2_ceil(c), _pow2_ceil(d))


def bucket_key(bucket: Tuple[int, int, int]) -> str:
    return "n{}_c{}_d{}".format(*bucket)


def race_shape(bucket: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The shape a race actually runs: the bucket representative with n
    capped at 4096 rows, so a cold first ``"auto"`` stays cheap."""
    n, c, d = bucket
    return (min(n, _RACE_N_CAP), c, d)


def device_key(device: DeviceLike) -> str:
    """The memo's device part: ``cpu`` or ``cuda:<index>``."""
    dev = resolve_device(device)
    return "cpu" if dev.type == "cpu" else f"cuda:{dev.index}"


@functools.lru_cache(maxsize=None)
def _device_name(key: str) -> str:
    if key == "cpu":
        return platform.processor() or platform.machine() or "cpu"
    return torch.cuda.get_device_name(torch.device(key))


# ------------------------------------------------------------ the file ---

def calibration_dir() -> str:
    return os.environ.get(ENV_DIR) or os.path.join(
        os.getcwd(), ".cache", "perf")


def calibration_path(path: Optional[str] = None) -> str:
    return path if path is not None else os.path.join(
        calibration_dir(), CALIB_NAME)


def _registry_key(device: DeviceLike) -> dict:
    """The content key: a stored file is valid iff this dict matches."""
    from ..engine import backend as eb
    key = device_key(device)
    return {"format_version": FORMAT_VERSION,
            "device": key.split(":")[0],
            "device_name": _device_name(key),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backends": sorted(eb._REGISTRY)}


def load_calibration(path: Optional[str] = None, *,
                     device: DeviceLike = "cuda") -> dict:
    """The calibration dict, or a fresh empty one if the file is
    missing, corrupt, or keyed for another (device, torch, CUDA,
    backend set) — corruption means re-race, never a crash."""
    fresh = {"key": _registry_key(device), "winners": {}, "tiles": {},
             "peaks": None}
    try:
        with open(calibration_path(path)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return fresh
    if not isinstance(data, dict) or data.get("key") != fresh["key"]:
        return fresh
    for k, v in fresh.items():
        data.setdefault(k, v)
    return data


def store_calibration(data: dict, path: Optional[str] = None) -> str:
    """Atomic write (tmp + rename: a torn write leaves the old file or
    none, never garbage)."""
    target = calibration_path(path)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(target), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, target)
    return target


def clear_memory_cache() -> None:
    """Drop the in-process memos (disk cache untouched) — a fresh
    `calibrated_backend_name` or `tuned_blocks` then re-reads the
    file."""
    _MEMO.clear()
    from . import autotune
    autotune.forget()


def wipe(path: Optional[str] = None) -> None:
    """Delete the calibration file and the in-process memos — the next
    ``"auto"`` re-probes and re-races from scratch."""
    clear_memory_cache()
    try:
        os.remove(calibration_path(path))
    except OSError:
        pass


# ------------------------------------------------------------- the race --

class KernelParityError(RuntimeError):
    """A kernel backend disagreed with the ``torch`` oracle in a race on
    the card."""


def pick_winner(results: dict, *, device_type: str,
                dethrone_margin: float = 0.05) -> str:
    """The race's winner from per-backend ``results`` (``us``,
    ``parity_ok``).  The fastest eligible backend wins unless it beats
    the incumbent's time by no more than ``dethrone_margin``.  On the
    CPU every parity-true backend is eligible and ``torch`` is the
    incumbent; on a CUDA device only the kernel backends are, ``hopper``
    is the incumbent, and a kernel backend without parity raises
    `KernelParityError`."""
    from ..engine import backend as eb
    if device_type == "cuda":
        kernels = sorted(k for k in results if eb._REGISTRY[k].kernel)
        bad = {k: results[k] for k in kernels
               if not results[k].get("parity_ok")}
        if bad:
            raise KernelParityError(f"kernel backends disagree with the "
                                    f"torch oracle: {bad}")
        eligible = {k: results[k] for k in kernels}
    else:
        eligible = {k: r for k, r in results.items() if r.get("parity_ok")}
    incumbent = eb.default_backend_name(device_type)
    winner = min(eligible, key=lambda k: eligible[k]["us"])
    if winner != incumbent and incumbent in eligible and \
            eligible[winner]["us"] > (1.0 - dethrone_margin) * \
            eligible[incumbent]["us"]:
        winner = incumbent
    return winner


def race_backends(shape: Tuple[int, int, int], *, m: float = 2.0,
                  warmup: int = 1, iters: int = 2,
                  parity_rtol: float = 2e-2, dethrone_margin: float = 0.05,
                  device: DeviceLike = "cuda") -> Tuple[str, dict]:
    """Time every registered backend's sweep at ``shape`` on ``device``;
    return (winner_name, per-backend results).

    A backend is eligible only if its (centers, objective) agree with
    the ``torch`` oracle within ``parity_rtol`` on the race data;
    `pick_winner` says which backends may win on which device.  Near-ties
    go to the incumbent: a challenger must beat its time by more than
    ``dethrone_margin`` (5 %) to win, so race jitter cannot flip "auto"
    for a speedup inside the noise floor."""
    from ..engine import backend as eb
    from .microbench import time_fn
    from .roofline import _race_data

    dev = resolve_device(device)
    n, c, d = shape
    x, w, v = _race_data(n, c, d, device=dev)
    ref_v, _, ref_q = (a.cpu().numpy() for a in
                       eb.get_backend("torch").sweep(x, w, v, m))
    ref_scale = float(np.max(np.abs(ref_v))) or 1.0

    results: dict = {}
    for name in sorted(eb._REGISTRY):
        be = eb._REGISTRY[name]

        def fn(a, b, v0, _be=be):
            return _be.sweep(a, b, v0, m)

        try:
            got_v, _, got_q = (a.cpu().numpy() for a in fn(x, w, v))
            dv = float(np.max(np.abs(got_v - ref_v))) / ref_scale
            dq = abs(float(got_q) - float(ref_q)) / (abs(float(ref_q))
                                                     or 1.0)
            ok = bool(np.isfinite(got_v).all()
                      and dv <= parity_rtol and dq <= parity_rtol)
            t = time_fn(fn, x, w, v, warmup=max(warmup - 1, 0),
                        iters=iters)
            results[name] = {"us": t * 1e6, "parity_ok": ok,
                             "center_rel_err": dv, "objective_rel_err": dq}
        except Exception as e:
            if dev.type == "cuda" and be.kernel:
                raise
            results[name] = {"error": repr(e), "parity_ok": False}
    return pick_winner(results, device_type=dev.type,
                       dethrone_margin=dethrone_margin), results


def calibrated_backend_name(shape: Optional[Tuple[int, int, int]] = None,
                            *, device: DeviceLike = "cuda",
                            path: Optional[str] = None,
                            refresh: bool = False,
                            m: float = 2.0) -> Optional[str]:
    """The measured winner for ``shape``'s bucket on ``device`` — memo →
    disk → race.

    Returns None when measured selection is disabled
    (``REPRO_AUTO_CALIBRATE=0``); `resolve_backend` then falls back to
    the device rule.  ``refresh=True`` forces a re-race of this one
    bucket (the file's other entries survive)."""
    if os.environ.get(ENV_DISABLE, "1") in ("0", "false", "no"):
        return None
    dkey = device_key(device)
    bucket = shape_bucket(*(shape if shape is not None else DEFAULT_SHAPE))
    key = bucket_key(bucket)
    if not refresh:
        if (dkey, key) in _MEMO:
            return _MEMO[dkey, key]
        data = load_calibration(path, device=dkey)
        hit = data["winners"].get(key)
        if hit:
            _MEMO[dkey, key] = hit["winner"]
            return hit["winner"]
    winner, results = race_backends(race_shape(bucket), m=m, device=dkey)
    times = {k: round(r["us"], 1) for k, r in results.items() if "us" in r}
    parity = {k: bool(r.get("parity_ok")) for k, r in results.items()}
    obs.event("perf.calibrate.race", bucket=key, winner=winner,
              times_us=times, parity=parity, device=dkey)
    data = load_calibration(path, device=dkey)   # keep concurrent winners
    data["winners"][key] = {
        "winner": winner,
        "raced_shape": list(race_shape(bucket)),
        "times_us": times,
        "parity": parity,
        "errors": {k: r["error"] for k, r in results.items()
                   if "error" in r},
    }
    store_calibration(data, path)
    _MEMO[dkey, key] = winner
    return winner


# -------------------------------------------------------- probed peaks ---

def cached_peaks(*, path: Optional[str] = None, refresh: bool = False,
                 device: DeviceLike = "cuda", **probe_kw) -> dict:
    """The device's probed peaks, cached in the calibration file under
    ``"peaks"`` (same content-key invalidation as the winners)."""
    data = load_calibration(path, device=device)
    if data["peaks"] and not refresh:
        return data["peaks"]
    from . import microbench
    peaks = microbench.probe_peaks(device=device, **probe_kw)
    data = load_calibration(path, device=device)
    data["peaks"] = peaks
    store_calibration(data, path)
    return peaks
