"""Launch-plan autotuning for the Hopper sweep kernels.

Counterpart of `repro.perf.autotune`.  The reference searches its Pallas
kernel's (tile_n × lane) grid; the port searches the free choices its
own launch plan makes for a bucket (`repro_torch.kernels.fcm_update.
PlanChoice`), never the path itself (the path decides which kernel can
hold V):

  * the rows path: records per split (``SPLIT_GRID``);
  * the tile path: records per tile (``TILE_GRID``), single-model or
    tenant-stacked (there a scale of each tenant's tile cap);
  * the C-tiled path: the membership's record tile (``CT_TILE_GRID``,
    between ``CT_TILES``) × its d-splits (``DSPLIT_GRID``);
  * the wide path: records per tile (``TILE_GRID``) × the CTAs its d is
    split across (``DSPLIT_GRID``);
  * the first tenant-stacked version, which the plan keeps only for many
    small tenants past the tile kernel's micro-tiles: nothing to choose.

Each choice is a scale of the plan's own pick, so one tuned choice
serves every shape of its bucket.  The search first asks whether the
bucket's launch is worth tuning: it times the untuned plan on the card
(`_time_choice`: a CUDA graph of back-to-back launches) and as a
converge loop pays for it (`_time_launch`: the host clock around a
launch and its synchronize, after which the loop reads ΔV²).  Where the
card's time is under ``HOST_BOUND`` of the synchronized launch, the
launch is host-bound: no choice can make the loop much faster, a changed
order of the sums can still move a converge loop's stop, and the bucket
keeps its untuned plan.  Elsewhere each distinct plan is timed on the
card, and a choice replaces the untuned plan, the incumbent, only by
beating its time by more than the race's 5 % dethrone margin.  The best
choice per (device, bucket) is persisted in the calibration file under
``"tiles"`` (same format, invalidation and wipe story as the backend
race — the `repro_torch.perf` package docstring).

Where the reference tunes at the race shape (4096 rows at most), the
port tunes at its bucket's own N (the whole bucket representative, its
records capped at ``TUNE_BYTES``): a plan's choices depend on N — at
4096 rows the plan spreads few records over the card, at 2²⁰ it fills
it — so a choice measured at 4096 rows would not carry to the bucket's
sizes.  A tenant-stacked bucket (``tenants=T``) is keyed and tuned by
(T, N, C, d), each rounded up to a power of two.

The wrappers consult `tuned_blocks` (a cached-only lookup: memo → disk,
never a search) at each launch, so a tuned machine runs the tuned plans
everywhere without a call-site change, and an untuned bucket keeps the
untuned plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from .. import obs
from ..device import resolve_device

SPLIT_GRID = (1.0, 0.25, 0.5, 2.0, 4.0)
TILE_GRID = (1.0, 0.25, 0.5, 2.0)
CT_TILE_GRID = (1.0, 0.5, 2.0)
DSPLIT_GRID = (1.0, 0.25, 0.5, 2.0, 4.0)
TUNE_BYTES = 1 << 30     # most bytes of records the tuned shape holds
HOST_BOUND = 0.5         # card share of a synchronized launch below which
                         # a bucket keeps its untuned plan

_MEMO: Dict[Tuple[str, str], Optional[dict]] = {}  # (device, key) -> cfg
# Bumped whenever _MEMO changes, so that a caller caching lookups per
# shape (the kernel wrappers) knows to look again.
generation = 0

DeviceLike = Union[str, torch.device]

__all__ = ["SPLIT_GRID", "TILE_GRID", "CT_TILE_GRID", "DSPLIT_GRID",
           "TUNE_BYTES", "HOST_BOUND", "choice_grid", "tile_key",
           "tune_shape", "tune_sweep_blocks", "tuned_blocks"]


def forget() -> None:
    """Drop the in-process memo (the calibration file is untouched)."""
    global generation
    _MEMO.clear()
    generation += 1


def _pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length() if v > 1 else 1


def tile_key(shape: Optional[Tuple[int, int, int]] = None,
             tenants: Optional[int] = None) -> str:
    """The ``"tiles"`` entry of ``shape=(n, c, d)``: the backend race's
    bucket key for a single-model sweep, ``t<T>_n<N>_c<C>_d<d>`` (each a
    power of two) for a tenant-stacked one."""
    from .calibrate import DEFAULT_SHAPE, bucket_key, shape_bucket
    n, c, d = shape if shape is not None else DEFAULT_SHAPE
    if tenants is None:
        return bucket_key(shape_bucket(n, c, d))
    return "t{}_n{}_c{}_d{}".format(_pow2(tenants), _pow2(n), _pow2(c),
                                    _pow2(d))


def tune_shape(shape: Optional[Tuple[int, int, int]] = None,
               tenants: Optional[int] = None) -> Tuple[int, ...]:
    """The shape a search times: the bucket's representative, (n, c, d)
    or (T, n, c, d), with its records capped at ``TUNE_BYTES`` (N first,
    never below the race's 4096 rows; then T)."""
    from .calibrate import DEFAULT_SHAPE, shape_bucket
    n, c, d = shape if shape is not None else DEFAULT_SHAPE
    if tenants is None:
        n, c, d = shape_bucket(n, c, d)
        return (min(n, max(4096, TUNE_BYTES // (4 * d))), c, d)
    t, n, c, d = _pow2(tenants), _pow2(n), _pow2(c), _pow2(d)
    return (max(1, min(t, TUNE_BYTES // (4 * n * d))), n, c, d)


def choice_grid(path: str) -> list:
    """The `PlanChoice`s searched on ``path``, the untuned one first."""
    from ..kernels.fcm_update import PlanChoice
    if path == "rows":
        return [PlanChoice(split=s) for s in SPLIT_GRID]
    if path == "tile":
        return [PlanChoice(tile=s) for s in TILE_GRID]
    if path == "ctiled":
        return [PlanChoice(tile=t, dsplit=s) for t in CT_TILE_GRID
                for s in DSPLIT_GRID]
    if path == "wide":
        return [PlanChoice(tile=t, dsplit=s) for t in TILE_GRID
                for s in DSPLIT_GRID]
    return [PlanChoice()]


def _dkey(device) -> str:
    if isinstance(device, torch.device) and device.index is not None:
        return f"{device.type}:{device.index}"
    from .calibrate import device_key
    return device_key(device)


def _planner(dev: torch.device):
    """``plan(shape, choice)`` → the launch plan on ``dev``'s card, for
    (n, c, d) or (T, n, c, d).  The launch plan is the card's alone: a
    CPU device raises."""
    if dev.type != "cuda":
        raise ValueError("autotuning times the Hopper kernels' launch "
                         f"plans on a CUDA device, not {dev}")
    from ..kernels import fcm_update as fu

    def plan(shape, choice):
        if len(shape) == 3:
            n, c, d = shape
            return fu._plan(dev.index, n, d, c, choice)
        t, n, c, d = shape
        return fu._batched_plan(dev.index, t, n, d, c, choice)
    return plan


def _tune_data(shape, dev, seed: int = 0):
    """Records N(0, 1), weights U(0.5, 2) and centers N(0, 1) at the
    tuned shape, drawn on the device (a tuned shape holds up to
    ``TUNE_BYTES`` of records)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if len(shape) == 3:
        n, c, d = shape
        lead = ()
    else:
        t, n, c, d = shape
        lead = (t,)
    x = torch.randn(lead + (n, d), generator=g, device=dev)
    w = 0.5 + 1.5 * torch.rand(lead + (n,), generator=g, device=dev)
    v = torch.randn(lead + (c, d), generator=g, device=dev)
    return x, w, v


def _sweep(choice, data, m: float):
    """One normalized sweep on ``choice`` through the wrappers' private
    entry, so the kernels' launch counts stay the main path's."""
    from ..kernels import fcm_update as fu
    launch = fu._launch if data[0].dim() == 2 else fu._launch_batched

    def sweep(x, w, v):
        return launch(x, w, v, m, True, choice)
    return sweep


def _time_launch(choice, data, m: float, iters: int) -> float:
    """Median seconds of one synchronized sweep (`microbench.time_fn`,
    two warm-up launches that build, plan and allocate): what a converge
    loop, which reads ΔV² after every sweep, pays per sweep."""
    from .microbench import time_fn
    return time_fn(_sweep(choice, data, m), *data, warmup=2, iters=iters)


_GRAPH_LAUNCHES = 20
_STREAMS: Dict[int, torch.cuda.Stream] = {}   # device index -> side stream


def _time_choice(choice, data, m: float, iters: int) -> float:
    """Seconds of one sweep on ``choice`` on the card: CUDA events around
    the replay of a CUDA graph of ``_GRAPH_LAUNCHES`` back-to-back
    launches, divided by their count, the median of ``iters`` replays —
    the card's time, without the host's issue cost and its noise."""
    x = data[0]
    sweep = _sweep(choice, data, m)
    stream = _STREAMS.get(x.device.index)
    if stream is None:
        stream = _STREAMS[x.device.index] = torch.cuda.Stream(x.device)
    stream.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(stream):
        sweep(*data)                       # builds, plans, allocates
        sweep(*data)
    torch.cuda.current_stream(x.device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(_GRAPH_LAUNCHES):
            sweep(*data)
    graph.replay()
    times = []
    for _ in range(max(iters, 1)):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / _GRAPH_LAUNCHES)
    del graph
    times.sort()
    return times[len(times) // 2]


def _label(choice) -> str:
    return "split{}_tile{}_dsplit{}".format(choice.split, choice.tile,
                                           choice.dsplit)


def _plan_fields(plan) -> dict:
    return {"path": plan.path, "grid": plan.grid, "rows": plan.rows,
            "splits": plan.splits, "tile": plan.tile,
            "dsplits": plan.dsplits}


def tune_sweep_blocks(shape: Optional[Tuple[int, int, int]] = None, *,
                      tenants: Optional[int] = None,
                      device: DeviceLike = "cuda",
                      path: Optional[str] = None, m: float = 2.0,
                      iters: int = 5, dethrone_margin: float = 0.05,
                      refresh: bool = False) -> dict:
    """Search the launch-plan choices for ``shape``'s bucket (of a
    tenant-stacked sweep when ``tenants`` is given) on ``device``;
    persist and return the best — the untuned plan where the bucket's
    launch is host-bound or no choice beats its card time by more than
    ``dethrone_margin``: ``{"choice": {...}, "plan": {...},
    "untuned_plan": {...}, "times_us": {...} (card µs per plan timed),
    "untuned_us": ..., "tuned_us": ..., "launch_us": ... (synchronized),
    "host_bound": ..., "tuned_shape": [...]}``.  Cached per bucket — a
    second call is a lookup unless ``refresh=True``."""
    from .calibrate import load_calibration, store_calibration
    dev = resolve_device(device)
    dkey = _dkey(dev)
    key = tile_key(shape, tenants)
    if not refresh:
        hit = tuned_blocks(shape, tenants=tenants, device=dev, path=path)
        if hit is not None:
            return hit
    plan_of = _planner(dev)
    tshape = tune_shape(shape, tenants)
    untuned = plan_of(tshape, None)
    candidates, seen = [], set()
    for choice in choice_grid(untuned.path):
        plan = plan_of(tshape, choice)
        if plan not in seen:
            seen.add(plan)
            candidates.append((choice, plan))
    data = _tune_data(tshape, dev)
    untuned_t = _time_choice(candidates[0][0], data, m, iters)
    launch_t = _time_launch(candidates[0][0], data, m, iters)
    host_bound = untuned_t < HOST_BOUND * launch_t
    times: Dict[str, float] = {_label(candidates[0][0]):
                               round(untuned_t * 1e6, 2)}
    best, best_t = candidates[0], untuned_t
    for choice, plan in ([] if host_bound else candidates[1:]):
        t = _time_choice(choice, data, m, iters)
        times[_label(choice)] = round(t * 1e6, 2)
        if t < best_t and t < (1.0 - dethrone_margin) * untuned_t:
            best, best_t = (choice, plan), t
    choice, plan = best
    cfg = {"choice": dataclasses.asdict(choice), "plan": _plan_fields(plan),
           "untuned_plan": _plan_fields(untuned), "times_us": times,
           "untuned_us": round(untuned_t * 1e6, 2),
           "tuned_us": round(best_t * 1e6, 2),
           "launch_us": round(launch_t * 1e6, 2), "host_bound": host_bound,
           "tuned_shape": list(tshape)}
    obs.event("perf.autotune.tuned", bucket=key, device=dkey,
              choice=cfg["choice"], times_us=times)
    calib = load_calibration(path, device=dev)
    calib["tiles"][key] = cfg
    store_calibration(calib, path)
    global generation
    _MEMO[dkey, key] = cfg
    generation += 1
    return cfg


def tuned_blocks(shape: Optional[Tuple[int, int, int]] = None, *,
                 tenants: Optional[int] = None, device: DeviceLike = "cuda",
                 path: Optional[str] = None) -> Optional[dict]:
    """Cached-only lookup of the tuned choice for ``shape``'s bucket on
    ``device``: the in-process memo, then the calibration file.  Returns
    None when the bucket has never been tuned — the plan keeps its own
    picks.  Never launches a search, so a kernel launch stays cheap and
    free of side effects."""
    dkey = _dkey(device)
    key = tile_key(shape, tenants)
    if (dkey, key) in _MEMO:
        return _MEMO[dkey, key]
    from .calibrate import load_calibration
    cfg = load_calibration(path, device=dkey)["tiles"].get(key)
    _MEMO[dkey, key] = cfg
    return cfg
