"""Multi-pass out-of-core sweeps — the engine's raw-accumulate entry
driven over chunked batches.

Counterpart of `repro.core.outofcore`.  When the dataset lives in a
`repro_torch.data.cache.ChunkStore` bigger than device memory, every FCM
iteration streams each fixed-size batch through the backend's
``accumulate`` entry — un-normalized (v_num, w_i, q) sums that add
elementwise across batches (`fcm_accumulate_cuda`, K1, under the
``hopper`` backends) — and normalizes once per iteration.  The
per-batch sums add on the device in batch order, and the loop reads one
number on the host per pass, the ΔV² of its stopping test.  Phantom
zero-weight padding rows contribute nothing, so chunked results match
the monolithic sweep up to float32 summation order.

``batches_factory`` arguments are zero-arg callables returning a fresh
``(x, w)`` batch iterable of numpy arrays — a multi-pass fit re-iterates
the store once per iteration, which is exactly the access pattern the
chunk cache (mmap re-reads, no re-parse) makes cheap;
`repro_torch.data.plane` provides the factories (`shard_batches` /
`batched`).

**Host→device staging** (the part the reference leaves to XLA): on a
CUDA device the batches — read-only ``np.memmap`` views of the store's
chunk files — go to the card through a `StagingRing`: each batch is
copied into a pinned host buffer, then ``non_blocking`` onto the card on
a copy stream, two slots in turn, so the host's read of batch k+1 and
its copy overlap the kernel on batch k.  On a CPU device the batches go
through plainly, one host copy each (a read-only memmap is never handed
to `torch.from_numpy`).

Instrumentation (`repro_torch.obs`, the reference's names): an
``engine.sweep`` span around each batch's accumulate call (on the card
it times the launch: no span synchronizes), and under `obs.enabled()`
one ``engine.fit.iter`` event per pass of `ooc_fcm` with the pass's
objective and center shift, read back in the one device→host copy per
pass that the stopping test already makes.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..device import as_real, resolve_device
from ..engine import resolve_backend
from ..engine.backend import _D2_FLOOR, BackendLike
from .fcm import FCMResult

BatchIterable = Iterable[Tuple[np.ndarray, np.ndarray]]
BatchFactory = Callable[[], BatchIterable]

# out-of-core fits are large by definition: when resolving "auto" the
# row count is unknowable up front, so race in a big-n shape bucket
_N_LO_HINT = 1 << 17


@functools.lru_cache(maxsize=64)
def _accumulator(be, m: float):
    return lambda x, w, v: be.accumulate(x, w, v, m)


def make_accumulator(backend: BackendLike, m: float, *,
                     device: Union[str, torch.device] = "cuda"):
    """The raw-accumulate dispatch of one (backend, m) — cached, so every
    shard, pass and fit with the same signature shares one closure
    (backends are registry singletons, hence hashable keys).  Nothing is
    compiled: the kernel is built at its first launch.  ``device`` only
    resolves ``backend`` None/"auto"."""
    return _accumulator(resolve_backend(backend, device=device), float(m))


class _Slot:
    """One ring slot: pinned host and device buffers for x and w, the
    event of its last host→device copy and that of its last use."""

    def __init__(self, dev: torch.device, rows: int, dim: int):
        self.shape = (rows, dim)
        self.host_x = torch.empty((rows, dim), dtype=torch.float32,
                                  pin_memory=True)
        self.host_w = torch.empty((rows,), dtype=torch.float32,
                                  pin_memory=True)
        self.dev_x = torch.empty((rows, dim), dtype=torch.float32,
                                 device=dev)
        self.dev_w = torch.empty((rows,), dtype=torch.float32, device=dev)
        self.copied = torch.cuda.Event()
        self.used = torch.cuda.Event()


class StagingRing:
    """Two-slot host→device staging of (x, w) batches onto one card.

    Batch k goes through slot k % 2:

    1. the host waits for the slot's last copy (its ``copied`` event)
       before it refills the slot's pinned buffers, so a copy in flight
       never reads bytes being overwritten;
    2. the host copies the batch (typically a read-only memmap view)
       into the pinned buffers;
    3. the copy stream waits for the slot's last use (its ``used``
       event), copies pinned → device ``non_blocking`` and records
       ``copied``;
    4. the caller's stream waits for ``copied`` before the batch is
       handed out, so no kernel reads the device slot before its copy;
       when the caller asks for the next batch, ``used`` is recorded on
       its stream behind the work it enqueued on this one.

    A handed-out batch is valid until the caller asks for the batch two
    further on, which reuses its slot.  The ring counts what it did:
    ``batches``, ``h2d_bytes``, ``iter_s`` (host seconds in the batch
    iterator: opening chunk memmaps, re-slicing, padding the tail),
    ``host_s`` (host seconds copying batches into pinned memory, page-ins
    of the memmap included) and ``wait_s`` (host seconds waiting for a
    slot); with ``timing=True`` it also records CUDA events around each
    copy, summed by `h2d_seconds`.  Pinned memory, a copy stream and the card
    are required: there is no pageable or synchronous fallback.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda", *,
                 timing: bool = False):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"StagingRing stages onto a CUDA device, not "
                             f"{self.device}")
        self.copy_stream = torch.cuda.Stream(device=self.device)
        self.timing = timing
        self._slots = [None, None]
        self._k = 0
        self._copy_events = []
        self.batches = self.h2d_bytes = 0
        self.iter_s = self.host_s = self.wait_s = 0.0

    def _slot(self, rows: int, dim: int) -> _Slot:
        i = self._k % 2
        self._k += 1
        slot = self._slots[i]
        if slot is None or slot.shape != (rows, dim):
            if slot is not None:
                # A new batch shape: let every copy and kernel on the old
                # buffers finish before they are released.
                torch.cuda.synchronize(self.device)
            slot = self._slots[i] = _Slot(self.device, rows, dim)
        return slot

    def stage(self, batches: BatchIterable
              ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield each (x, w) numpy batch as (x, w) float32 tensors on the
        card, staged as the class note says."""
        batches = iter(batches)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.iter_s += time.perf_counter() - t0
            if batch is None:
                return
            bx, bw = batch
            bx = np.asarray(bx)
            bw = np.asarray(bw)
            if bx.ndim != 2 or bw.shape != bx.shape[:1]:
                raise ValueError(f"batch shapes x {bx.shape}, w {bw.shape} "
                                 "do not form (n, d), (n,)")
            slot = self._slot(*bx.shape)
            t0 = time.perf_counter()
            slot.copied.synchronize()
            t1 = time.perf_counter()
            np.copyto(slot.host_x.numpy(), bx, casting="same_kind")
            np.copyto(slot.host_w.numpy(), bw, casting="same_kind")
            t2 = time.perf_counter()
            self.wait_s += t1 - t0
            self.host_s += t2 - t1
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(slot.used)
                if self.timing:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                slot.dev_x.copy_(slot.host_x, non_blocking=True)
                slot.dev_w.copy_(slot.host_w, non_blocking=True)
                if self.timing:
                    ev[1].record()
                    self._copy_events.append(ev)
                slot.copied.record()
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(slot.copied)
            self.batches += 1
            self.h2d_bytes += 4 * (bx.size + bw.size)
            try:
                yield slot.dev_x, slot.dev_w
            finally:
                slot.used.record(torch.cuda.current_stream(self.device))

    def h2d_seconds(self) -> float:
        """Card seconds of the copies staged since ``timing`` was set
        (synchronizes the copy stream)."""
        self.copy_stream.synchronize()
        return sum(s.elapsed_time(e) for s, e in self._copy_events) / 1e3


def _plain_batches(batches: BatchIterable, dev: torch.device):
    """The CPU device's batches: one host copy each, never a tensor over
    a (read-only) memmap."""
    for bx, bw in batches:
        yield (torch.tensor(np.asarray(bx), dtype=torch.float32, device=dev),
               torch.tensor(np.asarray(bw), dtype=torch.float32, device=dev))


def device_batches(batches: BatchIterable, device, ring=None):
    """``batches`` as tensors on ``device``: through ``ring`` (a new
    `StagingRing` when None) on a CUDA device, plainly on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _plain_batches(batches, dev)
    return (ring if ring is not None else StagingRing(dev)).stage(batches)


def ooc_accumulate(batches: BatchIterable, centers, m: float = 2.0, *,
                   backend: BackendLike = None, acc=None, ring=None,
                   device: Union[str, torch.device] = "cuda"):
    """One raw accumulation sweep over an (x, w) batch iterable.

    Returns the summed (v_num, w_i, q) accumulators, added on the device
    in batch order — normalization is the caller's (deferred, as
    everywhere in the engine).  ``ring`` shares a `StagingRing` across
    passes."""
    dev = resolve_device(device)
    acc = acc if acc is not None else make_accumulator(backend, m,
                                                       device=dev)
    v = as_real(centers, dev)
    v_num = w_i = q = None
    for x, w in device_batches(batches, dev, ring):
        with obs.span("engine.sweep"):
            vn, wi, qi = acc(x, w, v)
        if v_num is None:
            v_num, w_i, q = vn, wi, qi
        else:
            v_num, w_i, q = v_num + vn, w_i + wi, q + qi
    if v_num is None:
        raise ValueError("ooc_accumulate: empty batch stream")
    return v_num, w_i, q


def ooc_sweep(batches: BatchIterable, centers, m: float = 2.0, *,
              backend: BackendLike = None, acc=None, ring=None,
              device: Union[str, torch.device] = "cuda"):
    """One full out-of-core sweep: chunked accumulate + the single
    deferred normalization.  Returns (v_new, w_i, q)."""
    v_num, w_i, q = ooc_accumulate(batches, centers, m, backend=backend,
                                   acc=acc, ring=ring, device=device)
    return v_num / torch.clamp(w_i, min=_D2_FLOOR)[:, None], w_i, q


def ooc_fcm(
    batches_factory: BatchFactory,
    init_centers,
    *,
    m: float = 2.0,
    eps: float = 1e-6,
    max_iter: int = 1000,
    backend: BackendLike = None,
    acc=None,
    ring: Optional[StagingRing] = None,
    device: Union[str, torch.device] = "cuda",
) -> FCMResult:
    """Multi-pass (weighted) FCM over a re-iterable chunked batch
    stream — `repro_torch.core.fcm.fcm` for data that does not fit in
    memory.

    Each iteration is one pass over every batch through the raw
    accumulate entry with ONE normalization; the stopping rule and the
    final masses/objective sweep are the reference's exactly (max_i
    ‖ΔV_i‖² ≤ ε, ``n_iter == 0`` always sweeps, then one more sweep for
    Eq. 6), so a store that *does* fit reproduces the in-memory fit up
    to float32 summation order.

    ``acc`` shares one `make_accumulator` dispatch and ``ring`` one
    `StagingRing` across calls (every shard of a fit); by default the
    fit makes its own ring, reused by all of its passes."""
    dev = resolve_device(device)
    v0 = as_real(init_centers, dev)
    be = resolve_backend(backend, device=dev,
                         shape=(_N_LO_HINT, v0.shape[0], v0.shape[1]))
    acc = acc if acc is not None else make_accumulator(be, m)
    if ring is None and dev.type == "cuda":
        ring = StagingRing(dev)
    v = v_prev = v0
    n_iter = 0
    q_pass = None
    while True:
        shift = torch.max(torch.sum((v - v_prev) ** 2, dim=-1))
        if q_pass is not None and obs.enabled():
            # the per-pass objective/center-shift series, read back with
            # the stopping test's ΔV² (the previous pass's shift)
            delta, objective = torch.stack(
                [shift, q_pass.to(shift.dtype)]).tolist()
            obs.event("engine.fit.iter", i=n_iter - 1, backend=be.name,
                      objective=objective, shift=delta)
        else:
            delta = float(shift)
        if not (n_iter < max_iter and (n_iter == 0 or delta > eps)):
            break
        v_new, _, q_pass = ooc_sweep(batches_factory(), v, m, acc=acc,
                                     ring=ring, device=dev)
        v_prev, v = v, v_new
        n_iter += 1
    _, w_final, q = ooc_sweep(batches_factory(), v, m, acc=acc, ring=ring,
                              device=dev)
    return FCMResult(v, w_final, n_iter, q)
