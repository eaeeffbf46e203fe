"""Stream sources — the ingestion side of `repro_torch.stream`.

The port's own copy of `repro.data.stream` (numpy-only apart from
`stream_loader`, which wraps the port's `ShardedLoader`).  BigFCM's
mapper reads HDFS splits; the streaming subsystem reads *unbounded*
chunk sequences.  A source is simply an iterator of ``(n_i, d)`` float
arrays:

  * ``iterator_source``  — adapt any in-process iterable (generators,
    Kafka-consumer-style cursors) with optional re-chunking.
  * ``replay_source``    — replay a materialized array, or a cached
    `ChunkStore` off its mmap, as a stream (backfill / deterministic
    regression runs), optionally shuffled per epoch.
  * ``socket_sim_source``— a network-socket simulator: a producer thread
    pushes chunks at a configurable arrival rate with jitter; the
    consumer blocks like a ``recv``.

``stream_loader`` drops any source into `ShardedLoader` so a stream gets
the batch pipeline's prefetch thread, fixed-shape phantom-padded
batches and pinned staging onto the card.

**Event time.**  Every source optionally carries a parallel
``timestamps`` channel: a timestamped source yields ``(x, ts)`` pairs
where ``ts`` is a per-record ``(n_i,)`` float64 array of *event* times.
``stamp_source`` retrofits event times onto a plain source, and
``out_of_order_source`` delivers an event-time-ordered stream out of
order within a bounded skew.  Timestamps ride next to the record
arrays, NOT through ``stream_loader`` (its channels are (records,
point weights)); event-time streams feed
``StreamingBigFCM.ingest(x, ts=...)`` directly.

Every source yields the same chunks as its reference counterpart for
the same inputs and seed.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import (Callable, Iterable, Iterator, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from .cache import ChunkStore
from .loader import ShardedLoader


def _split_item(item) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(x, ts) for a timestamped item, (x, None) for a plain array."""
    if isinstance(item, tuple):
        x, ts = item
        return np.asarray(x), np.asarray(ts, np.float64).reshape(-1)
    return np.asarray(item), None


def iterator_source(it: Iterable, *, chunk_rows: Optional[int] = None,
                    dtype=np.float32) -> Iterator:
    """Adapt any iterable of array-likes into a chunk stream.

    With ``chunk_rows`` set, incoming arrays are re-chunked to exactly
    that many rows (tail carried over); otherwise chunks pass through
    at their native size.  Items may be plain arrays or ``(x, ts)``
    pairs — a timestamped input yields timestamped chunks, with the
    ``ts`` channel re-chunked in lockstep.
    """
    timestamped: Optional[bool] = None   # fixed by the first chunk

    def check_mode(ts) -> bool:
        nonlocal timestamped
        if timestamped is None:
            timestamped = ts is not None
        elif timestamped != (ts is not None):
            raise ValueError("iterator_source got a mix of timestamped "
                             "and plain chunks")
        return timestamped

    if chunk_rows is None:
        for item in it:
            x, ts = _split_item(item)
            if x.size:
                x = x.astype(dtype)
                yield (x, ts) if check_mode(ts) else x
        return
    buf: Optional[np.ndarray] = None
    tbuf: Optional[np.ndarray] = None
    for item in it:
        x, ts = _split_item(item)
        if not x.size:
            continue
        x = x.astype(dtype)
        check_mode(ts)
        buf = x if buf is None or not buf.size else np.concatenate([buf, x])
        if timestamped:
            tbuf = (ts if tbuf is None or not tbuf.size
                    else np.concatenate([tbuf, ts]))
        while buf.shape[0] >= chunk_rows:
            if timestamped:
                yield buf[:chunk_rows], tbuf[:chunk_rows]
                tbuf = tbuf[chunk_rows:]
            else:
                yield buf[:chunk_rows]
            buf = buf[chunk_rows:]
    if buf is not None and buf.shape[0]:
        yield (buf, tbuf) if timestamped else buf


def replay_source(x: Union[np.ndarray, ChunkStore], chunk_rows: int, *,
                  epochs: int = 1, shuffle: bool = False, seed: int = 0,
                  timestamps: Optional[np.ndarray] = None) -> Iterator:
    """Stream a materialized array — or a cached `ChunkStore` — in
    ``chunk_rows``-sized chunks.

    ``epochs > 1`` replays the data (shuffled per epoch when asked) —
    the backfill/regression-replay path of a streaming deployment.
    ``timestamps`` ((n,) event times parallel to the rows) turns the
    replay into a timestamped source yielding ``(chunk, ts_chunk)``
    pairs; the pairing survives shuffling.

    A `ChunkStore` replays **out-of-core**: chunks stream off the mmap
    instead of re-generating (or materializing) the dataset, and
    ``shuffle`` becomes a block shuffle — chunk order and rows within
    each chunk are permuted per epoch, rows never cross chunks.
    """
    if isinstance(x, ChunkStore):
        yield from _replay_store(x, chunk_rows, epochs=epochs,
                                 shuffle=shuffle, seed=seed,
                                 timestamps=timestamps)
        return
    x = np.asarray(x, np.float32)
    ts = (None if timestamps is None
          else np.asarray(timestamps, np.float64).reshape(-1))
    if ts is not None and ts.shape[0] != x.shape[0]:
        raise ValueError(f"timestamps length {ts.shape[0]} != records "
                         f"{x.shape[0]}")
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(x.shape[0]) if shuffle else None
        xe = x[order] if order is not None else x
        te = ts[order] if (order is not None and ts is not None) else ts
        for i in range(0, xe.shape[0], chunk_rows):
            if ts is None:
                yield xe[i:i + chunk_rows]
            else:
                yield xe[i:i + chunk_rows], te[i:i + chunk_rows]


def _replay_store(store: ChunkStore, chunk_rows: int, *, epochs: int,
                  shuffle: bool, seed: int,
                  timestamps: Optional[np.ndarray]) -> Iterator:
    """Replay a cached store chunk-by-chunk (see `replay_source`)."""
    ts = (None if timestamps is None
          else np.asarray(timestamps, np.float64).reshape(-1))
    if ts is not None and ts.shape[0] != store.n_rows:
        raise ValueError(f"timestamps length {ts.shape[0]} != records "
                         f"{store.n_rows}")
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = (rng.permutation(store.n_chunks) if shuffle
                 else range(store.n_chunks))

        def epoch_chunks():
            for c in order:
                x_c = np.asarray(store.chunk(int(c)), np.float32)
                off = int(store.offsets[int(c)])
                perm = (rng.permutation(x_c.shape[0]) if shuffle else None)
                if perm is not None:
                    x_c = x_c[perm]
                if ts is None:
                    yield x_c
                else:
                    t_c = ts[off:off + x_c.shape[0]]
                    yield x_c, (t_c[perm] if perm is not None else t_c)

        # one re-chunking pass per epoch, so each epoch ends with its
        # own short tail (matching the materialized-array semantics)
        yield from iterator_source(epoch_chunks(), chunk_rows=chunk_rows)


def stamp_source(source: Iterator, *, start: float = 0.0,
                 dt: float = 1.0) -> Iterator:
    """Retrofit event times onto a plain chunk stream: record ``k`` of
    the whole stream gets event time ``start + k·dt`` (arrival order ==
    event order, the in-order baseline the out-of-order wrapper
    perturbs)."""
    k = 0
    for chunk in source:
        x = np.asarray(chunk)
        ts = start + dt * np.arange(k, k + x.shape[0], dtype=np.float64)
        k += x.shape[0]
        yield x, ts


def out_of_order_source(source: Iterator, *, skew: float, seed: int = 0,
                        chunk_rows: Optional[int] = None) -> Iterator:
    """Deliver a timestamped, event-time-ordered stream out of order
    within a bounded skew — the test/chaos wrapper for event-time
    ingestion.

    Each record is re-keyed to ``ts + U(0, skew)`` and delivered in key
    order: a record can only be overtaken by records stamped less than
    ``skew`` event-time units after it, so every record arrives at most
    ``skew`` late relative to the max event time already delivered —
    exactly the disorder an ``allowed_lateness ≥ skew`` watermark
    absorbs with zero drops.  Requires the wrapped source's event times
    to be non-decreasing (e.g. `stamp_source` / `replay_source` output).
    Output chunks are ``chunk_rows`` rows (default: the first input
    chunk's size).
    """
    rng = np.random.default_rng(seed)
    pend_x = pend_ts = pend_key = None   # records waiting for delivery
    out_x: list = []
    out_ts: list = []
    out_n = 0

    def _flush(upto: float, final: bool):
        """Move pending records whose key is safe to deliver (no future
        record can have a smaller key) into the output buffer, sorted."""
        nonlocal pend_x, pend_ts, pend_key, out_n
        if pend_key is None:
            return
        ready = np.ones_like(pend_key, bool) if final else pend_key <= upto
        if not ready.any():
            return
        order = np.argsort(pend_key[ready], kind="stable")
        out_x.append(pend_x[ready][order])
        out_ts.append(pend_ts[ready][order])
        out_n += int(ready.sum())
        keep = ~ready
        pend_x, pend_ts, pend_key = (pend_x[keep], pend_ts[keep],
                                     pend_key[keep])

    def _emit(rows: int):
        nonlocal out_n
        x = np.concatenate(out_x)
        ts = np.concatenate(out_ts)
        while x.shape[0] >= rows:
            yield x[:rows], ts[:rows]
            x, ts = x[rows:], ts[rows:]
        out_x[:] = [x]
        out_ts[:] = [ts]
        out_n = x.shape[0]

    last_ts = -np.inf
    for item in source:
        x, ts = _split_item(item)
        if ts is None:
            raise ValueError("out_of_order_source needs a timestamped "
                             "source (wrap it with stamp_source)")
        if not x.size:
            continue
        if ts[0] < last_ts:
            raise ValueError("out_of_order_source input event times must "
                             "be non-decreasing")
        last_ts = float(ts[-1])
        chunk_rows = chunk_rows or x.shape[0]
        key = ts + rng.uniform(0.0, skew, size=ts.shape)
        pend_x = (x if pend_x is None else np.concatenate([pend_x, x]))
        pend_ts = (ts if pend_ts is None else np.concatenate([pend_ts, ts]))
        pend_key = (key if pend_key is None
                    else np.concatenate([pend_key, key]))
        # any future record has ts >= last_ts, hence key >= last_ts
        _flush(last_ts, final=False)
        if out_n >= chunk_rows:
            yield from _emit(chunk_rows)
    _flush(np.inf, final=True)
    if out_n:
        yield from _emit(chunk_rows or out_n)
        x, ts = out_x[0], out_ts[0]
        if x.shape[0]:
            yield x, ts


def socket_sim_source(chunks: Iterable, *,
                      rate_hz: Optional[float] = None,
                      jitter: float = 0.0, seed: int = 0,
                      depth: int = 8) -> Iterator:
    """Simulated socket: a producer thread delivers chunks into a bounded
    queue at ``rate_hz`` arrivals/sec (± uniform ``jitter`` fraction);
    ``rate_hz=None`` delivers as fast as the consumer drains.  Iterating
    blocks on the queue exactly like a blocking ``recv``.  Timestamped
    ``(x, ts)`` chunks pass through with their event-time channel intact.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    rng = np.random.default_rng(seed)

    def put(item) -> bool:
        """Bounded put that gives up when the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        period = 0.0 if rate_hz is None else 1.0 / rate_hz
        try:
            for c in chunks:
                if period:
                    time.sleep(period * (1.0 + jitter * rng.uniform(-1, 1)))
                x, ts = _split_item(c)
                x = x.astype(np.float32)
                if not put(("chunk", x if ts is None else (x, ts))):
                    return                  # consumer abandoned the stream
            put(("eos", None))
        except BaseException as e:  # surface upstream failure to consumer
            put(("error", e))

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            kind, item = q.get()
            if kind == "error":
                raise item
            if kind == "eos":
                return
            yield item
    finally:
        stop.set()                  # unblock + retire the producer thread


def stream_loader(source: Iterator[np.ndarray], batch_rows: int, *,
                  mesh=None, data_axes: Sequence[str] = ("data",),
                  prefetch: int = 2,
                  transform: Optional[Callable[[np.ndarray], np.ndarray]]
                  = None,
                  device: Union[str, torch.device] = "cuda"
                  ) -> ShardedLoader:
    """Wrap any source in the batch pipeline's ``ShardedLoader`` so the
    stream gets the same prefetch thread, fixed-shape phantom-padded
    batches, and staging onto ``device`` as offline data.  Streams are
    unbounded, so the loader runs in ``cache=False`` pass-through mode —
    nothing accretes into a chunk store (cache a stream explicitly with
    `ChunkStore.ingest` over a bounded slice if replay is wanted).
    On a device mesh each rank receives its ``P(data_axes)`` block of
    every batch (`ShardedLoader`)."""
    return ShardedLoader(source, batch_rows, mesh=mesh,
                         data_axes=data_axes, prefetch=prefetch,
                         transform=transform, cache=False, device=device)
