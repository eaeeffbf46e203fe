"""Host→device data pipeline (the Hadoop "mapper" input side).

Counterpart of `repro.data.loader`.  Mirrored from the paper's mapper
(Alg. 3 lines 7–9): read records, strip separators and normalize on the
host (`parse_records`, `normalize`), and hand fixed-size batches to the
device.

`ShardedLoader` is a **re-iterable view over a
`repro_torch.data.cache.ChunkStore`** — the paper's node-local cache.
The first epoch consumes the raw source exactly once (parse → transform
→ float32), spilling fixed-size chunks into the store *while* batches
flow to the consumer; every later epoch streams straight from the store
(memory-mapped ``.npy`` chunks when a ``cache_dir`` is given), skipping
parsing entirely.  When the store fits under ``resident_bytes``, a
completed epoch leaves its batches device-resident and later epochs
replay them with zero host work.  ``cache=False`` is the unbounded-stream
mode (`repro_torch.data.stream.stream_loader`): single-use pass-through,
nothing is retained.

What happens where:
  * a prefetch thread reads and batches the source — fixed
    ``(batch_rows, d)`` batches with zero-weight phantom rows in the
    tail (`repro_torch.data.plane.batched`), so consumers never see
    ragged shapes — into a bounded queue;
  * on a CUDA device the consumer stages each batch through a
    `repro_torch.core.outofcore.StagingRing` (pinned host slots, a copy
    stream, event-ordered), so the host's copy of batch k+1 overlaps the
    work on batch k.  A batch handed out is one of the ring's two device
    slots: it stays valid until the consumer asks for the batch two
    further on (copy it to keep it; the resident cache does);
  * on the CPU device each batch is copied into a fresh tensor;
  * a failure in the source re-raises in the consumer, and a producer
    that dies without forwarding anything raises instead of hanging it.

**On a device mesh** (``mesh=``, a `repro_torch.mesh.make_mesh` mesh;
every rank iterates its own loader over the same source): each rank
receives its ``P(data_axes)`` row block of every padded global batch and
of its weights, phantom rows included, on its own device — the
reference's sharded placement, SPMD.  The (mesh, axes) pair is read once
per batch, so a batch and its weights never straddle two meshes.
`reshard` (the elastic re-mesh) retargets later batches, drops the
device-resident cache (it holds the old mesh's blocks; the chunk store
survives) and bumps the generation; a reshard landing mid-replay serves
the rest of that epoch from the store, placed for the new mesh.

Instrumentation (`repro_torch.obs`, the reference's names): the
producer's time blocked on a full queue (``data.loader.producer_stall_s``),
the queue depth the consumer finds (``data.loader.queue_depth``), and the
batches it takes from the queue or replays from the resident cache
(``data.loader.batches``, ``data.loader.resident_batches``).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from .. import obs
from ..core.outofcore import StagingRing, device_batches
from ..device import resolve_device
from ..mesh import rank_device, shard_rows
from .cache import ChunkStore, StoreWriter
from .plane import batched

_RESIDENT_BYTES_DEFAULT = 256 * 2 ** 20     # 256 MiB device-resident cap
_INGEST_LIMIT_DEFAULT = 2 ** 30             # 1 GiB in-memory ingest cap


def parse_records(lines: Sequence[str], *, sep: str = ",") -> np.ndarray:
    """Mapper lines 7–8: strip whitespace/separators → float records.

    Vectorized: the whole block goes through ``np.loadtxt``'s C
    tokenizer in one call.  Messy blocks (stray separators producing
    empty tokens) fall back to a bulk split-and-filter pass; ragged rows
    raise ValueError.
    """
    clean = [ln.replace(" ", "") for ln in lines if ln.strip()]
    if not clean:
        raise ValueError("parse_records: no records in block")
    try:
        # comments=None: a stray '#' line must be a parse error, not a
        # silently dropped row (row counts feed store/timestamp math)
        return np.loadtxt(clean, dtype=np.float32, delimiter=sep,
                          ndmin=2, comments=None)
    except ValueError:
        pass       # empty tokens / garbage — re-parse forgivingly below
    flat = np.asarray(sep.join(clean).split(sep))
    flat = flat[flat != ""]                      # drop empty tokens
    counts = {sum(1 for t in ln.split(sep) if t) for ln in clean}
    if len(counts) != 1 or 0 in counts:
        raise ValueError(f"parse_records: ragged block — rows carry "
                         f"{sorted(counts)} tokens")
    try:
        return flat.astype(np.float32).reshape(-1, counts.pop())
    except ValueError:
        raise ValueError("parse_records: unparseable block") from None


def normalize(x: np.ndarray) -> np.ndarray:
    """Min-max normalize per feature (the paper normalizes KDD99)."""
    lo, hi = x.min(axis=0), x.max(axis=0)
    return (x - lo) / np.maximum(hi - lo, 1e-12)


class _EpochIterator:
    """Wraps an epoch generator so the loader's epoch claim is released
    even when the iterator is discarded before its first ``next()`` (a
    never-started generator's finally would otherwise never run)."""

    def __init__(self, loader: "ShardedLoader", gen):
        self._loader = loader
        self._gen = gen
        self._released = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except BaseException:
            self._release()
            raise

    def close(self):
        self._gen.close()
        self._release()

    def _release(self):
        if not self._released:
            self._released = True
            self._loader._epoch_active = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ShardedLoader:
    """Feeds fixed-size batches ``(x (batch_rows, d), w (batch_rows,))``
    to one device, or each rank's block of them on a mesh (see the
    module note).

    ``source`` is a raw chunk iterator (numpy arrays of shape (n_i, d)),
    a materialized array, or an existing `ChunkStore`.  With
    ``cache=True`` (default) the loader is re-iterable: the raw source
    is parsed once into a `ChunkStore` (in memory, or spilled under
    ``cache_dir``) during the first epoch, and later epochs replay the
    store.  ``transform`` runs on raw source chunks exactly once, before
    caching; when ``source`` is already a ChunkStore the store is
    treated as raw and ``transform`` (if any) is applied per epoch.

    Without a ``cache_dir`` the store lives in host RAM; ingest fails
    loudly past ``ingest_limit_bytes`` (default 1 GiB) — pass
    ``cache_dir=`` to spill to disk, or ``cache=False`` to stream
    without retaining.  ``device`` is where batches land (default
    ``"cuda"``); on a mesh it is the rank's device (`rank_device`) and
    ``device`` is not read."""

    def __init__(self, source: Union[Iterator[np.ndarray], np.ndarray,
                                     ChunkStore],
                 batch_rows: int,
                 mesh=None,
                 data_axes: Sequence[str] = ("data",),
                 prefetch: int = 2,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None,
                 cache: bool = True,
                 cache_dir: Optional[str] = None,
                 chunk_rows: Optional[int] = None,
                 resident_bytes: int = _RESIDENT_BYTES_DEFAULT,
                 ingest_limit_bytes: int = _INGEST_LIMIT_DEFAULT,
                 device: Union[str, torch.device] = "cuda"):
        self.device = (rank_device(mesh) if mesh is not None
                       else resolve_device(device))
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.batch_rows = int(batch_rows)
        self.transform = transform
        self.prefetch = int(prefetch)
        self.cache_dir = cache_dir
        self.chunk_rows = int(chunk_rows or batch_rows)
        self.resident_bytes = int(resident_bytes)
        self.ingest_limit_bytes = (None if cache_dir is not None
                                   else int(ingest_limit_bytes))
        self._cache = bool(cache)
        self._store: Optional[ChunkStore] = None
        self._source: Optional[Iterator[np.ndarray]] = None
        self._store_is_raw = False     # apply transform per epoch?
        self._epoch_active = False
        self._device_cache: Optional[list] = None
        self._generation = 0           # bumped by reshard()
        self._ring: Optional[StagingRing] = None
        self._pump_thread: Optional[threading.Thread] = None
        if isinstance(source, ChunkStore):
            self._store = source
            self._store_is_raw = transform is not None
        elif isinstance(source, np.ndarray):
            self._source = iter([np.asarray(source)])
        else:
            self._source = iter(source)

    # -- cache state ---------------------------------------------------------

    @property
    def store(self) -> Optional[ChunkStore]:
        """The backing chunk cache (None until the first epoch finishes
        ingesting a raw source, or always in ``cache=False`` mode)."""
        return self._store

    @property
    def resident(self) -> bool:
        """True when epochs replay from the device-resident batch cache."""
        return self._device_cache is not None

    def reshard(self, mesh, data_axes: Sequence[str]):
        """Elastic re-mesh: later batches are this rank's blocks under the
        new mesh (the rank keeps its device).  The device-resident cache
        is dropped (it holds the old mesh's blocks); the chunk store
        survives untouched."""
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self._device_cache = None
        self._generation += 1

    # -- host side -----------------------------------------------------------

    def _pump(self, chunk_iter, q: queue.Queue,
              writer: Optional[StoreWriter], apply_transform: bool,
              stop: threading.Event):
        """Producer thread: chunks → (transform →) [store spill →]
        fixed batches → queue.  ANY failure is forwarded to the
        consumer instead of dying silently in the daemon thread; an
        abandoned epoch sets ``stop`` so the thread retires instead of
        blocking on a full queue forever."""
        def put(item) -> bool:
            t0 = time.perf_counter()
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    # time the producer spent blocked on a full queue:
                    # nonzero means the consumer is the bottleneck
                    obs.counter("data.loader.producer_stall_s").add(
                        time.perf_counter() - t0)
                    return True
                except queue.Full:
                    continue
            return False               # consumer abandoned the epoch

        try:
            def gen():
                for chunk in chunk_iter:
                    if apply_transform and self.transform is not None:
                        chunk = self.transform(chunk)
                    chunk = np.asarray(chunk, np.float32)
                    if writer is not None:
                        writer.append(chunk)
                    yield chunk
            for batch, w in batched(gen(), self.batch_rows):
                if not put(("batch", (batch, w))):
                    return
            if writer is not None:
                self._store = writer.finish()
            put(("eos", None))
        except BaseException as e:     # noqa: BLE001 — forwarded, re-raised
            put(("error", e))

    def _host_batches(self, q: queue.Queue, pump: threading.Thread,
                      status: dict):
        """The queue's (x, w) numpy batches until end of stream; sets
        ``status["done"]`` there, re-raises a forwarded failure."""
        while True:
            obs.gauge("data.loader.queue_depth").set(q.qsize())
            try:
                kind, payload = q.get(timeout=1.0)
            except queue.Empty:
                # The producer forwards every failure as an "error" item;
                # a thread that died without even that must not hang
                # this consumer forever.
                if not pump.is_alive() and q.empty():
                    raise RuntimeError(
                        "ShardedLoader: producer thread died without "
                        "delivering end-of-stream or an error — epoch "
                        "batches were lost") from None
                continue
            if kind == "error":
                raise payload
            if kind == "eos":
                status["done"] = True
                return
            obs.counter("data.loader.batches").add(1)
            yield self._block(*payload)

    def _block(self, batch: np.ndarray, w: np.ndarray):
        """This rank's block of a host batch and its weights, under one
        snapshot of (mesh, axes): a concurrent reshard() from an elastic
        watcher thread must never split a batch and its weights across
        two meshes."""
        mesh, axes = self.mesh, self.data_axes
        if mesh is None:
            return batch, w
        return shard_rows(batch, mesh, axes), shard_rows(w, mesh, axes)

    # -- device side ---------------------------------------------------------

    def _epoch(self, chunk_iter, *, writer, apply_transform):
        # NOTE: the epoch claim (_epoch_active) is taken eagerly in
        # __iter__, before this generator is created; this generator
        # releases it in its finally.
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pump = self._pump_thread = threading.Thread(
            target=self._pump,
            args=(chunk_iter, q, writer, apply_transform, stop),
            daemon=True)
        pump.start()
        if self.device.type == "cuda" and self._ring is None:
            self._ring = StagingRing(self.device)
        status = {"done": False}
        generation = self._generation
        staged = device_batches(self._host_batches(q, pump, status),
                                self.device, self._ring)
        # only collect device batches when a store can back them —
        # cache=False streaming epochs would pin device memory for
        # batches the final guard must throw away
        collect: Optional[list] = \
            [] if (self._cache or self._store is not None) else None
        nbytes = 0
        try:
            for x, w in staged:
                if collect is not None:
                    nbytes += 4 * (x.numel() + w.numel())
                    if (nbytes > self.resident_bytes
                            or self._generation != generation):
                        collect = None     # too big / remeshed mid-epoch
                    else:
                        # ring slots are reused: the cache keeps copies
                        collect.append((x.clone(), w.clone()))
                yield x, w
        finally:
            staged.close()
            stop.set()           # retire the producer if we leave early
            self._epoch_active = False
        if status["done"] and collect is not None \
                and self._store is not None \
                and self._generation == generation:
            self._device_cache = collect

    def _resident_epoch(self):
        """Replay the device-resident batch cache.  A `reshard` landing
        mid-replay serves the remainder from the store, placed for the
        new mesh (the cached blocks are the old mesh's; the contract is
        that every batch after a reshard targets the new one)."""
        generation = self._generation
        for k, (x, w) in enumerate(self._device_cache):
            if self._generation != generation:
                rest = self._epoch(self._store.iter_chunks(), writer=None,
                                   apply_transform=self._store_is_raw)
                yield from itertools.islice(rest, k, None)
                return
            obs.counter("data.loader.resident_batches").add(1)
            yield x, w

    def __iter__(self):
        if self._device_cache is not None:
            return self._resident_epoch()         # concurrent-safe replay
        if self._epoch_active:
            raise RuntimeError("ShardedLoader: an epoch is already in "
                               "flight; finish or abandon it first")
        if self._store is not None:
            self._epoch_active = True             # claim BEFORE handing
            return _EpochIterator(self, self._epoch(
                self._store.iter_chunks(), writer=None,
                apply_transform=self._store_is_raw))
        if self._source is None:
            raise RuntimeError(
                "ShardedLoader: the raw source was already consumed "
                + ("but the ingest epoch was abandoned before the cache "
                   "was built — re-create the loader"
                   if self._cache else
                   "(cache=False streaming mode is single-use)"))
        src, self._source = self._source, None
        writer = (StoreWriter(self.chunk_rows, self.cache_dir,
                              mem_limit_bytes=self.ingest_limit_bytes)
                  if self._cache else None)
        self._epoch_active = True                 # claim BEFORE handing
        return _EpochIterator(
            self, self._epoch(src, writer=writer, apply_transform=True))
