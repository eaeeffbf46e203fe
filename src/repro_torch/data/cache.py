"""Chunked dataset cache — the paper's caching design, out of core.

Counterpart of `repro.data.cache`, of which it is the port's own copy
(that module is numpy-only, but `repro_torch` imports nothing of
`repro`).  BigFCM's headline win over Mahout/Ludwig FKM is that data is
parsed and cached **once** on each node and every later iteration
re-reads the node-local cache instead of re-scanning HDFS.  `ChunkStore`
is that cache: any record source is ingested exactly once (parse →
transform → fixed-size float32 chunks), spilled either to memory or to
memory-mapped ``.npy`` chunk files under a cache directory, and every
consumer — the out-of-core `bigfcm_fit_store` / `wfcmpb_store` /
`mr_fuzzy_kmeans_store` paths and `assign_store` — streams from the
store without touching the original source again.

Cache-dir layout (the reference's format, byte for byte: a store
ingested by either package opens in the other)::

    <cache_dir>/
      chunk_000000.npy     # (chunk_rows, dim) float32, C-contiguous
      chunk_000001.npy
      ...
      chunk_NNNNNN.npy     # tail chunk may hold fewer rows
      manifest.json        # written LAST — its presence marks validity

**Invalidation rule.**  A cache directory is valid iff ``manifest.json``
exists and every chunk file it names matches the recorded (rows, dim)
shape; the manifest is written last (atomic rename), so an interrupted
ingest leaves no manifest and `ChunkStore.open` refuses the directory.
The manifest records a **content hash** — sha256 over the row bytes in
row order, independent of the chunking — which identifies the dataset:
two stores hold the same data iff their hashes match, regardless of
``chunk_rows``.  `verify()` re-hashes the chunks against the manifest
to detect on-disk corruption.

Chunk reads, bytes and cache hits are counted through
`repro_torch.obs` under the reference's names (``data.cache.*``).
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import (Callable, Iterator, Iterable, List, NamedTuple,
                    Optional, Sequence, Union)

import numpy as np

from .. import obs

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1
_CHUNK_FMT = "chunk_{:06d}.npy"


class CacheInvalid(ValueError):
    """The cache directory has no valid manifest / mismatched chunks."""


class ColumnStats(NamedTuple):
    """Per-column dataset statistics, accumulated in ONE pass at ingest
    (the same pass that parses and chunks — BigFCM's cache-once rule
    applies to statistics too: no extra scan, ever).  Variance is the
    population variance, derived from the float64 (Σx, Σx²) sums the
    writer keeps; all arrays are (dim,)."""
    count: int
    minimum: np.ndarray
    maximum: np.ndarray
    mean: np.ndarray
    var: np.ndarray

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.var)


class Rechunker:
    """Push-based fixed-size re-chunking buffer — THE place records are
    re-sliced to a row budget, shared by `StoreWriter` (exact cache
    chunks) and `repro_torch.data.plane.batched` (fixed device batches) so
    the two can never drift apart."""

    def __init__(self, rows: int):
        if rows <= 0:
            raise ValueError(f"rows must be positive, got {rows}")
        self.rows = int(rows)
        self._buf: List[np.ndarray] = []
        self._n = 0

    def push(self, x: np.ndarray) -> Iterator[np.ndarray]:
        """Feed an (n_i, d) array; yields exact (rows, d) slices."""
        if not x.shape[0]:
            return
        self._buf.append(x)
        self._n += x.shape[0]
        while self._n >= self.rows:
            flat = np.concatenate(self._buf) if len(self._buf) > 1 \
                else self._buf[0]
            yield np.ascontiguousarray(flat[:self.rows])
            rest = flat[self.rows:]
            self._buf = [rest] if rest.shape[0] else []
            self._n = rest.shape[0]

    def tail(self) -> Optional[np.ndarray]:
        """Drain the (< rows) remainder, or None when flush."""
        if not self._n:
            return None
        flat = np.concatenate(self._buf) if len(self._buf) > 1 \
            else self._buf[0]
        self._buf, self._n = [], 0
        return np.ascontiguousarray(flat)


class StoreWriter:
    """Incremental ChunkStore builder — append record arrays, `finish()`.

    Chunks spill as they fill, so a caller can ingest while the same
    records keep flowing to a consumer.  ``ChunkStore.ingest`` is the
    one-shot convenience wrapper.
    """

    def __init__(self, chunk_rows: int, cache_dir: Optional[str] = None,
                 mem_limit_bytes: Optional[int] = None):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.chunk_rows = int(chunk_rows)
        self.cache_dir = cache_dir
        # in-memory mode only: fail loudly instead of OOM-ing silently
        self.mem_limit_bytes = (None if cache_dir is not None
                                else mem_limit_bytes)
        self._mem_bytes = 0
        self._rechunk = Rechunker(chunk_rows)
        self._chunks: List[np.ndarray] = []      # in-memory mode only
        self._rows: List[int] = []
        self._dim: Optional[int] = None
        self._hash = hashlib.sha256()
        self._finished = False
        # one-pass column stats accumulators (float64; see ColumnStats)
        self._stat_count = 0
        self._stat_min: Optional[np.ndarray] = None
        self._stat_max: Optional[np.ndarray] = None
        self._stat_sum: Optional[np.ndarray] = None
        self._stat_sumsq: Optional[np.ndarray] = None
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            # Invalidate any previous cache FIRST (manifest gone ⇒ dir
            # invalid until we finish), then clear stale chunk files.
            _rm(os.path.join(cache_dir, MANIFEST_NAME))
            for p in glob.glob(os.path.join(cache_dir, "chunk_*.npy")):
                _rm(p)

    def append(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"records must be (n, d), got shape {x.shape}")
        if not x.shape[0]:
            return
        if self._dim is None:
            self._dim = int(x.shape[1])
        elif x.shape[1] != self._dim:
            raise ValueError(f"feature dim changed mid-ingest: "
                             f"{x.shape[1]} != {self._dim}")
        for chunk in self._rechunk.push(x):
            self._emit(chunk)

    def _emit(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, np.float32)
        self._hash.update(arr.tobytes())
        a64 = arr.astype(np.float64)
        self._stat_count += int(arr.shape[0])
        if self._stat_min is None:
            self._stat_min = a64.min(axis=0)
            self._stat_max = a64.max(axis=0)
            self._stat_sum = a64.sum(axis=0)
            self._stat_sumsq = (a64 * a64).sum(axis=0)
        else:
            np.minimum(self._stat_min, a64.min(axis=0),
                       out=self._stat_min)
            np.maximum(self._stat_max, a64.max(axis=0),
                       out=self._stat_max)
            self._stat_sum += a64.sum(axis=0)
            self._stat_sumsq += (a64 * a64).sum(axis=0)
        i = len(self._rows)
        self._rows.append(int(arr.shape[0]))
        obs.counter("data.cache.chunks_written").add(1)
        obs.counter("data.cache.cold_parse_bytes").add(arr.nbytes)
        if self.cache_dir is None:
            self._mem_bytes += arr.nbytes
            if (self.mem_limit_bytes is not None
                    and self._mem_bytes > self.mem_limit_bytes):
                raise MemoryError(
                    f"in-memory chunk cache exceeded {self.mem_limit_bytes} "
                    "bytes — pass cache_dir= to spill to disk, or "
                    "cache=False to stream without retaining")
            self._chunks.append(arr)
        else:
            np.save(os.path.join(self.cache_dir, _CHUNK_FMT.format(i)), arr)

    def finish(self) -> "ChunkStore":
        if self._finished:
            raise RuntimeError("StoreWriter.finish() called twice")
        self._finished = True
        tail = self._rechunk.tail()
        if tail is not None:
            self._emit(tail)
        if self._dim is None:
            raise ValueError("cannot build a ChunkStore from an empty source")
        content_hash = "sha256:" + self._hash.hexdigest()
        col_stats = {"count": self._stat_count,
                     "min": self._stat_min.tolist(),
                     "max": self._stat_max.tolist(),
                     "sum": self._stat_sum.tolist(),
                     "sumsq": self._stat_sumsq.tolist()}
        if self.cache_dir is not None:
            # "col_stats" is an ADDITIVE manifest key: caches written
            # before it existed still open (stats() just returns None),
            # so FORMAT_VERSION stays put.
            manifest = {"format_version": FORMAT_VERSION,
                        "chunk_rows": self.chunk_rows, "dim": self._dim,
                        "rows": self._rows, "dtype": "float32",
                        "content_hash": content_hash,
                        "col_stats": col_stats}
            tmp = os.path.join(self.cache_dir, MANIFEST_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(self.cache_dir, MANIFEST_NAME))
        return ChunkStore(chunk_rows=self.chunk_rows, dim=self._dim,
                          rows=self._rows, content_hash=content_hash,
                          cache_dir=self.cache_dir,
                          chunks=None if self.cache_dir else self._chunks,
                          col_stats=col_stats)


class ChunkStore:
    """A parse-once, chunked, re-iterable dataset (see module docstring).

    In-memory (``cache_dir=None``) stores hold their chunks as plain
    arrays; on-disk stores hand out ``np.load(..., mmap_mode="r")``
    memmap views, so iterating a store larger than RAM streams pages
    from disk.
    """

    def __init__(self, *, chunk_rows: int, dim: int, rows: Sequence[int],
                 content_hash: str, cache_dir: Optional[str] = None,
                 chunks: Optional[List[np.ndarray]] = None,
                 col_stats: Optional[dict] = None):
        self._col_stats = col_stats
        self.chunk_rows = int(chunk_rows)
        self.dim = int(dim)
        self.rows = tuple(int(r) for r in rows)
        self.content_hash = content_hash
        self.cache_dir = cache_dir
        self._chunks = chunks
        if (chunks is None) == (cache_dir is None):
            raise ValueError("exactly one of cache_dir / in-memory chunks")
        self.n_rows = sum(self.rows)
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.rows)]).astype(np.int64)

    # -- construction --------------------------------------------------------

    @classmethod
    def ingest(cls, source: Union[np.ndarray, Iterable[np.ndarray]], *,
               chunk_rows: int = 8192, cache_dir: Optional[str] = None,
               transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
               ) -> "ChunkStore":
        """Consume ``source`` ONCE (an array, or an iterable of (n_i, d)
        arrays) through ``transform`` into a store.  The store holds the
        *transformed* records — parse/normalize cost is paid exactly
        once; every replay skips it."""
        if isinstance(source, np.ndarray):
            source = [source]
        with obs.span("data.ingest"):
            w = StoreWriter(chunk_rows, cache_dir)
            for chunk in source:
                w.append(np.asarray(transform(chunk)
                                    if transform is not None else chunk))
            return w.finish()

    @classmethod
    def open(cls, cache_dir: str) -> "ChunkStore":
        """Re-open an existing on-disk cache, validating the manifest
        against the chunk files (shape check per chunk — the
        invalidation rule; `verify()` additionally re-hashes)."""
        path = os.path.join(cache_dir, MANIFEST_NAME)
        if not os.path.exists(path):
            raise CacheInvalid(f"no {MANIFEST_NAME} in {cache_dir!r} "
                               "(missing or interrupted ingest)")
        with open(path) as f:
            man = json.load(f)
        if man.get("format_version") != FORMAT_VERSION:
            raise CacheInvalid(f"manifest format {man.get('format_version')}"
                               f" != {FORMAT_VERSION}")
        store = cls(chunk_rows=man["chunk_rows"], dim=man["dim"],
                    rows=man["rows"], content_hash=man["content_hash"],
                    cache_dir=cache_dir, col_stats=man.get("col_stats"))
        for i, r in enumerate(store.rows):
            p = os.path.join(cache_dir, _CHUNK_FMT.format(i))
            try:
                shape = np.load(p, mmap_mode="r").shape
            except (OSError, ValueError) as e:
                raise CacheInvalid(f"chunk file {p!r} unreadable: {e}") \
                    from None
            if shape != (r, store.dim):
                raise CacheInvalid(f"chunk file {p!r} shape {shape} != "
                                   f"manifest ({r}, {store.dim})")
        return store

    @classmethod
    def open_or_ingest(cls, cache_dir: str,
                       source: Union[np.ndarray, Iterable[np.ndarray],
                                     Callable[[], Iterable[np.ndarray]]],
                       *, chunk_rows: int = 8192,
                       transform: Optional[Callable] = None,
                       expected_hash: Optional[str] = None) -> "ChunkStore":
        """The warm-start entry: re-open ``cache_dir`` if it holds a
        valid cache, otherwise ingest ``source`` (a source, or a
        zero-arg callable producing one — only invoked on a cold cache).

        THE CACHE DIR IS THE DATASET'S IDENTITY: a warm cache cannot
        tell whether ``source``/``transform`` since changed — that is
        the point (never re-read the source).  A warm cache whose
        ``chunk_rows`` differs from the request is re-ingested; pass
        ``expected_hash`` (a prior ``content_hash``) to also re-ingest
        when the cached *data* isn't the dataset you expect; otherwise
        delete the directory when the source changes."""
        try:
            store = cls.open(cache_dir)
            if store.chunk_rows == chunk_rows and (
                    expected_hash is None
                    or store.content_hash == expected_hash):
                obs.counter("data.cache.open_hits").add(1)
                return store
        except CacheInvalid:
            pass
        obs.counter("data.cache.open_misses").add(1)
        src = source() if callable(source) and not isinstance(
            source, np.ndarray) else source
        return cls.ingest(src, chunk_rows=chunk_rows,
                          cache_dir=cache_dir, transform=transform)

    # -- reads ---------------------------------------------------------------

    @property
    def n_chunks(self) -> int:
        return len(self.rows)

    @property
    def nbytes(self) -> int:
        return self.n_rows * self.dim * 4

    def __len__(self) -> int:
        return self.n_rows

    def chunk(self, i: int) -> np.ndarray:
        """Chunk ``i`` — an array (in-memory) or a read-only memmap."""
        obs.counter("data.cache.chunk_reads").add(1)
        nbytes = self.rows[i] * self.dim * 4
        if self._chunks is not None:
            obs.counter("data.cache.warm_mem_bytes").add(nbytes)
            return self._chunks[i]
        obs.counter("data.cache.warm_mmap_bytes").add(nbytes)
        return np.load(os.path.join(self.cache_dir, _CHUNK_FMT.format(i)),
                       mmap_mode="r")

    def iter_chunks(self) -> Iterator[np.ndarray]:
        """Fresh chunk iterator — a store is re-iterable by design."""
        for i in range(self.n_chunks):
            yield self.chunk(i)

    def materialize(self) -> np.ndarray:
        """The full (n_rows, dim) array — the in-memory escape hatch."""
        return np.concatenate([np.asarray(c) for c in self.iter_chunks()])

    def take(self, idx: np.ndarray) -> np.ndarray:
        """Gather rows by global index, preserving ``idx`` order (the
        driver's Parker–Hall sample reads through this)."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_rows):
            raise IndexError(f"row index out of range [0, {self.n_rows})")
        out = np.empty((idx.size, self.dim), np.float32)
        cid = np.searchsorted(self.offsets, idx, side="right") - 1
        for c in np.unique(cid):
            sel = cid == c
            out[sel] = self.chunk(int(c))[idx[sel] - self.offsets[c]]
        return out

    def stats(self) -> Optional[ColumnStats]:
        """Per-column stats from the ingest pass — no data scan here;
        the accumulators ride the manifest (or the in-memory writer).
        ``None`` for caches written before stats existed (re-ingest to
        get them)."""
        s = self._col_stats
        if s is None:
            return None
        n = int(s["count"])
        mean = np.asarray(s["sum"], np.float64) / n
        var = np.maximum(
            np.asarray(s["sumsq"], np.float64) / n - mean * mean, 0.0)
        return ColumnStats(n, np.asarray(s["min"], np.float64),
                           np.asarray(s["max"], np.float64), mean, var)

    def normalizer(self, kind: str = "standard"
                   ) -> Callable[[np.ndarray], np.ndarray]:
        """A column-normalize transform FIT on this store's ingest-pass
        stats: ``"standard"`` maps to zero mean / unit variance,
        ``"minmax"`` to [0, 1].  Constant columns pass through
        unchanged (scale floors at 1).  Hand the callable to
        ``ChunkStore.ingest(..., transform=...)`` — normalize once at
        ingest with the TRAINING store's statistics, serve forever off
        the cache."""
        st = self.stats()
        if st is None:
            raise CacheInvalid(
                f"store at {self.cache_dir!r} predates column stats; "
                "re-ingest to enable normalizer()")
        if kind == "standard":
            shift = st.mean
            scale = np.where(st.std > 0, st.std, 1.0)
        elif kind == "minmax":
            shift = st.minimum
            span = st.maximum - st.minimum
            scale = np.where(span > 0, span, 1.0)
        else:
            raise ValueError(f"unknown normalizer kind {kind!r}; "
                             "one of 'standard', 'minmax'")
        shift32 = shift.astype(np.float32)
        inv32 = (1.0 / scale).astype(np.float32)

        def transform(x: np.ndarray) -> np.ndarray:
            return (np.asarray(x, np.float32) - shift32) * inv32

        return transform

    def verify(self) -> bool:
        """Re-hash the chunk bytes against the manifest's content hash."""
        h = hashlib.sha256()
        for c in self.iter_chunks():
            h.update(np.ascontiguousarray(c, np.float32).tobytes())
        return "sha256:" + h.hexdigest() == self.content_hash

    def __repr__(self):
        where = self.cache_dir or "memory"
        return (f"<ChunkStore {self.n_rows}x{self.dim} in {self.n_chunks} "
                f"chunks ({self.chunk_rows} rows) @ {where}>")


def _rm(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
