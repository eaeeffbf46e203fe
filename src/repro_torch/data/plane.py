"""repro_torch.data.plane — the partition plan over a `ChunkStore`.

Counterpart of `repro.data.plane`, of which it is the port's own copy
(numpy-only; `repro_torch` imports nothing of `repro`).  The Hadoop side
of the paper has two tables: the node-local chunk cache
(`repro_torch.data.cache.ChunkStore`) and the job tracker's
split→mapper assignment.  `PartitionPlan` is the second one: a
deterministic map from cache chunks to data shards, with per-shard row
counts for straggler accounting and an elastic `replan` when the shard
count changes.  The out-of-core `bigfcm_fit_store` combiners read chunk
order from a plan, never ad hoc.

Planning is **deterministic**: chunks are placed by greedy
longest-processing-time (rows descending, chunk index as tie-break)
onto the currently-lightest shard (lowest shard id as tie-break).  The
plan is therefore a pure function of (store chunking, n_shards), and
equal to the reference's for the same chunking — two hosts planning the
same store agree without coordination, whichever package each runs, and
an elastic re-plan after a shard-count change is the same function at
the new count.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Iterable, Iterator, Tuple

import numpy as np

from .cache import ChunkStore, Rechunker


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """chunk → shard assignment with per-shard row accounting."""
    n_shards: int
    assignment: Tuple[int, ...]   # chunk i lives on shard assignment[i]
    shard_rows: Tuple[int, ...]   # rows per shard (straggler accounting)

    def chunks_of(self, shard: int) -> Tuple[int, ...]:
        """Chunk ids of one shard, in chunk (= row) order."""
        if not 0 <= shard < self.n_shards:
            raise IndexError(f"shard {shard} not in [0, {self.n_shards})")
        return tuple(i for i, s in enumerate(self.assignment) if s == shard)

    @property
    def n_rows(self) -> int:
        return sum(self.shard_rows)

    def fingerprint(self) -> str:
        """A short content hash of the whole plan.  Fleet hosts stamp it
        on every summary they exchange: since the plan is a pure
        function of (chunking, n_shards), any fingerprint mismatch
        means two hosts are *not* looking at the same store/shard-count
        and the merge would be silently wrong — the exchange fails loud
        instead."""
        h = hashlib.sha256()
        h.update(repr((self.n_shards, self.assignment,
                       self.shard_rows)).encode())
        return h.hexdigest()[:16]


def plan_partitions(store: ChunkStore, n_shards: int) -> PartitionPlan:
    """Deterministically map a store's chunks onto ``n_shards`` shards."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    order = sorted(range(store.n_chunks),
                   key=lambda i: (-store.rows[i], i))
    heap = [(0, s) for s in range(n_shards)]    # (load, shard id)
    heapq.heapify(heap)
    assignment = [0] * store.n_chunks
    for i in order:
        load, s = heapq.heappop(heap)
        assignment[i] = s
        heapq.heappush(heap, (load + store.rows[i], s))
    shard_rows = [0] * n_shards
    for i, s in enumerate(assignment):
        shard_rows[s] += store.rows[i]
    return PartitionPlan(n_shards, tuple(assignment), tuple(shard_rows))


def replan(store: ChunkStore, plan: PartitionPlan, n_shards: int
           ) -> Tuple[PartitionPlan, int]:
    """Elastic re-plan after a shard-count change: the same deterministic
    placement at the new shard count.  Returns ``(new_plan, moved)``
    where ``moved`` counts chunks whose shard changed — the data that
    would migrate between node-local caches."""
    new = plan_partitions(store, n_shards)
    moved = sum(1 for a, b in zip(plan.assignment, new.assignment)
                if a != b)
    return new, moved


def batched(chunks: Iterable[np.ndarray], batch_rows: int
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Re-slice a chunk stream into fixed ``(batch_rows, d)`` batches
    with per-row weights; the tail batch is padded with zero-weight
    phantom rows (weight 0 ⇒ ignored by every accumulation).  This is
    THE batcher of the out-of-core sweeps (its `Rechunker` buffer is the
    same one `StoreWriter` slices cache chunks with), so every consumer
    sees identical shapes and padding.  A batch that is one whole chunk
    comes out as a read-only view of that chunk's memmap."""
    rc = Rechunker(batch_rows)
    full_w = np.ones((batch_rows,), np.float32)
    for chunk in chunks:
        for batch in rc.push(np.asarray(chunk, np.float32)):
            yield batch, full_w
    tail = rc.tail()
    if tail is not None:
        n, dim = tail.shape
        pad = batch_rows - n
        yield (np.concatenate([tail, np.zeros((pad, dim), np.float32)]),
               np.concatenate([np.ones((n,), np.float32),
                               np.zeros((pad,), np.float32)]))


def pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """Pad ``(n, d)`` to ``(rows, d)`` with phantom zero rows.

    The fixed-shape idiom every consumer shares: the caller keeps ``n``
    and slices the first ``n`` output rows back out (scoring) or pairs
    the pad with zero weights (accumulation) — either way the phantom
    rows never influence a result.  Returns ``x`` unchanged (modulo
    float32 coercion) when it is already ``rows`` tall."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n == rows:
        return x
    if n > rows:
        raise ValueError(f"pad_rows: {n} rows do not fit in {rows}")
    return np.concatenate(
        [x, np.zeros((rows - n, x.shape[1]), np.float32)])


def shape_buckets(max_rows: int, *, base: int = 64,
                  factor: int = 2) -> Tuple[int, ...]:
    """The row-count bucket ladder ``base, base·factor, … , max_rows``
    (``max_rows`` always included).  Fixed-shape device batches are
    padded up to the smallest bucket that fits (`bucket_for`), so a
    consumer sees one input shape per bucket — never one per request
    size."""
    if max_rows <= 0 or base <= 0 or factor < 2:
        raise ValueError(f"bad bucket ladder max_rows={max_rows} "
                         f"base={base} factor={factor}")
    out = []
    b = base
    while b < max_rows:
        out.append(b)
        b *= factor
    out.append(max_rows)
    return tuple(out)


def geom_bucket(n: int, *, base: int = 64, factor: int = 2) -> int:
    """Smallest ``base·factor^k ≥ n`` — the open-ended bucket ladder.

    `shape_buckets`/`bucket_for` serve consumers with a known ceiling
    (a service's ``max_batch_rows``); this is the same geometric rule
    for axes with no ceiling — the tenant plane's row and tenant-count
    buckets, where padding up to the bucket keeps one input shape per
    bucket however the per-fit sizes wobble."""
    if n <= 0 or base <= 0 or factor < 2:
        raise ValueError(f"bad geometric bucket n={n} base={base} "
                         f"factor={factor}")
    b = base
    while b < n:
        b *= factor
    return b


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket ≥ ``n`` (``buckets`` ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {buckets[-1]}")


def shard_batches(store: ChunkStore, plan: PartitionPlan, shard: int,
                  batch_rows: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One shard's records as fixed-size phantom-padded (x, w) batches —
    what an out-of-core combiner consumes, straight off the mmap."""
    return batched((store.chunk(i) for i in plan.chunks_of(shard)),
                   batch_rows)


def as_store(data, *, chunk_rows: int = 8192, cache_dir=None,
             transform=None) -> ChunkStore:
    """Coerce an array / chunk iterable / ChunkStore into a ChunkStore
    (pass-through when it already is one)."""
    if isinstance(data, ChunkStore):
        return data
    return ChunkStore.ingest(data, chunk_rows=chunk_rows,
                             cache_dir=cache_dir, transform=transform)
