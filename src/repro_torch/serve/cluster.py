"""Clustering-side serving against a frozen model.

Counterpart of `repro.serve.cluster` (`make_assigner`, `assign_store`).
`make_assigner` freezes centers into a scorer for read-only replicas
(the fan-out tier: one learner, many scorers); it scores through the
resolved `repro_torch.engine` sweep backend, so a replica resolves the
same implementation axis the learner uses.  `assign_store` scores an
entire cached dataset (`repro_torch.data.cache.ChunkStore`) chunk by
chunk off the mmap — out-of-core batch scoring against a frozen
snapshot, the "label the whole archive with tonight's model" job.

`assign_stream` is the online shape: each incoming chunk is (optionally)
folded into a `repro_torch.stream.StreamingBigFCM` and scored at once
against its freshest windowed centers — the serve path and the learn
path share one model, so a drift re-seed shows in the very next
response.

Both scoring loops time each chunk in a ``serve.assign`` span and count
its scored records in ``serve.records`` (`repro_torch.obs`, the
reference's names); each span ends at the host copy of its labels.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..data.plane import pad_rows
from ..device import as_real, resolve_device
from ..engine import scoring_backend
from ..stream.streaming import split_item


class _Assigner:
    """The callable `make_assigner` returns: a scorer plus ``.traces``,
    the number of distinct input shapes it has scored.  The reference
    jits its scorer and counts traces, one per input shape; the port
    compiles nothing, so it counts the shapes — the same number, which
    callers that keep input shapes fixed (bucketed batches, padded store
    chunks) should see stay at one per shape."""

    __slots__ = ("_score", "_device", "_shapes", "traces")

    def __init__(self, score, device: torch.device):
        self._score = score
        self._device = device
        self._shapes = set()
        self.traces = 0

    def __call__(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            x = x.to(self._device, torch.float32)
        else:
            # A copy: a store chunk is a read-only memmap.
            x = torch.tensor(np.asarray(x), dtype=torch.float32,
                             device=self._device)
        if x.shape not in self._shapes:
            self._shapes.add(x.shape)
            self.traces += 1
        return self._score(x)


def make_assigner(centers, *, m: float = 2.0, soft: bool = False,
                  backend=None,
                  device: Union[str, torch.device] = "cuda") -> _Assigner:
    """Scorer against a FROZEN center snapshot (read replicas).

    ``backend`` names the engine sweep backend to score through
    (None/"auto" = the device's default, `scoring_backend`).  The scorer
    returns hard labels (N,) or soft memberships (N, C) on ``device``;
    its ``.traces`` counts the input shapes it has seen."""
    dev = resolve_device(device)
    be = scoring_backend(backend, device=dev)
    v = as_real(centers, dev)
    if soft:
        return _Assigner(lambda x: be.soft_assign(x, v, m), dev)
    return _Assigner(lambda x: be.hard_assign(x, v), dev)


def assign_stream(model, source, *, soft: bool = False,
                  update: bool = True
                  ) -> Iterator[Tuple[np.ndarray, Optional[object]]]:
    """Serve assignments over a chunk stream.

    ``model`` is a `StreamingBigFCM`; ``source`` yields what its `run`
    takes (`repro_torch.stream.split_item`): (n_i, d) arrays,
    timestamped ``(x, ts)`` pairs under ``event_time`` (any
    `repro_torch.data.stream` source — event times are forwarded so an
    event-time model keeps its watermark while serving), or ``(x, w)``
    batches from `repro_torch.data.stream.stream_loader`.  Per chunk,
    yields ``(assignments, report)`` as host arrays: ``report`` is the
    `IngestReport` when ``update=True`` (online learning while serving)
    and ``None`` when the model is frozen (scoring-only replica).
    Scoring runs through the model's own resolved backend.

    Deliberate divergence: the reference reads every tuple as ``(x,
    ts)``, so a loader's phantom-padded tail batch reaches its model as
    real all-zero records and is labelled in full.  Here the weights go
    to `ingest`, and rows of zero weight (the loader's phantom padding)
    get no label — the padded tail batch ingests and scores as its real
    rows alone."""
    for chunk in source:
        x, w, ts = split_item(chunk, event_time=model.cfg.event_time)
        report = model.ingest(x, w, ts=ts) if update else None
        # per-chunk scoring latency, the span.serve.assign histogram
        with obs.span("serve.assign", rows=int(x.shape[0])):
            out = model.assign(x, soft=soft)
            if w is not None:
                out = out[torch.as_tensor(w, device=out.device) > 0]
            out = out.cpu().numpy()
        obs.counter("serve.records").add(int(out.shape[0]))
        yield out, report


def assign_store(store, centers, *, m: float = 2.0, soft: bool = False,
                 backend=None, assigner=None,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Iterator[np.ndarray]:
    """Score every record of a `ChunkStore` against frozen ``centers``.

    Yields one host assignment array per cache chunk, in store row
    order — out of core: one chunk is resident at a time, so a store
    larger than memory scores in O(chunk) space.  Concatenate the yields
    for a (n_rows,) / (n_rows, C) result when it fits.  Pass a prebuilt
    ``assigner`` (from `make_assigner`) to reuse it across stores and
    calls (its ``.traces`` then counts shapes across all of them — every
    chunk is padded to the store's chunk shape, so one store is one
    shape)."""
    fn = (assigner if assigner is not None
          else make_assigner(centers, m=m, soft=soft, backend=backend,
                             device=device))
    rows = int(store.chunk_rows)
    for chunk in store.iter_chunks():
        n = int(chunk.shape[0])
        # pad the ragged tail chunk to the full chunk shape (phantom zero
        # rows, sliced back off below) so the whole store scores at one
        # input shape
        with obs.span("serve.assign", rows=n):
            out = fn(pad_rows(chunk, rows))[:n].cpu().numpy()
        obs.counter("serve.records").add(n)
        yield out
