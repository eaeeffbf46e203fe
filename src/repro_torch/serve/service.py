"""Batched online scoring service — the throughput front end over the
scorers.

Counterpart of `repro.serve.service`, an own copy (numpy and threads;
the device work is the replicas' `Scorer.score`).  Built for
assignments coming back fast under many-client load:

  * **Request coalescing.**  Concurrent, arbitrarily-sized requests
    land on one bounded FIFO queue; worker threads drain it greedily,
    packing adjacent requests into one device batch (up to
    ``max_batch_rows``) so the device amortizes dispatch overhead
    across clients instead of paying it per request.
  * **Shape-bucketed fixed-shape batches.**  A coalesced batch is
    padded up to the smallest bucket of a geometric ladder
    (`repro_torch.data.plane.shape_buckets`, the data plane's phantom-row
    padding idiom), so a replica sees one input shape per bucket, never
    one per request size (`compile_counts`).  Phantom rows are sliced
    off before responses resolve.
  * **Overload policy.**  The queue is bounded in ROWS
    (``queue_rows``).  ``policy="shed"`` rejects immediately with a
    typed `Rejected` when the queue is full; ``policy="queue"`` blocks
    the submitter until room frees or ``deadline_s`` expires
    (`DeadlineExceeded`).  Either way queue depth is capped and
    admission keeps a progress guarantee: an oversized request is
    admitted whenever the queue is empty.
  * **Fail-loud.**  A scoring error resolves the batch's futures with
    the exception, fails every queued request, and closes the service
    (the `ShardedLoader` idiom: propagate, never hang a waiting client).
  * **Replicas.**  One worker thread per `Scorer` replica; replicas
    hot-swap snapshots mid-traffic (`swap`, or wire
    ``StreamingBigFCM.add_snapshot_listener(service.swap)``) without
    dropping or blocking in-flight requests — each dispatched batch
    reads its replica's snapshot exactly once, so every response is
    scored against exactly one version.

Observability (the reference's names): ``serve.queue_depth`` /
``serve.queue_rows`` gauges, ``serve.shed`` / ``serve.deadline_expired``
/ ``serve.served`` counters, per-replica ``serve.records`` /
``serve.batches`` counters and ``span.serve.assign{replica=...}``
latency series next to the unlabeled aggregate (the SLO histogram; each
span ends at the host copy of its batch's labels), plus a
``serve.request`` end-to-end (submit → response) latency histogram.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np

from .. import obs
from ..data.plane import bucket_for, pad_rows, shape_buckets

from .scorer import CenterSnapshot, Scorer


class Rejected(RuntimeError):
    """Typed shed rejection: the bounded queue was full and
    ``policy="shed"`` chose latency over this request.  Carries the
    queue state so clients can back off proportionally."""

    def __init__(self, msg: str, *, queued_rows: int, limit_rows: int):
        super().__init__(msg)
        self.queued_rows = int(queued_rows)
        self.limit_rows = int(limit_rows)


class DeadlineExceeded(RuntimeError):
    """``policy="queue"``: the submitter waited ``deadline_s`` for
    queue room that never freed."""


class ServiceClosed(RuntimeError):
    """Submit after `close()` (or a request drained by a non-draining
    close)."""


class ScoreResult(NamedTuple):
    """One response: assignments for the request's rows (hard labels
    ``(n,)`` or soft memberships ``(n, C)``), the snapshot ``version``
    they were scored against (exactly one — never torn across a
    hot-swap), and the ``replica`` that served them."""
    assignments: np.ndarray
    version: int
    replica: str


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the scoring front-end.

    ``max_batch_rows`` caps one device dispatch (and tops the bucket
    ladder); ``bucket_base``/``bucket_factor`` shape the ladder;
    ``queue_rows`` bounds the queue in rows; ``policy`` picks the
    overload response (``"queue"`` waits up to ``deadline_s``,
    ``"shed"`` rejects immediately); ``coalesce=False`` is the
    one-request-one-dispatch ablation (every request scored at its
    natural shape — the benchmark baseline, not a production mode).

    ``max_group_rows`` is the fairness cap: requests may carry a group
    id (the tenant plane tags each request with its tenant), and with
    the cap set one group contributes at most that many rows per
    dispatch — the coalescer takes eligible requests past an ineligible
    run in FIFO order, so a firehose group cannot monopolize every
    batch while a quiet group's lone request ages at position 300.
    ``None`` (default) keeps exact strict-FIFO-run coalescing; the
    queue head is always admitted (progress guarantee)."""
    max_batch_rows: int = 4096
    bucket_base: int = 64
    bucket_factor: int = 2
    queue_rows: int = 65536
    policy: str = "queue"            # "queue" | "shed"
    deadline_s: float = 5.0
    coalesce: bool = True
    max_group_rows: Optional[int] = None

    def __post_init__(self):
        if self.policy not in ("queue", "shed"):
            raise ValueError(f"policy must be 'queue' or 'shed', got "
                             f"{self.policy!r}")
        if self.max_batch_rows <= 0 or self.queue_rows <= 0:
            raise ValueError("max_batch_rows and queue_rows must be "
                             "positive")
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if self.max_group_rows is not None and self.max_group_rows <= 0:
            raise ValueError("max_group_rows must be positive (or None "
                             "to disable the fairness cap)")


class _Request(NamedTuple):
    x: np.ndarray
    n: int
    future: Future
    t_submit: float
    group: Optional[str] = None   # fairness group (tenant id)


class ScoringService:
    """The coalescing front-end over N hot-swappable `Scorer` replicas.

    ``submit(x)`` returns a `Future` resolving to a `ScoreResult`;
    ``score(x)`` is the synchronous wrapper.  One worker thread per
    replica drains the shared queue.  Use as a context manager, or
    `close()` explicitly."""

    def __init__(self, scorers: Union[Scorer, Sequence[Scorer]],
                 cfg: ServiceConfig = ServiceConfig()):
        scorers = ([scorers] if isinstance(scorers, Scorer)
                   else list(scorers))
        if not scorers:
            raise ValueError("ScoringService needs at least one Scorer")
        dims = {s.dim for s in scorers}
        if len(dims) != 1:
            raise ValueError(f"replicas disagree on feature dim: {dims}")
        names = [s.replica for s in scorers]
        if len(set(names)) != len(names):
            raise ValueError(f"replica ids must be unique, got {names}")
        self.scorers = scorers
        self.cfg = cfg
        self._dim = dims.pop()
        self._buckets = shape_buckets(cfg.max_batch_rows,
                                      base=cfg.bucket_base,
                                      factor=cfg.bucket_factor)
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._queued_rows = 0
        self._closed = False
        self._failure: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._worker, args=(s,),
                             name=f"serve-{s.replica}", daemon=True)
            for s in scorers]
        for t in self._threads:
            t.start()

    # -- client side -------------------------------------------------------

    def submit(self, x, *, group: Optional[str] = None) -> Future:
        """Enqueue one assignment request; resolves to a `ScoreResult`.

        Shape/dim errors raise here (fail fast, nothing enqueued);
        overload raises `Rejected` (shed) or `DeadlineExceeded`
        (queue); scoring failures resolve the future with the
        exception.  ``group`` tags the request for the
        ``max_group_rows`` fairness cap (the tenant service passes the
        tenant id)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"request must be (n>=1, d), got {x.shape}")
        if x.shape[1] != self._dim:
            raise ValueError(f"request dim {x.shape[1]} != model dim "
                             f"{self._dim}")
        n = int(x.shape[0])
        req = _Request(x, n, Future(), time.perf_counter(), group)
        with self._cond:
            self._check_open()
            if not self._admissible(n):
                if self.cfg.policy == "shed":
                    obs.counter("serve.shed").add(1)
                    obs.counter("serve.shed_rows").add(n)
                    raise Rejected(
                        f"queue full ({self._queued_rows} rows >= "
                        f"{self.cfg.queue_rows}); request of {n} rows "
                        f"shed", queued_rows=self._queued_rows,
                        limit_rows=self.cfg.queue_rows)
                deadline = time.monotonic() + self.cfg.deadline_s
                while not self._admissible(n):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        obs.counter("serve.deadline_expired").add(1)
                        raise DeadlineExceeded(
                            f"no queue room for {n} rows within "
                            f"{self.cfg.deadline_s}s")
                    self._cond.wait(remaining)
                    self._check_open()
            self._queue.append(req)
            self._queued_rows += n
            self._gauges()
            self._cond.notify_all()
        return req.future

    def score(self, x, timeout: Optional[float] = None) -> ScoreResult:
        """Synchronous `submit`: block for this request's result."""
        return self.submit(x).result(timeout)

    def swap(self, version, centers=None, weights=None) -> None:
        """Hot-swap EVERY replica to a new snapshot — matches the
        ``(version, centers, weights)`` listener signature, so
        ``model.add_snapshot_listener(service.swap)`` follows a live
        learner; also accepts a ready `CenterSnapshot`.  Never blocks
        on in-flight requests: dispatched batches finish against the
        snapshot they already read; the next batch per replica sees
        the new version."""
        if isinstance(version, CenterSnapshot):
            snap = version
        else:
            snap = CenterSnapshot(int(version), np.asarray(centers),
                                  None if weights is None
                                  else np.asarray(weights))
        for s in self.scorers:
            s.swap(snap)

    @property
    def buckets(self):
        """The row-count bucket ladder requests are padded onto."""
        return self._buckets

    def compile_counts(self) -> dict:
        """Per-replica shape counts (`Scorer.traces`, the reference's
        XLA trace counts) — the one-shape-per-bucket regression guard
        reads this."""
        return {s.replica: s.traces for s in self.scorers}

    def close(self, *, drain: bool = True) -> None:
        """Stop accepting requests.  ``drain=True`` (default) serves
        everything already queued before workers exit; ``drain=False``
        fails queued requests with `ServiceClosed`."""
        with self._cond:
            if self._closed:
                self._cond.notify_all()
            self._closed = True
            pending = []
            if not drain:
                pending = list(self._queue)
                self._queue.clear()
                self._queued_rows = 0
                self._gauges()
            self._cond.notify_all()
        for r in pending:
            r.future.set_exception(ServiceClosed(
                "service closed before this request was scored"))
        for t in self._threads:
            t.join()

    def __enter__(self) -> "ScoringService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- internals ---------------------------------------------------------

    def _admissible(self, n: int) -> bool:
        # empty-queue admission keeps a progress guarantee for
        # requests bigger than the row bound (split across dispatches
        # by the worker, all against one snapshot)
        return (self._queued_rows == 0
                or self._queued_rows + n <= self.cfg.queue_rows)

    def _check_open(self) -> None:
        if self._failure is not None:
            raise RuntimeError(
                "scoring service failed; see the cause") from self._failure
        if self._closed:
            raise ServiceClosed("scoring service is closed")

    def _gauges(self) -> None:
        obs.gauge("serve.queue_depth").set(len(self._queue))
        obs.gauge("serve.queue_rows").set(self._queued_rows)

    def _take(self):
        """Pop requests for one dispatch (coalescing up to
        ``max_batch_rows``); None = worker should exit.

        Without a fairness cap this is the strict FIFO head run.  With
        ``max_group_rows`` set, the scan continues past requests that
        don't fit (batch full, or their group already at its cap),
        taking later eligible requests in FIFO order — skipped requests
        keep their queue position, and the head is always admitted, so
        every request still drains in bounded dispatches."""
        with self._cond:
            while (not self._queue and self._failure is None
                   and not self._closed):
                self._cond.wait()
            if self._failure is not None or not self._queue:
                return None
            cap = self.cfg.max_group_rows
            reqs = [self._queue.popleft()]
            rows = reqs[0].n
            if self.cfg.coalesce:
                if cap is None:
                    while (self._queue and rows + self._queue[0].n
                           <= self.cfg.max_batch_rows):
                        r = self._queue.popleft()
                        reqs.append(r)
                        rows += r.n
                else:
                    group_rows = {reqs[0].group: reqs[0].n}
                    skipped = []
                    while self._queue:
                        r = self._queue.popleft()
                        g_taken = group_rows.get(r.group, 0)
                        if (rows + r.n <= self.cfg.max_batch_rows
                                and g_taken + r.n <= cap):
                            reqs.append(r)
                            rows += r.n
                            group_rows[r.group] = g_taken + r.n
                        else:
                            skipped.append(r)
                    self._queue.extend(skipped)   # FIFO order preserved
            self._queued_rows -= rows
            self._gauges()
            self._cond.notify_all()      # room freed: wake submitters
            return reqs

    def _worker(self, scorer: Scorer) -> None:
        while True:
            reqs = self._take()
            if reqs is None:
                return
            try:
                self._dispatch(scorer, reqs)
            except BaseException as e:    # noqa: BLE001 — fail-loud
                self._fail(e, reqs)
                return

    def _dispatch(self, scorer: Scorer, reqs) -> None:
        snap = scorer.read()              # ONE atomic snapshot read —
        #                                   the whole dispatch (every
        #                                   bucket slice of an oversized
        #                                   request included) scores
        #                                   against this version
        x = (reqs[0].x if len(reqs) == 1
             else np.concatenate([r.x for r in reqs]))
        total = int(x.shape[0])
        maxb = self.cfg.max_batch_rows
        outs = []
        if self.cfg.coalesce:
            for start in range(0, total, maxb):
                piece = x[start:start + maxb]
                n = int(piece.shape[0])
                b = bucket_for(n, self._buckets)
                xp = pad_rows(piece, b)
                with obs.span("serve.assign",
                              labels={"replica": scorer.replica},
                              rows=n, bucket=b, coalesced=len(reqs)):
                    out = scorer.score(xp, snap).cpu().numpy()
                outs.append(out[:n])
        else:
            # one-request-one-dispatch ablation: natural shape, no pad
            with obs.span("serve.assign",
                          labels={"replica": scorer.replica},
                          rows=total, coalesced=1):
                outs.append(scorer.score(x, snap).cpu().numpy())
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        obs.counter("serve.records", replica=scorer.replica).add(total)
        obs.counter("serve.batches", replica=scorer.replica).add(1)
        off = 0
        done = time.perf_counter()
        for r in reqs:
            res = ScoreResult(out[off:off + r.n], snap.version,
                              scorer.replica)
            off += r.n
            obs.histogram("serve.request").observe(done - r.t_submit)
            obs.counter("serve.served", replica=scorer.replica).add(1)
            r.future.set_result(res)

    def _fail(self, exc: BaseException, reqs) -> None:
        """The ShardedLoader contract, service-shaped: the error
        reaches every waiting client through its future (no hangs),
        the queue drains failed, and later submits raise with the
        original cause."""
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)
        with self._cond:
            self._failure = exc
            pending = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self._gauges()
            self._cond.notify_all()
        for r in pending:
            if not r.future.done():
                r.future.set_exception(exc)
        obs.event("serve.failed", error=repr(exc))
