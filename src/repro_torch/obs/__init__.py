"""`repro_torch.obs` — the unified metrics/tracing plane.

Counterpart of `repro.obs`, an own copy (the port imports nothing of
`repro`) with the same metric and span names, label schema and knobs.
One lightweight, always-on-capable observability layer under every
other subsystem (engine, data, stream, ft, serve, tenant):

  * **metrics** — a process-global registry of counters, gauges, and
    fixed log-bucket histograms (p50/p99 derivable without storing
    samples), cheap enough to leave enabled;
  * **trace** — nestable, thread-safe ``span("stream.ingest")`` timing
    plus point `event`s, recorded in an in-memory ring buffer and an
    optional atomic JSONL sink; every span feeds a ``span.<name>``
    latency histogram for free;
  * **report** — `snapshot()` and the per-phase breakdown/renderer
    (``python -m repro_torch.obs.report``).

A span times the host.  No span calls ``torch.cuda.synchronize``: the
loops it wraps are host-bound, and a sync inside a span would change
what they measure.  A span around an asynchronous kernel launch
measures the launch; the spans that time card work end at a
synchronization the instrumented code makes anyway (a loop's
convergence test reading ΔV² back, a fit's host copy of its result).

Environment knobs
-----------------
``REPRO_OBS=0``        kill switch: every instrumentation call becomes
                       a flag-check no-op (`set_enabled` flips it at
                       runtime; ``None`` re-reads the env).
``REPRO_OBS_DIR``      when set, `flush_jsonl()` (and an atexit hook)
                       writes the ring buffer + a final metrics
                       snapshot to ``<dir>/events.jsonl`` atomically.
``REPRO_OBS_RING``     ring-buffer capacity (default 4096 events).

Label schema
------------
Metrics are keyed by ``(name, labels)``: ``counter("x", k="v")`` is an
independent series from the unlabeled ``counter("x")``, rendered as
``x{k=v}`` in snapshots/reports.  Spans follow the same rule via
``span(name, labels={...})``: the duration always feeds the unlabeled
``span.<name>`` histogram (the AGGREGATE series — SLO readers key on
it, e.g. ``span.serve.assign`` p99) and additionally a labeled
``span.<name>{k=v}`` series per label set.  Conventions in use:

  * ``replica=<id>`` — the serving plane's scorer replica: the
    `serve.service` workers label ``span.serve.assign``,
    ``serve.records``, and ``serve.batches`` with the replica id so
    per-replica throughput/latency separate cleanly in `obs.report`;
    the unlabeled ``serve.records`` series is the single-process
    library path (`assign_stream`/`assign_store`).
  * ``backend=<name>`` — engine events carry the resolved sweep
    backend as an event field (not a metric label).
  * ``host=<id>`` — the fleet plane (`fleet`) labels its
    spans ``fleet.local_fit`` / ``fleet.shard_fit`` /
    ``fleet.exchange`` / ``fleet.objective`` with the host id (counters
    stay process-global: in one REAL host process they are that host's
    own series; the threaded sim fleet shares one registry, which its
    tests account for).  Fleet counters: ``fleet.exchange.bytes{wire=…}``
    (frame bytes by encoding), ``fleet.replan.moved_chunks``,
    ``fleet.straggler.detected``, ``fleet.prefetch.bytes``,
    ``fleet.tombstones``.
  * ``tenants=<T>`` — the tenant plane (`tenant` /
    `serve.tenant`) labels ``span.tenant.fit`` with the
    cohort size of a batched fit and ``span.tenant.assign`` with the
    number of DISTINCT tenants coalesced into one scoring launch;
    ``tenant.fit.launches`` counts device dispatches (batched fit: 1;
    the looped baseline: T) so launch amortization is readable next to
    wall time.
  * ``tenant=<id>`` — reserved for per-tenant series a deployment opts
    into (e.g. billing-grade per-tenant record counters).  The built-in
    paths deliberately emit only the coarse ``tenants=<T>`` label:
    per-tenant label sets would make metric cardinality O(fleet size).

This package is pure stdlib — no torch/numpy — so every layer may import
it unconditionally without cycles or load cost.
"""
from .metrics import (Counter, Gauge, Histogram, counter, enabled,
                      gauge, histogram, set_enabled)
from .metrics import reset as reset_metrics
from .metrics import snapshot as metrics_snapshot
from .trace import (clear, event, flush_jsonl, load_jsonl, ring_events,
                    set_ring_size, span, warn_once)

# `.report` is loaded lazily (PEP 562): `python -m repro_torch.obs.report`
# would otherwise trigger runpy's found-in-sys.modules warning.
_REPORT_NAMES = ("phase_breakdown", "render_report", "snapshot")


def __getattr__(name: str):
    if name in _REPORT_NAMES:
        from . import report
        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "enabled", "set_enabled", "reset_metrics", "metrics_snapshot",
    "phase_breakdown", "render_report", "snapshot",
    "clear", "event", "flush_jsonl", "load_jsonl", "ring_events",
    "set_ring_size", "span", "warn_once", "reset_all",
]


def reset_all() -> None:
    """Fresh telemetry: drop every metric and the event ring (tests;
    the start of an instrumented run that wants a clean baseline)."""
    reset_metrics()
    clear()
