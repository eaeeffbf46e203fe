"""Span-based tracing: nestable timed scopes + structured events.

`span("stream.ingest")` times a scope and lands a structured event in
an in-memory ring buffer; the duration also feeds the
``span.<name>`` latency histogram in `repro_torch.obs.metrics`, so every
instrumented scope gets p50/p99 for free without retaining samples.
Spans nest (a thread-local stack records the parent) and are
thread-safe — the loader's producer thread and the checkpoint writer
trace concurrently with the consumer.  A span reads the host clock
only: it never synchronizes the card (package docstring).

Event schema (one flat JSON-able dict per entry)::

    {"kind": "span" | "event",
     "name": "stream.ingest",        # the span/event name
     "ts":   1722470000.123,         # wall-clock epoch seconds
     "thread": "MainThread",
     # spans only:
     "dur_s": 0.0123, "parent": "serve.assign" | None,
     # plus any keyword fields the call site attached}

The ring buffer holds the last ``$REPRO_OBS_RING`` (default 4096)
events, oldest evicted first.  When ``$REPRO_OBS_DIR`` is set,
`flush_jsonl` writes the buffer to ``<dir>/events.jsonl`` atomically
(tmp + rename: a torn write leaves the old file or none) with a final
``{"kind": "snapshot"}`` line
carrying the full metrics snapshot; an atexit hook flushes
best-effort.  `load_jsonl` reads such a file back, skipping corrupt
lines.  ``REPRO_OBS=0`` turns `span` into a shared no-op context
manager and `event` into a flag check.
"""
from __future__ import annotations

import atexit
import json
import os
import tempfile
import threading
import time
import warnings
from collections import deque
from typing import List, Optional

from . import metrics

ENV_DIR = "REPRO_OBS_DIR"
ENV_RING = "REPRO_OBS_RING"
RING_DEFAULT = 4096
JSONL_NAME = "events.jsonl"

__all__ = ["span", "event", "warn_once", "ring_events", "clear",
           "set_ring_size", "flush_jsonl", "load_jsonl",
           "default_jsonl_path"]


def _ring_size() -> int:
    try:
        return max(int(os.environ.get(ENV_RING, RING_DEFAULT)), 1)
    except ValueError:
        return RING_DEFAULT


_ring_lock = threading.Lock()
_ring: deque = deque(maxlen=_ring_size())
_tls = threading.local()


def set_ring_size(n: int) -> None:
    """Re-size the ring buffer, keeping the newest events that fit."""
    global _ring
    with _ring_lock:
        _ring = deque(_ring, maxlen=max(int(n), 1))


def ring_events() -> List[dict]:
    """A copy of the buffered events, oldest first."""
    with _ring_lock:
        return list(_ring)


def clear() -> None:
    with _ring_lock:
        _ring.clear()


def _append(ev: dict) -> None:
    with _ring_lock:
        _ring.append(ev)


def event(name: str, **fields) -> None:
    """Record one point-in-time structured event (drift re-seed, race
    outcome, probe failure).  ``fields`` must be JSON-able-ish; the
    sink serializes unknown types via ``str``."""
    if not metrics.enabled():
        return
    ev = dict(fields)
    ev.update(kind="event", name=name, ts=time.time(),
              thread=threading.current_thread().name)
    _append(ev)


class _Span:
    __slots__ = ("name", "fields", "labels", "_t0", "_parent")

    def __init__(self, name: str, fields: dict, labels: Optional[dict]):
        self.name = name
        self.fields = fields
        self.labels = labels

    def __enter__(self) -> "_Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        _tls.stack.pop()
        ev = dict(self.fields)
        if self.labels:
            ev.update(self.labels)
        ev.update(kind="span", name=self.name, ts=time.time(),
                  dur_s=dur, parent=self._parent,
                  thread=threading.current_thread().name)
        _append(ev)
        # the unlabeled histogram is the aggregate series (what SLO
        # readers key on); labels add a parallel per-label series —
        # e.g. span.serve.assign{replica=r1} next to span.serve.assign
        metrics.histogram("span." + self.name).observe(dur)
        if self.labels:
            metrics.histogram("span." + self.name,
                              **self.labels).observe(dur)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, labels: Optional[dict] = None, **fields):
    """Context manager timing a named scope; see module docstring.

    ``labels`` (a dict, e.g. ``{"replica": "r1"}``) additionally feeds
    a labeled ``span.<name>{k=v}`` histogram next to the unlabeled
    aggregate, so per-replica/per-backend latency separates cleanly in
    `obs.report`; the label values are also attached to the ring event.
    """
    if not metrics.enabled():
        return _NULL_SPAN
    return _Span(name, fields, labels)


# ----------------------------------------------------------- warn-once ---

_WARNED = set()
_warn_lock = threading.Lock()


def warn_once(key: str, message: str, *, category=RuntimeWarning,
              stacklevel: int = 2, **fields) -> bool:
    """One `warnings.warn` + one ``warn.<key>`` ring event per process
    per ``key`` — repeated degradation signals (a broken kernels layer
    probed on every resolve) surface exactly once, with the full
    payload (e.g. the original import error) kept on the event.
    Returns True when this call was the first.  The warning fires even
    under ``REPRO_OBS=0`` (the kill switch silences telemetry, not
    degradation signals)."""
    with _warn_lock:
        if key in _WARNED:
            return False
        _WARNED.add(key)
    event("warn." + key, message=message, **fields)
    warnings.warn(message, category, stacklevel=stacklevel + 1)
    return True


def _reset_warned() -> None:
    with _warn_lock:
        _WARNED.clear()


# ---------------------------------------------------------- JSONL sink ---

def default_jsonl_path() -> Optional[str]:
    d = os.environ.get(ENV_DIR)
    return os.path.join(d, JSONL_NAME) if d else None


def flush_jsonl(path: Optional[str] = None) -> Optional[str]:
    """Write the ring buffer (+ a trailing metrics-snapshot line) to
    ``path`` (default ``$REPRO_OBS_DIR/events.jsonl``) atomically.
    Returns the path written, or None when no sink is configured."""
    path = path if path is not None else default_jsonl_path()
    if path is None:
        return None
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            for ev in ring_events():
                f.write(json.dumps(ev, default=str) + "\n")
            f.write(json.dumps({"kind": "snapshot", "ts": time.time(),
                                "metrics": metrics.snapshot()},
                               default=str) + "\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


def load_jsonl(path: str) -> List[dict]:
    """Events from a JSONL sink file, oldest first.  Corrupt or
    truncated lines are skipped, not raised — a report over a
    partially-written file renders what survives."""
    out: List[dict] = []
    try:
        f = open(path)
    except OSError:
        return out
    with f:
        for line in f:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict):
                out.append(ev)
    return out


def _atexit_flush() -> None:
    try:
        if os.environ.get(ENV_DIR):
            flush_jsonl()
    except Exception:
        pass


atexit.register(_atexit_flush)
