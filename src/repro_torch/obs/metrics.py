"""Process-global metrics registry — counters, gauges, log-bucket
histograms.

The registry is the always-on half of `repro_torch.obs`: every hot path
(streaming ingest, chunk reads, checkpoint saves, per-chunk scoring)
increments named metrics here instead of keeping ad-hoc state, and
`repro_torch.obs.report` renders one snapshot of all of them.  Design rules:

  * **Cheap enough to leave enabled.**  A counter add is one global
    flag read, one lock, one float add; a histogram observe is that
    plus a log10 — the <5% streaming-ingest overhead budget
    (`tests/test_obs.py`) holds the layer to it.
  * **Kill switch.**  ``REPRO_OBS=0`` turns every mutation into a
    flag-check-and-return no-op (`set_enabled` flips it at runtime;
    ``None`` re-reads the env), so instrumented code needs no
    ``if obs:`` guards of its own.
  * **Fixed-bucket histograms.**  Latency histograms use log-spaced
    buckets (default 8 per decade over [1e-7 s, 1e3 s]) so p50/p99 are
    derivable from ~80 ints without storing samples — the bucket ratio
    (10^(1/8) ≈ 1.33) bounds the quantile resolution, which
    `tests/test_torch_obs.py` checks against numpy percentiles.
  * **Thread-safe.**  The loader's producer thread, the checkpoint
    writer thread, and the consumer all hit the same metrics; every
    mutation is lock-protected.

Metrics are keyed by (name, sorted labels): ``counter("x", be="torch")``
and ``counter("x", be="hopper")`` are independent series under one
name — how per-backend engine counters stay separable.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, Optional, Tuple

ENV_ENABLE = "REPRO_OBS"

# histogram defaults: seconds, 8 buckets/decade over [100 ns, ~17 min]
HIST_LO = 1e-7
HIST_HI = 1e3
PER_DECADE = 8

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "enabled", "set_enabled", "snapshot", "reset"]


def _env_enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1") not in ("0", "false", "no")


_ENABLED = _env_enabled()


def enabled() -> bool:
    """Whether instrumentation is live this process."""
    return _ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Flip instrumentation at runtime; ``None`` re-reads $REPRO_OBS."""
    global _ENABLED
    _ENABLED = _env_enabled() if on is None else bool(on)


LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """A monotone (float) counter."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def add(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A last-value-wins instantaneous reading (queue depth, center
    count); tracks the max it ever saw for the snapshot."""

    __slots__ = ("name", "labels", "_lock", "_value", "_max")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = float("-inf")

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(v)
            if v > self._max:
                self._max = float(v)

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        return self._max


class Histogram:
    """Fixed log-spaced-bucket histogram (values > 0, e.g. seconds).

    Bucket i ≥ 1 covers ``[lo·r^(i−1), lo·r^i)`` with
    ``r = 10^(1/per_decade)``; bucket 0 is the underflow (< lo, or
    ≤ 0) and the last bucket the overflow (≥ hi).  Quantiles
    log-interpolate inside the landing bucket, so the estimate is
    within a factor r of the exact sample percentile — no samples are
    retained.
    """

    __slots__ = ("name", "labels", "lo", "hi", "per_decade", "_ratio",
                 "_lock", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, labels: LabelKey = (), *,
                 lo: float = HIST_LO, hi: float = HIST_HI,
                 per_decade: int = PER_DECADE):
        if not (0 < lo < hi) or per_decade <= 0:
            raise ValueError(f"bad histogram spec lo={lo} hi={hi} "
                             f"per_decade={per_decade}")
        self.name = name
        self.labels = labels
        self.lo, self.hi, self.per_decade = lo, hi, int(per_decade)
        self._ratio = 10.0 ** (1.0 / per_decade)
        n = int(round(math.log10(hi / lo) * per_decade))
        self._counts = [0] * (n + 2)        # [underflow, n log, overflow]
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def _index(self, v: float) -> int:
        if v < self.lo:                      # includes v <= 0
            return 0
        if v >= self.hi:
            return len(self._counts) - 1
        return 1 + int(math.log10(v / self.lo) * self.per_decade)

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        v = float(v)
        idx = min(self._index(v), len(self._counts) - 1)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 1]) from the bucket counts.

        Log-interpolates within the landing bucket; the underflow and
        overflow buckets answer with the observed min/max (exact
        bounds are tracked)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            total, vmin, vmax = self._count, self._min, self._max
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i == 0:
                    return vmin
                if i == len(counts) - 1:
                    return vmax
                lower = self.lo * self._ratio ** (i - 1)
                frac = (rank - cum) / c
                return min(max(lower * self._ratio ** frac, vmin), vmax)
            cum += c
        return vmax

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}


# ------------------------------------------------------------ registry ---

_LOCK = threading.Lock()
_METRICS: Dict[Tuple[str, LabelKey], object] = {}


def _get(cls, name: str, labels: dict, **kw):
    key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    with _LOCK:
        m = _METRICS.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            _METRICS[key] = m
    if not isinstance(m, cls):
        raise TypeError(f"metric {name!r} already registered as "
                        f"{type(m).__name__}, requested {cls.__name__}")
    return m


def counter(name: str, **labels) -> Counter:
    """The process-global counter named (name, labels) — created on
    first use, shared ever after."""
    return _get(Counter, name, labels)


def gauge(name: str, **labels) -> Gauge:
    return _get(Gauge, name, labels)


def histogram(name: str, **labels) -> Histogram:
    return _get(Histogram, name, labels)


def _label_str(labels: LabelKey) -> str:
    return ("{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            if labels else "")


def snapshot() -> dict:
    """One structured view of every registered metric — the report
    API.  Histogram entries carry count/sum/min/max and p50/p90/p99
    derived from the buckets."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    with _LOCK:
        items = list(_METRICS.values())
    for m in items:
        key = m.name + _label_str(m.labels)
        if isinstance(m, Counter):
            out["counters"][key] = m.value
        elif isinstance(m, Gauge):
            out["gauges"][key] = {"value": m.value, "max": m.max}
        elif isinstance(m, Histogram):
            if m.count:
                entry = {"count": m.count, "sum": m.sum,
                         "min": m._min, "max": m._max}
                entry.update(m.percentiles())
            else:
                entry = {"count": 0, "sum": 0.0}
            out["histograms"][key] = entry
    return out


def reset() -> None:
    """Drop every registered metric (tests; a fresh run's baseline)."""
    with _LOCK:
        _METRICS.clear()
