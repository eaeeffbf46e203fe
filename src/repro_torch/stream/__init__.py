"""`repro_torch.stream` — online/windowed BigFCM on one device.

Counterpart of `repro.stream`.  See `streaming.StreamingBigFCM` for the
state machine (event-time watermark gate → drift probe with cluster
birth/death → combiner → window merge), `window` for the decayed
sliding-window ring buffer and its event-time bucket routing, and
`drift.DriftDetector` (the port's own copy) for re-seed / birth
triggering.  Stream *sources* live in `repro_torch.data.stream`; the
window merge itself is a `repro_torch.engine.merge_summaries` plan
(``StreamConfig.merge_plan``).
"""
from .drift import DriftConfig, DriftDetector
from .streaming import (IngestReport, StreamConfig, StreamingBigFCM,
                        StreamState, split_item)
from .window import (NO_BUCKET, advance_window, assign_slot,
                     init_slot_buckets, init_window, place_summary,
                     push_summary, window_mass, window_summary)

__all__ = [
    "DriftConfig", "DriftDetector", "IngestReport", "StreamConfig",
    "StreamingBigFCM", "StreamState", "split_item", "NO_BUCKET",
    "advance_window", "assign_slot", "init_slot_buckets", "init_window",
    "place_summary", "push_summary", "window_mass", "window_summary",
]
