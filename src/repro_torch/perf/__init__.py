"""`repro_torch.perf` — the measured performance plane.

Counterpart of `repro.perf`.  Every speed decision the engine makes is
empirical:

  * **microbench** — ERT-style peak probes (streaming-bandwidth triad,
    IEEE-f32 and bf16 matmul) and the `time_fn` harness every other perf
    module times through (it synchronizes the tensors' device).
  * **roofline** — the analytic bytes/FLOPs model of the O(n·c)
    accumulation sweep (`sweep_flops` / `sweep_bytes`) and
    achieved-vs-peak per (backend, shape) (`kernel_roofline` /
    `roofline_report`).  The reference's compiled-program half serves
    the LM dry run and comes with that stack.
  * **calibrate** — the calibration cache behind
    ``resolve_backend("auto", device=..., shape=...)``: a one-shot timed
    race of every registered sweep backend per (device, shape bucket),
    winner persisted on disk (on a CUDA device only the hand-written
    kernel backends may win); the device rule is a fallback only.
  * **autotune** — a search over the free choices of the Hopper
    kernels' launch plan (`kernels.fcm_update.PlanChoice`), the best
    per (device, bucket) persisted in the same file and picked up by the
    kernel wrappers at each launch.

Calibration-file format
-----------------------
One JSON file (default ``$REPRO_CALIB_DIR/calibration_torch.json``, else
``./.cache/perf/calibration_torch.json`` under the current working
directory, beside the reference's ``calibration.json``: each package
keys its file by its own content key and would wipe a shared one),
written atomically (tmp + rename):

    {
      "key": {"format_version": 1, "device": "cuda",
              "device_name": "NVIDIA H100 80GB HBM3", "torch": "...",
              "cuda": "...", "backends": ["hopper", "hopper_accumulate",
                                          "torch", "torch_bf16"]},
      "winners": {"n4096_c8_d16": {"winner": "hopper",
                                   "times_us": {...}, "parity": {...},
                                   "raced_shape": [4096, 8, 16],
                                   "errors": {...}}},
      "tiles":   {"n4096_c8_d16": {"choice": {"split": 1.0, "tile": 1.0,
                                              "dsplit": 1.0},
                                   "plan": {...}, "times_us": {...}, ...}},
      "peaks":   {"stream_bytes_per_s": ..., "matmul_f32_flops_per_s":
                  ..., "matmul_bf16_flops_per_s": ...}
    }

The ``key`` block is the content key: a file whose key does not match
the current process (another device type or card, torch or CUDA
version, or registered-backend set) is discarded wholesale and re-raced
— the invalidation rule; there is no per-entry TTL.  A corrupt or
truncated file is treated as absent (fresh race), never an error.

Shape-bucket rule
-----------------
``shape_bucket(n, c, d)`` rounds every dimension up to the next power
of two (n clamped to [256, 2**20]); one race or tuning result serves
every shape in its bucket.  Races run at the bucket's representative
shape with n capped at 4096 rows; autotuning at the bucket's own N
(`autotune.tune_shape`).

Wiping / refreshing
-------------------
``repro_torch.perf.calibrate.wipe()`` deletes the file and the
in-process memos; ``calibrated_backend_name(..., refresh=True)``
re-races one bucket in place.  Set ``REPRO_AUTO_CALIBRATE=0`` to disable
measured selection (``resolve_backend("auto")`` then takes the device
rule); point ``REPRO_CALIB_DIR`` elsewhere to sandbox the cache (the
tests and ``chip_smoke.py`` do).
"""
from .autotune import tune_sweep_blocks, tuned_blocks
from .calibrate import (calibrated_backend_name, calibration_path,
                        clear_memory_cache, race_backends, shape_bucket,
                        wipe)
from .microbench import (probe_matmul_flops, probe_peaks,
                         probe_stream_bandwidth, time_fn)
from .roofline import (kernel_roofline, roofline_report, sweep_bytes,
                       sweep_flops, sweep_intensity)

__all__ = [
    "tune_sweep_blocks", "tuned_blocks",
    "calibrated_backend_name", "calibration_path", "clear_memory_cache",
    "race_backends", "shape_bucket", "wipe",
    "probe_matmul_flops", "probe_peaks", "probe_stream_bandwidth",
    "time_fn",
    "kernel_roofline", "roofline_report", "sweep_bytes", "sweep_flops",
    "sweep_intensity",
]
