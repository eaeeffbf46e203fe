"""Fixed-shape padding helpers — the port's own copy of two functions of
`repro.data.plane`.

`geom_bucket` and `pad_rows` are numpy-only, but importing
`repro.data.plane` loads jax through `repro/data/__init__.py`, so the
port keeps these copies; the rest of that module (`PartitionPlan`, the
shard batches, the fixed bucket ladder) comes with the out-of-core
slice.
"""
from __future__ import annotations

import numpy as np

__all__ = ["geom_bucket", "pad_rows"]


def pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """Pad ``(n, d)`` to ``(rows, d)`` with phantom zero rows.

    The caller keeps ``n`` and slices the first ``n`` output rows back
    out (scoring) or pairs the pad with zero weights (accumulation), so
    the phantom rows never influence a result.  Returns ``x`` unchanged
    (up to float32 coercion) when it is already ``rows`` tall."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n == rows:
        return x
    if n > rows:
        raise ValueError(f"pad_rows: {n} rows do not fit in {rows}")
    return np.concatenate(
        [x, np.zeros((rows - n, x.shape[1]), np.float32)])


def geom_bucket(n: int, *, base: int = 64, factor: int = 2) -> int:
    """Smallest ``base·factor^k ≥ n`` — the open-ended bucket ladder of
    the tenant plane's row and tenant-count axes."""
    if n <= 0 or base <= 0 or factor < 2:
        raise ValueError(f"bad geometric bucket n={n} base={base} "
                         f"factor={factor}")
    b = base
    while b < n:
        b *= factor
    return b
