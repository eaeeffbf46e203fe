"""Offline-synthesized analogues of the paper's datasets (numpy only).

The port's own copy of the generators in `repro.data.synth` that its
main path and its checks use: SUSY / HIGGS / KDD99 emulated by
Gaussian-mixture generators with the matching dimensionality and class
structure, and the drifting stream `make_moving_blobs`.  Same seeds,
same arrays as the reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_blobs(n: int, d: int, c: int, *, spread: float = 1.0,
               sep: float = 6.0, seed: int = 0,
               weights=None) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian mixture with c well-separated components. → (x, labels)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, sep, size=(c, d)).astype(np.float32)
    if weights is None:
        weights = np.full((c,), 1.0 / c)
    weights = np.asarray(weights) / np.sum(weights)
    labels = rng.choice(c, size=(n,), p=weights).astype(np.int32)
    x = centers[labels] + rng.normal(0.0, spread, size=(n, d)).astype(np.float32)
    return x.astype(np.float32), labels


def _blobs_with_independent_labels(n, d, c_struct, *, seed):
    """Feature-space cluster structure DECOUPLED from the class labels —
    the HIGGS/SUSY phenomenon the paper's Tables 7+8 jointly imply:
    clustering finds real structure (silhouette > 0, Table 8) yet a
    2-cluster split carries no signal/background information (50%
    confusion accuracy, Table 7).  Each mixture component is split
    50/50 between the two labels."""
    x, comp = make_blobs(n, d, c_struct, spread=1.0, sep=4.0, seed=seed)
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, 2, size=(n,)).astype(np.int32)
    return x, labels


def make_susy_like(n: int, *, seed: int = 0):
    """SUSY analogue: 18 features; clusters ⟂ signal/background labels
    (paper reports exactly 50% confusion accuracy on SUSY)."""
    return _blobs_with_independent_labels(n, 18, 4, seed=seed)


def make_higgs_like(n: int, *, seed: int = 0):
    """HIGGS analogue: 28 features; clusters ⟂ labels (paper: 50%)."""
    return _blobs_with_independent_labels(n, 28, 4, seed=seed)


def make_kdd_like(n: int, *, seed: int = 0):
    """KDD99 analogue: 41 numeric features, 23 imbalanced classes
    (KDD99's class histogram is dominated by smurf/neptune/normal)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.6, size=4096).astype(np.float64)
    hist = np.bincount(np.minimum(raw, 23).astype(int) - 1, minlength=23)
    weights = np.maximum(hist, 1).astype(np.float64)
    return make_blobs(n, 41, 23, spread=0.7, sep=4.0, seed=seed,
                      weights=weights)


def make_moving_blobs(n_chunks: int, chunk: int, d: int, c: int, *,
                      drift_at: int, shift: float = 8.0,
                      spread: float = 1.0, sep: float = 6.0, seed: int = 0,
                      drift_clusters=None):
    """Drifting stream: yields ``(x, labels)`` chunks from a Gaussian
    mixture whose component means jump by ``shift`` (L2, random
    directions) starting at chunk index ``drift_at`` — the synthetic
    regime-change workload for `repro_torch.stream` drift detection.

    ``drift_clusters`` selects WHICH components jump (default: all —
    global regime change, the full re-seed workload).  A partial list
    like ``(0,)`` is the *cluster-birth/death* workload: the moved
    component's records reappear far away (a new mode is born) while
    its old center starves and should be retired, with the rest of the
    mixture untouched.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, sep, size=(c, d)).astype(np.float32)
    delta = rng.normal(size=(c, d))
    delta = (delta / np.linalg.norm(delta, axis=1, keepdims=True)
             * shift).astype(np.float32)
    if drift_clusters is not None:
        mask = np.zeros((c, 1), np.float32)
        mask[np.asarray(drift_clusters, int)] = 1.0
        delta = delta * mask
    for t in range(n_chunks):
        ctr = centers + delta if t >= drift_at else centers
        labels = rng.integers(0, c, size=(chunk,)).astype(np.int32)
        x = ctr[labels] + rng.normal(0.0, spread,
                                     size=(chunk, d)).astype(np.float32)
        yield x.astype(np.float32), labels
