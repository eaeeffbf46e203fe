"""Offline-synthesized analogues of the paper's datasets (numpy only).

The port's own copy of the generators in `repro.data.synth` that its
main path and its checks use: SUSY / HIGGS / KDD99 emulated by
Gaussian-mixture generators with the matching dimensionality and class
structure, Pima's two overlapping classes (`pima_like`), the drifting
stream `make_moving_blobs`, and Fisher's Iris embedded verbatim (150
records, public domain).  Same seeds, same arrays as the reference.
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


def pima_like(n: int = 768, *, seed: int = 0):
    """Pima analogue: 8 features, 2 partially-overlapping classes (paper
    reports ~66% accuracy)."""
    return make_blobs(n, 8, 2, spread=1.0, sep=1.1, seed=seed)


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


def iris() -> Tuple[np.ndarray, np.ndarray]:
    """Fisher's Iris, embedded (sepal-l, sepal-w, petal-l, petal-w)."""
    x = np.array(_IRIS, np.float32).reshape(150, 4)
    y = np.repeat(np.arange(3, dtype=np.int32), 50)
    return x, y


_IRIS = [
    5.1,3.5,1.4,0.2,4.9,3.0,1.4,0.2,4.7,3.2,1.3,0.2,4.6,3.1,1.5,0.2,
    5.0,3.6,1.4,0.2,5.4,3.9,1.7,0.4,4.6,3.4,1.4,0.3,5.0,3.4,1.5,0.2,
    4.4,2.9,1.4,0.2,4.9,3.1,1.5,0.1,5.4,3.7,1.5,0.2,4.8,3.4,1.6,0.2,
    4.8,3.0,1.4,0.1,4.3,3.0,1.1,0.1,5.8,4.0,1.2,0.2,5.7,4.4,1.5,0.4,
    5.4,3.9,1.3,0.4,5.1,3.5,1.4,0.3,5.7,3.8,1.7,0.3,5.1,3.8,1.5,0.3,
    5.4,3.4,1.7,0.2,5.1,3.7,1.5,0.4,4.6,3.6,1.0,0.2,5.1,3.3,1.7,0.5,
    4.8,3.4,1.9,0.2,5.0,3.0,1.6,0.2,5.0,3.4,1.6,0.4,5.2,3.5,1.5,0.2,
    5.2,3.4,1.4,0.2,4.7,3.2,1.6,0.2,4.8,3.1,1.6,0.2,5.4,3.4,1.5,0.4,
    5.2,4.1,1.5,0.1,5.5,4.2,1.4,0.2,4.9,3.1,1.5,0.2,5.0,3.2,1.2,0.2,
    5.5,3.5,1.3,0.2,4.9,3.6,1.4,0.1,4.4,3.0,1.3,0.2,5.1,3.4,1.5,0.2,
    5.0,3.5,1.3,0.3,4.5,2.3,1.3,0.3,4.4,3.2,1.3,0.2,5.0,3.5,1.6,0.6,
    5.1,3.8,1.9,0.4,4.8,3.0,1.4,0.3,5.1,3.8,1.6,0.2,4.6,3.2,1.4,0.2,
    5.3,3.7,1.5,0.2,5.0,3.3,1.4,0.2,7.0,3.2,4.7,1.4,6.4,3.2,4.5,1.5,
    6.9,3.1,4.9,1.5,5.5,2.3,4.0,1.3,6.5,2.8,4.6,1.5,5.7,2.8,4.5,1.3,
    6.3,3.3,4.7,1.6,4.9,2.4,3.3,1.0,6.6,2.9,4.6,1.3,5.2,2.7,3.9,1.4,
    5.0,2.0,3.5,1.0,5.9,3.0,4.2,1.5,6.0,2.2,4.0,1.0,6.1,2.9,4.7,1.4,
    5.6,2.9,3.6,1.3,6.7,3.1,4.4,1.4,5.6,3.0,4.5,1.5,5.8,2.7,4.1,1.0,
    6.2,2.2,4.5,1.5,5.6,2.5,3.9,1.1,5.9,3.2,4.8,1.8,6.1,2.8,4.0,1.3,
    6.3,2.5,4.9,1.5,6.1,2.8,4.7,1.2,6.4,2.9,4.3,1.3,6.6,3.0,4.4,1.4,
    6.8,2.8,4.8,1.4,6.7,3.0,5.0,1.7,6.0,2.9,4.5,1.5,5.7,2.6,3.5,1.0,
    5.5,2.4,3.8,1.1,5.5,2.4,3.7,1.0,5.8,2.7,3.9,1.2,6.0,2.7,5.1,1.6,
    5.4,3.0,4.5,1.5,6.0,3.4,4.5,1.6,6.7,3.1,4.7,1.5,6.3,2.3,4.4,1.3,
    5.6,3.0,4.1,1.3,5.5,2.5,4.0,1.3,5.5,2.6,4.4,1.2,6.1,3.0,4.6,1.4,
    5.8,2.6,4.0,1.2,5.0,2.3,3.3,1.0,5.6,2.7,4.2,1.3,5.7,3.0,4.2,1.2,
    5.7,2.9,4.2,1.3,6.2,2.9,4.3,1.3,5.1,2.5,3.0,1.1,5.7,2.8,4.1,1.3,
    6.3,3.3,6.0,2.5,5.8,2.7,5.1,1.9,7.1,3.0,5.9,2.1,6.3,2.9,5.6,1.8,
    6.5,3.0,5.8,2.2,7.6,3.0,6.6,2.1,4.9,2.5,4.5,1.7,7.3,2.9,6.3,1.8,
    6.7,2.5,5.8,1.8,7.2,3.6,6.1,2.5,6.5,3.2,5.1,2.0,6.4,2.7,5.3,1.9,
    6.8,3.0,5.5,2.1,5.7,2.5,5.0,2.0,5.8,2.8,5.1,2.4,6.4,3.2,5.3,2.3,
    6.5,3.0,5.5,1.8,7.7,3.8,6.7,2.2,7.7,2.6,6.9,2.3,6.0,2.2,5.0,1.5,
    6.9,3.2,5.7,2.3,5.6,2.8,4.9,2.0,7.7,2.8,6.7,2.0,6.3,2.7,4.9,1.8,
    6.7,3.3,5.7,2.1,7.2,3.2,6.0,1.8,6.2,2.8,4.8,1.8,6.1,3.0,4.9,1.8,
    6.4,2.8,5.6,2.1,7.2,3.0,5.8,1.6,7.4,2.8,6.1,1.9,7.9,3.8,6.4,2.0,
    6.4,2.8,5.6,2.2,6.3,2.8,5.1,1.5,6.1,2.6,5.6,1.4,7.7,3.0,6.1,2.3,
    6.3,3.4,5.6,2.4,6.4,3.1,5.5,1.8,6.0,3.0,4.8,1.8,6.9,3.1,5.4,2.1,
    6.7,3.1,5.6,2.4,6.9,3.1,5.1,2.3,5.8,2.7,5.1,1.9,6.8,3.2,5.9,2.3,
    6.7,3.3,5.7,2.5,6.7,3.0,5.2,2.3,6.3,2.5,5.0,1.9,6.5,3.0,5.2,2.0,
    6.2,3.4,5.4,2.3,5.9,3.0,5.1,1.8,
]
