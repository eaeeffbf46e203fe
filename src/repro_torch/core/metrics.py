"""Evaluation metrics (paper §3.5) — counterpart of `repro.core.metrics`:
the fuzzy objective and hard assignment on the device, and numpy copies
of confusion-matrix accuracy, silhouette width, relative speedup and
center matching."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..device import as_real, resolve_device
from .fcm import hard_assign, membership_terms, pairwise_sqdist


def fuzzy_objective(x, centers, m=2.0, point_weights=None) -> torch.Tensor:
    """Paper Eq. (2) on the device the tensors lie on."""
    w = (torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
         if point_weights is None else point_weights)
    um = membership_terms(x, centers, m) * w[:, None]
    return torch.sum(um * pairwise_sqdist(x, centers))


def clustering_accuracy(labels: np.ndarray, assignments: np.ndarray,
                        n_clusters: int) -> float:
    """Confusion-matrix accuracy: each cluster mapped to its majority
    class (a many-to-one ``argmax`` of the confusion row), the mapped
    counts summed over all records."""
    labels = np.asarray(labels)
    assignments = np.asarray(assignments)
    n_classes = int(labels.max()) + 1
    conf = np.zeros((n_clusters, n_classes), np.int64)
    for c in range(n_clusters):
        mask = assignments == c
        if mask.any():
            conf[c] = np.bincount(labels[mask], minlength=n_classes)
    mapping = conf.argmax(axis=1)
    correct = sum(conf[c, mapping[c]] for c in range(n_clusters))
    return float(correct) / float(len(labels))


def silhouette_width(x: np.ndarray, assignments: np.ndarray,
                     max_points: int = 4096, seed: int = 0) -> float:
    """Mean silhouette s(i) = (b−a)/max(a,b) on a uniform subsample of
    ``max_points`` records (``default_rng(seed)``; f32 distances)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    assignments = np.asarray(assignments)
    if x.shape[0] > max_points:
        idx = rng.choice(x.shape[0], max_points, replace=False)
        x, assignments = x[idx], assignments[idx]
    d = np.sqrt(np.maximum(
        (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2 * x @ x.T,
        0.0))
    labels = np.unique(assignments)
    n = x.shape[0]
    s = np.zeros(n)
    for i in range(n):
        same = assignments == assignments[i]
        same[i] = False
        a = d[i, same].mean() if same.any() else 0.0
        b = np.inf
        for lab in labels:
            if lab == assignments[i]:
                continue
            other = assignments == lab
            if other.any():
                b = min(b, d[i, other].mean())
        s[i] = 0.0 if not np.isfinite(b) or max(a, b) == 0 else (b - a) / max(a, b)
    return float(s.mean())


def relative_speedup(t_baseline: float, t_method: float) -> float:
    return t_baseline / max(t_method, 1e-12)


def assign(x, centers, *,
           device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Nearest-center index of every record, as a numpy array."""
    dev = resolve_device(device)
    return hard_assign(as_real(x, dev), as_real(centers, dev)).cpu().numpy()


def match_centers(found: np.ndarray, truth: np.ndarray) -> float:
    """Mean distance after greedy 1:1 matching of found→truth centers
    (center-recovery error for synthetic mixtures)."""
    found = np.asarray(found, np.float64)
    truth = np.asarray(truth, np.float64)
    d = np.linalg.norm(found[:, None] - truth[None], axis=-1)
    total, used_r, used_c = 0.0, set(), set()
    for _ in range(min(d.shape)):
        masked = d.copy()
        masked[list(used_r), :] = np.inf
        masked[:, list(used_c)] = np.inf
        r, c = np.unravel_index(np.argmin(masked), d.shape)
        total += d[r, c]
        used_r.add(int(r))
        used_c.add(int(c))
    return total / min(d.shape)
