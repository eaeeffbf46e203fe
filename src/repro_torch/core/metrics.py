"""Evaluation metrics (paper §3.5) — counterpart of `repro.core.metrics`
for the fuzzy objective, hard assignment and center matching."""
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
