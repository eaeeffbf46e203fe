"""The (centers, masses) summary — the one currency every layer trades in.

Counterpart of `repro.engine.summary`.  Once a chunk of records has been
clustered locally, everything downstream needs only the C centers and
their accumulated fuzzy masses Σ_k w_k·u_ik^m.  The canonical shape is a
stack: ``centers`` (S, C, d) with ``masses`` (S, C), S slots.

A slot with all-zero masses is a **phantom**: its points carry weight 0
and vanish from every accumulation.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from ..device import as_real, resolve_device


class Summary(NamedTuple):
    """A weighted center sketch (or a stack of them on a leading axis)."""
    centers: torch.Tensor   # (..., C, d) real_dtype (float32)
    masses: torch.Tensor    # (..., C)    Σ_k w_k·u_ik^m per center


def summary(centers, masses, *,
            device: Union[str, torch.device] = "cuda") -> Summary:
    """Build a Summary of `real_dtype` tensors on ``device``."""
    dev = resolve_device(device)
    return Summary(as_real(centers, dev), as_real(masses, dev))


def stack(summaries: Sequence[Summary]) -> Summary:
    """Stack single summaries into the canonical (S, C, d)/(S, C) form."""
    return Summary(torch.stack([s.centers for s in summaries]),
                   torch.stack([s.masses for s in summaries]))


def concat(summaries: Sequence[Summary]) -> Summary:
    """Concatenate summaries along the slot axis — (S_i, C, d) stacks
    and/or single (C, d) summaries (promoted to one-slot stacks) become
    one (ΣS_i, C, d) stack.  Zero-slot stacks are legal and vanish."""
    cs = [s.centers if s.centers.dim() == 3 else s.centers[None]
          for s in summaries]
    ms = [s.masses if s.masses.dim() == 2 else s.masses[None]
          for s in summaries]
    if not cs:
        raise ValueError("concat: empty summary sequence")
    return Summary(torch.cat(cs, dim=0), torch.cat(ms, dim=0))


def phantom(n_clusters: int, d: int, *, slots: int = 0,
            device: Union[str, torch.device] = "cuda") -> Summary:
    """All-zero summary (or ``slots`` of them): contributes nothing to any
    merge — the init value for progressive merges."""
    dev = resolve_device(device)
    shape = (slots,) if slots else ()
    return Summary(torch.zeros(shape + (n_clusters, d), device=dev),
                   torch.zeros(shape + (n_clusters,), device=dev))


def total_mass(s: Summary) -> torch.Tensor:
    """Total record mass held by the summary."""
    return torch.sum(s.masses)


def slot_masses(s: Summary) -> torch.Tensor:
    """Per-slot total mass of a stacked summary — (S,)."""
    return torch.sum(s.masses, dim=-1)
