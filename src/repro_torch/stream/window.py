"""Sliding-window summary ring buffer (the reducer over *time*).

Counterpart of `repro.stream.window`.  BigFCM's reducer merges a handful
of (C centers, C masses) pairs — a few KB regardless of how much data
produced them.  That same sketch works as a *window slot*: each ingested
mini-batch leaves one slot behind, old slots decay exponentially (mass
×= ``decay`` per push), and the global model is a
`repro_torch.engine.merge_summaries` reduce over the live slots
(topology per `StreamConfig.merge_plan`: ``windowed`` by default, one
WFCM accumulating raw per-slot sums through the backend's accumulate
entry — K1 at C points per slot under ``hopper``).

A slot with zero total mass is a phantom: its points carry weight 0 and
vanish from every accumulation, so resetting a window is just zeroing
its masses.

Where the pieces live: the (W, C, d) / (W, C) ring tensors on the
model's device, beside the centers the sweeps read; the per-slot bucket
ids (W,) int32 on the host (CPU), because the state machine branches on
them and reading them there costs no device sync.  The reference's
functions are pure (jnp arrays in, new arrays out); these are too —
nothing is updated in place.

**Event-time mode** (`StreamConfig.event_time`) re-keys the ring by
*event-time bucket* instead of arrival order: bucket
``b = floor(t / slot_span)`` owns ring slot ``b mod W``
(`assign_slot`), the head bucket follows the max event time seen, and
decay is applied per *bucket advance* rather than per push
(`advance_window`).  A summary landing in an already-occupied slot of
the SAME bucket *merges into* the slot through the engine's raw
accumulate entry (`place_summary` with a ``windowed`` plan: two slots of
C points) instead of overwriting it, so a late summary scaled by the
decay it missed is equivalent to having pushed it on time (WFCM is
homogeneous in the point weights).
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from ..device import real_dtype, resolve_device
from ..engine import MergePlan, Summary, merge_summaries

# Sentinel bucket id for a ring slot that has never been filled (any
# real bucket id compares greater).
NO_BUCKET = -(2 ** 31 - 1)


def init_window(window: int, n_clusters: int, d: int, *,
                device: Union[str, torch.device] = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty ring buffer on ``device``: (W, C, d) centers, (W, C) masses
    (all phantom), in `real_dtype`."""
    dev = resolve_device(device)
    return (torch.zeros((window, n_clusters, d), dtype=real_dtype(),
                        device=dev),
            torch.zeros((window, n_clusters), dtype=real_dtype(),
                        device=dev))


def push_summary(win_c: torch.Tensor, win_w: torch.Tensor, cursor,
                 centers: torch.Tensor, weights: torch.Tensor, *,
                 decay: float):
    """Decay every live slot, overwrite the cursor slot, advance the
    cursor (an int or a 0-d integer tensor; returned as the same kind)."""
    i = int(cursor)
    win_w = win_w * decay
    win_c = win_c.clone()
    win_c[i] = centers
    win_w[i] = weights
    return win_c, win_w, (cursor + 1) % win_c.shape[0]


def window_summary(win_c: torch.Tensor, win_w: torch.Tensor) -> Summary:
    """View the ring buffer as a stacked engine `Summary` (free)."""
    return Summary(win_c, win_w)


def window_mass(win_w: torch.Tensor) -> torch.Tensor:
    """Total live (decayed) record mass across the window."""
    return torch.sum(win_w)


# ------------------------------------------------------------ event time --

def init_slot_buckets(window: int) -> torch.Tensor:
    """Per-slot bucket ids (host int32) of an empty event-time ring — all
    NO_BUCKET."""
    return torch.full((window,), NO_BUCKET, dtype=torch.int32)


def assign_slot(event_time: float, watermark: float, *, slot_span: float,
                window: int) -> Tuple[int, int, bool]:
    """Route an event time to its window slot under a watermark.

    Returns ``(bucket, slot, late)``: the event-time bucket
    ``floor(t / slot_span)``, its ring slot ``bucket mod window``, and
    whether the event time is already behind the watermark (too late —
    the caller drops and counts it rather than corrupting a recycled
    slot).
    """
    bucket = int(math.floor(event_time / slot_span))
    return bucket, bucket % window, bool(event_time < watermark)


def advance_window(win_w: torch.Tensor, slot_buckets: torch.Tensor,
                   head_bucket: int, bucket: int, *, decay: float
                   ) -> torch.Tensor:
    """Advance the head to ``bucket`` (> head): decay every live slot
    once per bucket crossed and zero slots that fell out of the W-bucket
    span (their ring position now belongs to a newer bucket).  Returns
    the updated masses; centers need no touch (zero mass is a phantom)."""
    factor = torch.tensor(decay, dtype=win_w.dtype) ** (bucket - head_bucket)
    win_w = win_w * factor.to(win_w.device)
    live = slot_buckets > bucket - win_w.shape[0]
    return win_w * live[:, None].to(win_w.device, win_w.dtype)


def place_summary(win_c: torch.Tensor, win_w: torch.Tensor,
                  slot_buckets: torch.Tensor, slot: int, bucket: int,
                  centers: torch.Tensor, weights: torch.Tensor, *,
                  plan: MergePlan, backend=None, scale: float = 1.0):
    """Land one mini-batch summary in its event-time slot.

    ``scale`` is the decay the summary missed (``decay**(head−bucket)``
    for a late arrival) so late and on-time placement commute with
    `advance_window`.  An empty slot is set; an occupied slot of the
    same bucket is *merged into* via the engine's accumulate entry (the
    ``windowed`` plan) — never overwritten.  Returns the new
    ``(win_c, win_w, slot_buckets)``.
    """
    w_in = weights.to(win_w.dtype) * torch.tensor(
        scale, dtype=win_w.dtype, device=weights.device)
    if (int(slot_buckets[slot]) == bucket
            and float(torch.sum(win_w[slot])) > 0.0):
        merged = merge_summaries(
            Summary(torch.stack([win_c[slot], centers.to(win_c.dtype)]),
                    torch.stack([win_w[slot], w_in])),
            plan, backend=backend).summary
        c_new, w_new = merged.centers, merged.masses
    else:
        c_new, w_new = centers.to(win_c.dtype), w_in
    win_c, win_w, slot_buckets = (win_c.clone(), win_w.clone(),
                                  slot_buckets.clone())
    win_c[slot], win_w[slot], slot_buckets[slot] = c_new, w_new, bucket
    return win_c, win_w, slot_buckets
