"""SPMD summary exchange — the fleet reduction as one mesh collective.

Counterpart of `repro.fleet.spmd`.  When the "hosts" are the ranks of
one `repro_torch.mesh` device mesh (a ``torchrun`` job, or `spawn_mesh`
on one machine), the transport layer disappears: the exchange is an
all-gather of each rank's summary followed by the same pairwise merge
`FleetHost.exchange` runs, on every rank, whose result is therefore the
same on every rank.

Quantized exchange casts to the wire dtype BEFORE the gather (bf16
halves the bytes the interconnect moves — the cast is the compression)
and widens to float32 after.  The cast is `repro_torch.fleet.wire`'s
round-to-nearest-even on the float32 bit patterns, so
`wire.BF16_REL_BOUND` bounds the per-element error as it does for a
frame.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..engine import MergePlan, Summary, merge_summaries
from ..mesh import agreed_backend, all_gather, rank_device, shard_rows
from .wire import to_bf16_bits


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 by `wire.to_bf16_bits`, as a bfloat16
    tensor on ``t``'s device."""
    bits = to_bf16_bits(t.detach().cpu().numpy()).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(t.device)


def mesh_exchange(
    stacked: Summary,
    mesh,
    *,
    axis: str = "data",
    plan: Optional[MergePlan] = None,
    wire_dtype=None,
    backend=None,
) -> Summary:
    """Merge per-rank summaries into one global summary, the same on
    every rank.

    ``stacked`` is the (H, C, d)/(H, C) stack whose leading axis is
    sharded over ``axis`` — one summary per mesh position; each rank
    takes its own (its block's first) and casts it to the wire.
    ``wire_dtype`` ``"bf16"`` (or ``torch.bfloat16``) quantizes the
    gather's wire format.  Returns the merged (C, d)/(C,) summary on this
    rank's device."""
    plan = plan or MergePlan("pairwise")
    if plan.topology != "pairwise":
        raise ValueError("mesh_exchange runs the fleet reduction — a "
                         f"pairwise plan — got {plan.topology!r}")
    dev = rank_device(mesh)
    c = shard_rows(stacked.centers, mesh, axis)[0]      # my (C, d) slot
    w = shard_rows(stacked.masses, mesh, axis)[0]
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    if wire_dtype in ("bf16", torch.bfloat16):
        c, w = _bf16(c), _bf16(w)       # bytes shrink before the wire
    elif wire_dtype not in (None, "f32", torch.float32):
        raise ValueError(f"unsupported wire dtype {wire_dtype!r}: "
                         "f32 or bf16")
    gathered = Summary(all_gather(c, mesh, axis).float(),
                       all_gather(w, mesh, axis).float())
    be = agreed_backend(backend, mesh,
                        shape=(int(gathered.masses.numel()),
                               int(c.shape[0]), int(c.shape[1])))
    return merge_summaries(gathered, plan, backend=be).summary
