"""LR schedules as pure functions of the step counter — counterpart of
`repro.optim.schedule`.

Computed in f32 as the reference's ``jnp`` arithmetic is (its Python
constants take f32 first): a Python-float64 learning rate differs in the
last bits and moves every later step.  The result is a 0-d f32 tensor on
the CPU, which the optimizers use as a scalar on any device (no host
sync)."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32)


def linear_warmup(step, warmup: int, peak: float) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.int32)
    return _f32(peak) * torch.clamp((s + 1).to(F32) / max(warmup, 1),
                                    max=1.0)


def cosine_schedule(step, *, peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.int32)
    warm = linear_warmup(s, warmup, peak)
    frac = torch.clamp((s - warmup).to(F32) / max(total - warmup, 1),
                       0.0, 1.0)
    # floor + (1 − floor)·0.5·(1 + cos(π·frac)), the constants rounded
    # to f32 as the reference's weakly typed ones are
    cos = _f32(floor) + _f32((1 - floor) * 0.5) * (
        1 + torch.cos(_f32(math.pi) * frac))
    return torch.where(s < warmup, warm, _f32(peak) * cos)
