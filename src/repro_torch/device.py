"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a `torch.device`; raises when CUDA is asked for and
    absent, so no entry point carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' for the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev


def real_dtype() -> torch.dtype:
    """The plain path's working float type: torch's default, float32
    unless a caller sets float64 (`torch.set_default_dtype`) for an
    exact reference run on the ``torch`` backend.  The kernels take
    float32 only."""
    return torch.get_default_dtype()


def as_real(a, device: torch.device) -> torch.Tensor:
    """``a`` (numpy array or tensor) as a `real_dtype` tensor on
    ``device``."""
    return torch.as_tensor(a, dtype=real_dtype(), device=device)


def copy_real(a, device: torch.device) -> torch.Tensor:
    """``a`` (numpy array, a read-only memmap included, or tensor) copied
    into a `real_dtype` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, real_dtype())
    return torch.tensor(np.asarray(a), dtype=real_dtype(), device=device)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``FakeTensorMode`` tensor (the dry run traces
    on them): shapes without data, so nothing of it can be read on the
    host."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)
