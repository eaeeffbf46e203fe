"""`repro_torch` — BigFCM on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package `repro`, module for module: each module here
names the reference module it counts as, and its tests hold it to that
module on identical inputs.  It imports `torch` and numpy only, never
`jax` and nothing of `repro`.

Entry points take an explicit ``device`` (default ``"cuda"``).  Asking
for CUDA on a host without a card raises; the plain CPU path runs only
when the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
