"""Summary wire codec — how fleet hosts put sketches on the network.

Counterpart of `repro.fleet.wire`: the same frame, byte for byte, for the
same arrays and fingerprint, so a frame written by either package decodes
in the other.  A frame is a magic tag, a JSON header (shapes, wire dtype,
an optional partition-plan fingerprint), then the raw little-endian array
bytes.  No pickle — frames are inspectable, and a host never executes
anything it gathered.

``wire="bf16"`` halves the frame against ``"f32"``: each float32 is
rounded to bfloat16 (float32's exponent, an 8-bit significand) before the
bytes leave the host and widened back to float32 on decode.  The
reference casts with ``ml_dtypes``; this copy rounds on the float32 bit
patterns itself, with numpy on ``uint32`` → ``uint16`` words:
round-to-nearest, ties to even, and a NaN becomes the quiet NaN of its
sign, as ``ml_dtypes`` gives.  Decoding shifts each word into the high
half of a float32.  Round-to-nearest obeys the elementwise bound

    |decode(encode(x)) - x| ≤ 2⁻⁸·|x|        (= eps_bf16 / 2)

which `tests/test_torch_fleet.py` pins.  A summary is exchanged once per
fit, not iterated, so the bound above is the whole story.

Encoding takes tensors (any device) or numpy arrays; decoding gives
float32 tensors on the CPU.
"""
from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..engine import Summary

MAGIC = b"FLW1"
# bf16 travels as its uint16 bit patterns (numpy has no bfloat16 type)
WIRE_DTYPES = {
    "f32": np.dtype("<f4"),
    "bf16": np.dtype("<u2"),
}
# round-to-nearest into bf16's 8-bit significand: rel err ≤ eps/2 = 2^-8
BF16_REL_BOUND = 2.0 ** -8


def _host_f32(a) -> np.ndarray:
    """``a`` (a tensor on any device, or array-like) as a C-ordered
    float32 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a, np.float32)


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit patterns (uint16), round-to-nearest-even;
    a NaN becomes the quiet NaN of its sign."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    lsb = (b >> np.uint32(16)) & np.uint32(1)
    out = ((b + np.uint32(0x7FFF) + lsb) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        sign = ((b[nan] >> np.uint32(16)) & np.uint32(0x8000))
        out[nan] = (sign | np.uint32(0x7FC0)).astype(np.uint16)
    return out


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) → float32, exactly."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _encode(a: np.ndarray, wire: str) -> bytes:
    if wire == "bf16":
        return to_bf16_bits(a).astype(WIRE_DTYPES[wire]).tobytes()
    return a.astype(WIRE_DTYPES[wire]).tobytes()


def _decode(body: bytes, wire: str) -> np.ndarray:
    """The float32 values of one encoded array (a fresh, writable
    copy)."""
    a = np.frombuffer(body, WIRE_DTYPES[wire])
    return from_bf16_bits(a) if wire == "bf16" else a.astype(np.float32)


def encode_summary(s: Summary, *, wire: str = "f32",
                   fingerprint: Optional[str] = None) -> bytes:
    """Frame a summary (single or stacked) for the wire."""
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire!r}; "
                         f"one of {sorted(WIRE_DTYPES)}")
    centers = _host_f32(s.centers)
    masses = _host_f32(s.masses)
    header = json.dumps({
        "wire": wire,
        "centers": list(centers.shape),
        "masses": list(masses.shape),
        "plan": fingerprint,
    }).encode()
    frame = (MAGIC + struct.pack("<I", len(header)) + header
             + _encode(centers, wire) + _encode(masses, wire))
    obs.counter("fleet.exchange.bytes", wire=wire).add(len(frame))
    return frame


def decode_summary(frame: bytes) -> Tuple[Summary, Optional[str]]:
    """Inverse of `encode_summary` → (float32 Summary on the CPU,
    fingerprint)."""
    if frame[:4] != MAGIC:
        raise ValueError("not a fleet summary frame (bad magic)")
    (hlen,) = struct.unpack("<I", frame[4:8])
    header = json.loads(frame[8:8 + hlen].decode())
    wire = header["wire"]
    c_shape = tuple(header["centers"])
    m_shape = tuple(header["masses"])
    body = frame[8 + hlen:]
    n_c = int(np.prod(c_shape, dtype=np.int64)) * WIRE_DTYPES[wire].itemsize
    centers = _decode(body[:n_c], wire).reshape(c_shape)
    masses = _decode(body[n_c:], wire).reshape(m_shape)
    return (Summary(torch.from_numpy(centers), torch.from_numpy(masses)),
            header.get("plan"))
