"""Payload checksums — port of brpc_tpu/ops/checksum.py.

Both sums are defined mod 2^32.  torch's uint32 support is narrow: a sum
over uint32 promotes to int64 and does not wrap, and uint32 arithmetic is
missing on several backends.  So the lanes are read as int64 (from their
int32 bits for a uint32 payload, which is the same value mod 2^32), summed
there and masked to 32 bits.  The results are 0-dim (sum32) and 2-lane
(fletcher32) uint32 tensors on the input's device, like the reference's.

Lanes convert as the reference's `astype(jnp.uint32)` does: integer and
bool lanes wrap mod 2^32; floating lanes saturate (NaN and everything
below 1 to 0, 2^32 and above to 2^32 - 1, the rest truncated toward
zero).  The clamp is explicit and in float64, which holds every f16, bf16
and f32 value and 2^32 - 1 exactly: an out-of-range float-to-integer cast
gives different values on the CPU and the GPU.  A float64 lane is rounded
to float32 first, as `jnp.asarray` does in 32-bit mode.

Plain torch, as the reference is plain jnp; the fused echo kernel
(ops/echo_kernel.py) computes sum32 inside its copy pass.
"""

from __future__ import annotations

import torch

__all__ = ["as_u32", "sum32", "fletcher32"]

_MASK = 0xFFFFFFFF


def _lanes_i64(x: torch.Tensor) -> torch.Tensor:
    """The payload's lanes as int64 that equal `astype(uint32)` mod 2^32."""
    flat = x.reshape(-1)
    if flat.dtype == torch.uint32:
        flat = flat.view(torch.int32)
    elif flat.is_floating_point():
        if flat.dtype == torch.float64:
            flat = flat.to(torch.float32)
        wide = torch.nan_to_num(flat.to(torch.float64), nan=0.0,
                                posinf=float(_MASK), neginf=0.0)
        return wide.clamp(0.0, float(_MASK)).to(torch.int64)
    return flat.to(torch.int64)


def _u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values already masked to [0, 2^32) as uint32, by way of the
    int32 bits (no uint32 conversion kernel needed on any backend)."""
    return (v - ((v >> 31) << 32)).to(torch.int32).view(torch.uint32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The payload's lanes as a flat uint32 tensor, `x.astype(jnp.uint32)
    .ravel()` of the reference."""
    return _u32(_lanes_i64(x) & _MASK)


def sum32(x: torch.Tensor) -> torch.Tensor:
    """Plain 32-bit wrapping sum of the payload (fast integrity check)."""
    return _u32(_lanes_i64(x).sum() & _MASK)


def fletcher32(x: torch.Tensor) -> torch.Tensor:
    """Fletcher-like checksum: (sum, position-weighted sum), uint32[2].

    Position weighting catches reorderings a plain sum misses.  Each
    product v*idx is masked before the sum, which keeps the int64 sum
    exact (n < 2^31 lanes) and equal to the reference's wrapping uint32
    product sum."""
    v = _lanes_i64(x) & _MASK
    idx = torch.arange(1, v.shape[0] + 1, dtype=torch.int64, device=v.device)
    weighted = ((v * (idx & _MASK)) & _MASK).sum()
    return _u32(torch.stack([v.sum(), weighted]) & _MASK)
