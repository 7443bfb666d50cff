"""The plain reference the program's outputs are judged by.

Plain NumPy and PyTorch, worked out again from the inputs that rpcbench
made: it imports nothing of the program and takes nothing the program made.
It reads the program's outputs only to judge them.

- An echo returns the payload's bytes unchanged, and its checksum is the
  32-bit wrapping sum of the payload's uint32 lanes.
- A gather over n peers gives every peer the n chunks stacked in peer
  order along the first axis.

`lossy_*` are the same work one step down in precision (the control that
every limit must reject): lanes through float32, sums in float32, chunks
through bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF


def wrapping_sum(lanes: np.ndarray) -> int:
    """Sum of uint32 lanes mod 2^32, exact (uint64 accumulation of at most
    2^32 lanes cannot overflow).  [1, 2, 3] -> 6; [2^32 - 1, 2] -> 1."""
    lanes = np.asarray(lanes)
    if lanes.dtype != np.uint32:
        raise TypeError(f"uint32 lanes, got {lanes.dtype}")
    return int(lanes.sum(dtype=np.uint64)) & MASK


def u32_lanes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a flat uint32 NumPy array on the host."""
    return t.detach().reshape(-1).view(torch.int32).cpu().numpy().view(
        np.uint32)


def same_bytes(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether two tensors hold the same bytes (compared as int32 bits on
    `want`'s device, so NaNs and signed zeros compare by their bits)."""
    a = got.detach().reshape(-1)
    b = want.detach().reshape(-1)
    if a.numel() * a.element_size() != b.numel() * b.element_size():
        return False
    a = a.view(torch.int32)
    b = b.view(torch.int32)
    if a.device != b.device:
        a = a.to(b.device)
    return bool(torch.equal(a, b))


def gathered(chunks: list, device) -> torch.Tensor:
    """What every peer holds after gathering `chunks`: them stacked in
    peer order along the first axis, on `device`."""
    return torch.cat([c.to(device) for c in chunks])


def lossy_echo(lanes: torch.Tensor) -> torch.Tensor:
    """An echo of uint32 lanes through float32: lanes above 2^24 lose
    their low bits."""
    wide = lanes.view(torch.int32).to(torch.int64) & MASK
    back = wide.to(torch.float32).to(torch.float64).clamp(0, MASK)
    narrow = back.to(torch.int64)
    return (narrow - ((narrow >> 31) << 32)).to(torch.int32).view(
        torch.uint32)


def lossy_sum(lanes: torch.Tensor) -> int:
    """The lanes' sum accumulated in float32, wrapped to 32 bits."""
    wide = lanes.view(torch.int32).to(torch.int64) & MASK
    return int(wide.to(torch.float32).sum().item()) & MASK


def lossy_gathered(chunks: list, device) -> torch.Tensor:
    """The gather with every chunk passed through bfloat16."""
    return torch.cat([c.to(torch.bfloat16).to(c.dtype).to(device)
                      for c in chunks])
