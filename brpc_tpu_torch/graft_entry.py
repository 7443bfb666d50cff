"""Driver entry point of the port — mirrors __graft_entry__.entry().

`entry(device=None)` returns the single-chip echo step and its payload, a
2^16-lane uint32 arange on the device (the GPU unless device="cpu").
"""

from __future__ import annotations

import torch

from brpc_tpu_torch import resolve_device
from brpc_tpu_torch.models.echo import single_chip_echo_step


def entry(device=None):
    dev = resolve_device(device)
    payload = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    return single_chip_echo_step, (payload.view(torch.uint32),)
