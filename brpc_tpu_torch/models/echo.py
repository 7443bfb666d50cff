"""Benchmark workloads — port of brpc_tpu/models/echo.py (single chip).

- ``single_chip_echo_step`` → example/echo_c++ (single sync echo, one chip),
  as in the reference.
- ``rpc_echo_step`` → the device → RPC stack → device leg of bench.py's
  rpc child (bench.py:207-357) as one call: the echo data plane end to end.

The multi-device steps (make_nton_exchange, make_ring_exchange,
make_full_dataplane_step) belong to the multi-device slice of the port.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.ops.checksum import sum32
from brpc_tpu_torch.ops.echo_kernel import echo_fused
from brpc_tpu_torch.rpc import zerocopy


def single_chip_echo_step(payload: torch.Tensor):
    """One echo round trip on one chip: the server 'receives' the request
    buffer, verifies it, and materializes the response copy in device
    memory.  Returns (response, checksum).  The copy rolls by one lane like
    the reference's (jnp.roll direction)."""
    if payload.dtype == torch.uint32:  # rolled as int32 bits
        resp = torch.roll(payload.view(torch.int32), 1).view(torch.uint32)
    else:
        resp = torch.roll(payload, 1)
    return resp, sum32(resp)


def rpc_echo_step(channel, payload: torch.Tensor, method: str = "Echo.Echo",
                  timeout_ms: int = 0):
    """The echo data plane end to end for a uint32 payload that meets
    echo_fused's block contract.

    On the payload's device, one fused pass materializes the response copy
    and its checksum (echo_fused).  The copy enters the RPC stack by
    reference — zero host copies for a CPU tensor, exactly one D2H copy
    into pinned memory for a GPU tensor — and is echoed by the server at
    `method`.  The echoed bytes land in (pinned) host memory, return to the
    device, and the fused pass checksums them there.

    Returns (echoed tensor on the payload's device, sent checksum, echoed
    checksum); the checksums are 0-dim uint32 tensors on that device."""
    resp, sent = echo_fused(payload)
    landed = zerocopy.call_zero_copy_into(channel, method, resp,
                                          timeout_ms=timeout_ms)
    if landed.numel() != resp.numel() * 4:
        raise RuntimeError(
            f"echo returned {landed.numel()} bytes for {resp.numel() * 4}")
    back = landed.view(torch.int32).to(payload.device, non_blocking=True)
    back = back.view(torch.uint32)
    _, got = echo_fused(back)
    return back, sent, got
