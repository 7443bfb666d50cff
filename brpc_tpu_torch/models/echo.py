"""Benchmark workloads — port of brpc_tpu/models/echo.py.

- ``single_chip_echo_step`` → example/echo_c++ (single sync echo, one chip),
  as in the reference.
- ``rpc_echo_step`` → the device → RPC stack → device leg of bench.py's
  rpc child (bench.py:207-357) as one call: the echo data plane end to end.
- ``make_nton_exchange`` → example/rdma_performance N-to-N 64MB exchange,
  over the logical peers of a Fabric.
- ``make_ring_exchange`` → the explicit ring variant of that exchange.
- ``make_full_dataplane_step`` → the combined fan-out + partition + ring
  step `dryrun_multichip` runs over a multi-device mesh.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.ops.checksum import sum32
from brpc_tpu_torch.ops.echo_kernel import echo_fused
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P
from brpc_tpu_torch.rpc import zerocopy
from brpc_tpu_torch.transport.ici import IciTransport, _ring_perm


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


def make_nton_exchange(fabric: Fabric, axis: str = "link"):
    """Every peer sends a distinct row block to every other peer and
    checksums what it received — one all-to-all over the mesh.

    Input layout per shard: (n, chunk) uint32, row j destined for peer j.
    Returns (received, checksum_per_peer)."""
    t = IciTransport(fabric, axis)

    def spmd(local):
        recv = t.all_to_all(local)
        return recv, sum32(recv)[None]

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=(P(axis), P(axis)))


def make_ring_exchange(fabric: Fabric, axis: str = "link"):
    """Explicit ring N-to-N (the schedule variant): N-1 hops, each hop's
    arrival checksummed into the carry."""
    t = IciTransport(fabric, axis)

    def spmd(local):
        buf, carry, _ = t.ring_exchange(local)
        return buf, carry[None]

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=(P(axis), P(axis)))


def make_full_dataplane_step(fabric: Fabric, fan_axis: str = "dp",
                             part_axis: str = "link"):
    """The composite step exercising every channel kind at once:

    - the request tensor is partitioned over `part_axis` (PartitionChannel),
    - replicated over `fan_axis` where each replica applies its own handler
      transform (ParallelChannel fan-out),
    - replicas' responses merge with psum over `fan_axis` (ResponseMerger),
    - partitions then run one ring hop over `part_axis` to their neighbour
      and back (streaming echo), and
    - a final sum over the partitions verifies the whole exchange.

    Returns fn: (payload[(rows, cols) f32]) -> (response, checksum)."""
    n_part = fabric.axis_size(part_axis)
    perm = _ring_perm(n_part, 1)
    perm_back = _ring_perm(n_part, -1)

    def spmd(payload):
        rep = coll.axis_index(fan_axis).to(payload.dtype)
        handled = payload * (rep + 1.0)  # per-replica handler
        merged = coll.psum(handled, fan_axis)  # ResponseMerger: sum
        sent = coll.ppermute(merged, part_axis, perm)  # stream out
        back = coll.ppermute(sent, part_axis, perm_back)  # echo back
        csum = coll.psum(torch.sum(back), part_axis)
        return back, csum[None]

    return fabric.spmd(spmd, in_specs=P(part_axis, None),
                       out_specs=(P(part_axis, None), P()))
