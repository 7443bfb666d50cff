"""Streaming — ordered chunk pipelines between fabric peers.  Port of
brpc_tpu/streaming/stream.py.

brpc's streaming RPC (stream.cpp) delivers ordered byte chunks with a
credit window.  In the reference a stream between mesh peers is a
`lax.scan` whose body moves one chunk per step with `ppermute`; here the
scan is a loop inside the spmd body, one ring put per chunk, in order, and
the carry and stacked outputs keep the reference's layouts.
"""

from __future__ import annotations

from typing import Callable

import torch

from brpc_tpu_torch.ops.checksum import sum32
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P, bits, tree_map
from brpc_tpu_torch.transport.ici import _ring_perm, wrapping_add

__all__ = ["ring_stream", "stream_echo"]


def _stack(outs: list):
    return tree_map(lambda *leaves: torch.stack(
        [bits(t) for t in leaves]).view(leaves[0].dtype), *outs)


def ring_stream(fabric: Fabric, axis: str, on_chunk: Callable, *,
                in_spec=None, carry_spec=P(), out_spec=None,
                shift: int = 1):
    """Build a stream over `axis`: each step puts one chunk one hop and
    hands the arrival to ``on_chunk(carry, chunk) -> (carry, out)`` on the
    receiving peer.

    `chunks` has leading dim = num_chunks; the default specs shard the
    second dim over `axis` (N concurrent streams riding N links).
    `carry_spec`/`out_spec` describe the *global* layout of the carry and
    of the outputs stacked along a new leading dim."""
    n = fabric.axis_size(axis)
    perm = _ring_perm(n, shift)
    in_spec = P(None, axis) if in_spec is None else in_spec
    out_spec = P(None, axis) if out_spec is None else out_spec

    def spmd(chunks, carry):
        outs = []
        for chunk in chunks.unbind(0):
            arrived = coll.ppermute(chunk, axis, perm)
            carry, out = on_chunk(carry, arrived)
            outs.append(out)
        return carry, _stack(outs)

    return fabric.spmd(spmd, in_specs=(in_spec, carry_spec),
                       out_specs=(carry_spec, out_spec))


def stream_echo(fabric: Fabric, axis: str, num_chunks: int):
    """Bidi stream echo (example/streaming_echo_c++ analogue): every chunk
    is streamed to the right neighbour, checksummed there, and per-chunk
    sums stacked; the carry keeps each receiver's running total.  Returns
    fn(chunks, totals0) -> (totals (n,), per_chunk (num_chunks, n)), both
    uint32."""

    def on_chunk(carry, chunk):
        s = sum32(chunk)
        # carry/out are (1,)-shaped per peer so the global view stacks
        # along the stream axis: carry -> (n,), outs -> (num_chunks, n).
        return wrapping_add(carry, s[None]), s[None]

    return ring_stream(fabric, axis, on_chunk, carry_spec=P(axis),
                       out_spec=P(None, axis))
