"""IciTransport — movement between the peers of a fabric.  Port of
brpc_tpu/transport/ici.py.

The reference compiles each transfer into the XLA program (`lax.ppermute`,
`lax.all_to_all`, ...).  The port's peers are threads of one process, each
on its own device and stream, so a transfer is a collective of
`brpc_tpu_torch.parallel.collectives`: the bytes move as device copies,
within a card or between cards (over NVLink where the cards are peers),
behind the sender's event on the receiver's stream.  Every method runs
inside a `Fabric.spmd` body; the `jit_*` methods return the spmd callables
for host callers.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.ops.checksum import sum32
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P, bits

__all__ = ["IciTransport"]

_SIGNED_SUM = {torch.int8, torch.int16, torch.int32, torch.bool}


def _ring_perm(n: int, shift: int):
    """Source→dest pairs for a cyclic shift along an axis of size n."""
    return [(i, (i + shift) % n) for i in range(n)]


def wrapping_sum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.sum(x)` with jax's result types (32-bit mode): small unsigned
    integers sum to a wrapping uint32, small signed ones to a wrapping
    int32, floats to their own type."""
    if x.dtype in (torch.uint8, torch.uint16, torch.uint32):
        return sum32(x)
    if x.dtype in _SIGNED_SUM:
        total = x.reshape(-1).to(torch.int64).sum() & 0xFFFFFFFF
        return (total - ((total >> 31) << 32)).to(torch.int32)
    return x.sum()


def wrapping_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b for two tensors of one type; uint32 adds through its int32
    bits (the same sum mod 2^32)."""
    return (bits(a) + bits(b)).view(a.dtype)


class IciTransport:
    """Point-to-point and collective movement along one mesh axis."""

    def __init__(self, fabric: Fabric, axis: str = "link"):
        self.fabric = fabric
        self.axis = axis
        self.n = fabric.axis_size(axis)

    # -- inside-spmd primitives -------------------------------------------
    def put(self, x, shift: int = 1):
        """One-sided put to the neighbour `shift` hops down the ring."""
        return coll.ppermute(x, self.axis, _ring_perm(self.n, shift))

    def echo(self, x):
        """Round trip: put to the right neighbour, which returns it."""
        return self.put(self.put(x, 1), -1)

    def all_gather(self, x, tiled: bool = False):
        return coll.all_gather(x, self.axis, tiled=tiled)

    def reduce_scatter(self, x, op: str = "sum"):
        if op != "sum":
            raise ValueError(f"reduce_scatter supports op='sum', not {op!r}")
        return coll.psum_scatter(x, self.axis, tiled=True)

    def all_to_all(self, x):
        """N-to-N exchange: row block i of x goes to peer i."""
        return coll.all_to_all(x, self.axis, split_axis=0, concat_axis=0,
                               tiled=True)

    def ring_exchange(self, x, on_hop=None):
        """Explicit N-1 hop ring: hop 0 consumes the local chunk in place,
        then each of the N-1 steps moves the buffer one hop right and feeds
        the arrival to `on_hop(carry, chunk, hop)`, which returns (carry,
        out).  Returns (buffer, carry, stacked outs or None)."""
        if on_hop is None:
            def on_hop(c, chunk, hop):
                s = wrapping_sum(chunk)
                # The zero carry of x's type meets a sum of a wider type
                # only at hop 0 (jax promotes; 0 + s is s).
                return (wrapping_add(c, s) if c.dtype == s.dtype else s), None

        zero = torch.zeros((), dtype=bits(x).dtype, device=x.device)
        carry, out0 = on_hop(zero.view(x.dtype), x, 0)
        outs = [] if out0 is None else [out0]
        buf = x
        for hop in range(1, self.n):
            buf = self.put(buf, 1)
            carry, out = on_hop(carry, buf, hop)
            if out is not None:
                outs.append(out)
        if not outs:
            return buf, carry, None
        return buf, carry, torch.stack([bits(o) for o in outs]).view(
            outs[0].dtype)

    # -- host-callable wrappers -------------------------------------------
    def jit_echo(self):
        """Echo over a payload sharded along the transport axis."""
        spec = P(self.axis)
        return self.fabric.spmd(self.echo, in_specs=spec, out_specs=spec)

    def jit_all_to_all(self):
        spec = P(self.axis)
        return self.fabric.spmd(self.all_to_all, in_specs=spec,
                                out_specs=spec)
