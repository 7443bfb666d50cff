"""Ring all-gather: one chunk per peer into every peer's output.  Port of
brpc_tpu/ops/ring_kernel.py.

`ring_all_gather(chunks)` gathers one chunk per logical peer into every
peer's own output with kernel K2 (csrc/ring_kernel.cu, replacing the
reference's Pallas `_ring_kernel`): one launch serves all peers, which on
one card are the fabric's threads.  On one card the kernel computes the
gather directly (each source byte read once, each output byte written
once) instead of the reference's ring of hops; `plan_gather` chooses its
path, tile and grid.  CUDA chunks always go to the kernel, or raise; CPU
chunks take `ring_all_gather_plain`, the reference kernel's hop schedule in
plain torch (as the JAX tests run the Pallas interpreter).

`ring_all_gather_kernel(fabric, axis)` puts it behind `Fabric.spmd` like the
reference's `ring_all_gather_pallas`; `ring_all_gather_reference` is the
collective it is checked against.  The kernel copies bytes, so it is
bit-exact for every dtype and every chunk size.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P

KERNEL = "ring_kernel"      # csrc/<KERNEL>.cu
WRAPPER = "ring_all_gather"  # its name in _kernels.launches

# Mirrors of csrc/ring_kernel.cu's limits.
_MAX_PEERS = 64           # kMaxPeers
_BULK_WIDTH = 16          # bulk copies need 16-byte addresses and sizes
_BULK_TILE = 32 * 1024    # kMaxTile: bytes per shared-memory stage
_RAGGED_TILE = 16 * 1024  # bytes per unit of the ragged path
_RAGGED_CTAS_PER_SM = 8   # 256-thread CTAs: 2048 threads per SM


def ring_all_gather_reference(fabric: Fabric, axis: str = "link"):
    """Collective-based reference: out[j] = shard j's rows, on every peer."""

    def spmd(x):
        return coll.all_gather(x, axis, tiled=True)

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=P())


def ring_all_gather_kernel(fabric: Fabric, axis: str = "link"):
    """The kernel-backed all-gather over `fabric`, the port of
    `ring_all_gather_pallas`: fn(global (n*rows, cols)) -> peer 0's gathered
    (n*rows, cols) (every peer holds its own copy).  Raises RuntimeError for
    fewer than 2 peers or a mesh that is not 1-D, as the reference does."""
    n = fabric.axis_size(axis)
    if n < 2:
        raise RuntimeError("the ring kernel needs at least 2 peers; use "
                           "ring_all_gather_reference for one")
    if len(fabric.shape) != 1:
        raise RuntimeError("the ring kernel needs a 1-D mesh over the "
                           "gathered axis; build a dedicated Fabric for it")

    def spmd(x):
        return coll.group_call(x, axis, ring_all_gather)

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=P())


def _check(chunks: list) -> None:
    if len(chunks) < 2:
        raise RuntimeError(f"ring all-gather needs at least 2 peers, got "
                           f"{len(chunks)}")
    first = chunks[0]
    for c in chunks[1:]:
        if (c.shape, c.dtype, c.device) != (first.shape, first.dtype,
                                            first.device):
            raise ValueError("every peer's chunk must have one shape, dtype "
                             "and device")
    if first.dim() == 0:
        raise ValueError("chunks must have a leading row dim")


def _outputs(chunks: list) -> list:
    n = len(chunks)
    shape = (n * chunks[0].shape[0], *chunks[0].shape[1:])
    return [torch.empty(shape, dtype=c.dtype, device=c.device)
            for c in chunks]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def ring_all_gather(chunks: list) -> list:
    """chunks: one (rows, ...) tensor per peer, in ring order.  Returns
    each peer's gathered (n*rows, ...) tensor, its own allocation."""
    _check(chunks)
    dev = chunks[0].device
    if dev.type == "cpu":
        return ring_all_gather_plain(chunks)
    if dev.type != "cuda":
        raise RuntimeError(
            f"ring_all_gather runs on cuda or cpu tensors, not {dev}")
    with torch.cuda.device(dev):
        return _launch(chunks)


def ring_all_gather_plain(chunks: list) -> list:
    """The reference kernel's hop schedule (`_ring_kernel`) in plain torch,
    on per-peer comm buffers: own chunk to its output slot and comm[0];
    hop 0 puts comm[0] into the right neighbour's comm[1]; hop `step`
    forwards comm[(step+1)%2] into the right neighbour's comm[step%2] (hop
    step+1) and then copies it to out[(r - step - 1) mod n].  Within a hop
    every write goes to a slot no read of that hop touches, so running the
    peers one after another is the parallel schedule.  It computes K2's
    function by another route, so it checks the kernel on the card."""
    _check(chunks)
    n = len(chunks)
    size = _bytes(chunks[0]).numel()
    outs = _outputs(chunks)
    out = [_bytes(o).view(n, size) for o in outs]
    comm = torch.empty((n, 2, size), dtype=torch.uint8,
                       device=chunks[0].device)
    for r, c in enumerate(chunks):
        out[r][r] = _bytes(c.contiguous())
        comm[r, 0] = out[r][r]
    for r in range(n):
        comm[(r + 1) % n, 1] = comm[r, 0]
    for step in range(n - 1):
        recv_slot, parity = (step + 1) % 2, step % 2
        if step + 1 < n - 1:
            for r in range(n):
                comm[(r + 1) % n, parity] = comm[r, recv_slot]
        for r in range(n):
            out[r][(r - step - 1) % n] = comm[r, recv_slot]
    return outs


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """One launch of K2: `width` 16 takes the bulk path (bulk copies
    through shared memory), 8, 4, 2 or 1 the ragged path (threads copy
    `width` bytes at a time).  Each chunk is cut into tiles of
    `tile_bytes`; a unit is one (source, tile) pair, and `grid` CTAs walk
    the `units` with a grid stride."""

    width: int
    tile_bytes: int
    units: int
    grid: int


def plan_gather(chunk_bytes: int, n: int, addrs, sms: int) -> GatherPlan:
    """The launch for n chunks of `chunk_bytes` each, given every chunk's
    and every output's address and the card's SM count.  The width is the
    widest of 16, 8, 4, 2, 1 that divides the chunk size and every
    address.  Raises RuntimeError for fewer than 2 or more than 64 peers."""
    if not 2 <= n <= _MAX_PEERS:
        raise RuntimeError(f"the ring kernel takes 2 to {_MAX_PEERS} peers, "
                           f"got {n}")
    width = _BULK_WIDTH
    while width > 1 and (chunk_bytes % width
                         or any(a % width for a in addrs)):
        width //= 2
    if width == _BULK_WIDTH:
        tile, per_sm = min(_BULK_TILE, chunk_bytes), 1
    else:
        tile, per_sm = min(_RAGGED_TILE, chunk_bytes), _RAGGED_CTAS_PER_SM
    units = n * -(-chunk_bytes // tile) if chunk_bytes else 0
    return GatherPlan(width, tile, units, min(units, per_sm * sms))


@functools.cache
def _lib():
    lib = _kernels.load(KERNEL)
    lib.brpc_ring_all_gather.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_void_p]
    lib.brpc_ring_all_gather.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_uint64 * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch(chunks: list) -> list:
    """One launch on the current stream; allocates only the outputs (and a
    contiguous copy of a chunk that is not contiguous) and never waits for
    the card."""
    n = len(chunks)
    chunks = [c.contiguous() for c in chunks]
    chunk_bytes = chunks[0].numel() * chunks[0].element_size()
    dev = chunks[0].device
    outs = _outputs(chunks)
    plan = plan_gather(chunk_bytes, n,
                       [t.data_ptr() for t in (*chunks, *outs)],
                       _sms(dev.index or 0))
    if plan.units == 0:  # empty chunks: nothing to copy
        return outs
    rc = _lib().brpc_ring_all_gather(
        _ptrs(chunks), _ptrs(outs), n, chunk_bytes, plan.width,
        plan.tile_bytes, plan.grid, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring kernel launch failed: cudaError {rc} "
                           f"({plan})")
    _kernels.count_launch(WRAPPER)
    return outs
