"""Ring all-gather: one chunk per peer into every peer's output.  Port of
brpc_tpu/ops/ring_kernel.py.

`ring_all_gather(chunks, streams)` gathers one chunk per peer into every
peer's own output with kernel K2 (csrc/ring_kernel.cu, replacing the
reference's Pallas `_ring_kernel`).  Peers may share a card or lie on
cards of one host: K2 makes one launch per device that holds sources, on
the stream of that device's first peer, covering that device's sources and
writing all n outputs (one launch on one card).  It computes the gather
directly (each source byte read once, each output byte written once)
instead of the reference's ring of hops; `plan_launches` (one
`plan_gather` per source device, pure Python) chooses each launch's path,
width, tile and grid.  CUDA chunks always go to the kernel, or raise; CPU
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
_RAGGED_TILE = 16 * 1024  # bytes per unit of the vector (ragged) path
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
        if (c.shape, c.dtype, c.device.type) != (first.shape, first.dtype,
                                                 first.device.type):
            raise ValueError("every peer's chunk must have one shape, dtype "
                             "and device type")
    if first.dim() == 0:
        raise ValueError("chunks must have a leading row dim")


def _out_shape(chunks: list) -> tuple:
    return (len(chunks) * chunks[0].shape[0], *chunks[0].shape[1:])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def ring_all_gather(chunks: list, streams=None) -> list:
    """chunks: one (rows, ...) tensor per peer, in ring order, each on its
    peer's device.  Returns each peer's gathered (n*rows, ...) tensor, its
    own allocation on that peer's device.  `streams` (CUDA only): the
    stream of each peer, on which its chunk was made and its output will
    be read; by default each chunk's device's current stream."""
    _check(chunks)
    kind = chunks[0].device.type
    if kind == "cpu":
        return ring_all_gather_plain(chunks)
    if kind != "cuda":
        raise RuntimeError(
            f"ring_all_gather runs on cuda or cpu tensors, not {kind}")
    if streams is None:
        streams = [torch.cuda.current_stream(c.device) for c in chunks]
    if len(streams) != len(chunks):
        raise ValueError(f"{len(streams)} streams for {len(chunks)} chunks")
    return _launch(chunks, list(streams))


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
    dev = chunks[0].device  # the hops run here; outputs go to each peer
    size = _bytes(chunks[0]).numel()
    outs = [torch.empty(_out_shape(chunks), dtype=c.dtype, device=dev)
            for c in chunks]
    out = [_bytes(o).view(n, size) for o in outs]
    comm = torch.empty((n, 2, size), dtype=torch.uint8, device=dev)
    for r, c in enumerate(chunks):
        out[r][r] = _bytes(c.contiguous()).to(dev)
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
    return [o.to(c.device) for o, c in zip(outs, chunks)]


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """One launch of K2.  Path "bulk" (width 16): bulk copies through
    shared memory, stored to every output, on this card or (over NVLink)
    another; "ragged" (width 8, 4, 2 or 1): threads copy `width` bytes at
    a time.  Each chunk is cut into tiles of `tile_bytes`; a unit is one
    (source, tile) pair, and `grid` CTAs walk the `units` with a grid
    stride.  `device` is the launch's device index and `sources` the
    chunks it reads."""

    width: int
    tile_bytes: int
    units: int
    grid: int
    path: str = "bulk"
    device: int = 0
    sources: tuple = ()


def plan_gather(chunk_bytes: int, n: int, addrs, sms: int, *,
                sources=None, device: int = 0) -> GatherPlan:
    """The launch for `sources` (default: all n chunks) of `chunk_bytes`
    each, given the addresses of those chunks and of every output, and the
    SM count of the launch's device.  The width is the widest of 16, 8, 4,
    2, 1 that divides the chunk size and every address.  Raises
    RuntimeError for fewer than 2 or more than 64 peers."""
    if not 2 <= n <= _MAX_PEERS:
        raise RuntimeError(f"the ring kernel takes 2 to {_MAX_PEERS} peers, "
                           f"got {n}")
    sources = tuple(range(n)) if sources is None else tuple(sources)
    width = _BULK_WIDTH
    while width > 1 and (chunk_bytes % width
                         or any(a % width for a in addrs)):
        width //= 2
    path = "bulk" if width == _BULK_WIDTH else "ragged"
    if path == "bulk":
        tile, per_sm = min(_BULK_TILE, chunk_bytes), 1
    else:
        tile, per_sm = min(_RAGGED_TILE, chunk_bytes), _RAGGED_CTAS_PER_SM
    units = len(sources) * -(-chunk_bytes // tile) if chunk_bytes else 0
    return GatherPlan(width, tile, units, min(units, per_sm * sms), path,
                      device, sources)


def plan_launches(chunk_bytes: int, devices, src_addrs, out_addrs,
                  sms) -> list:
    """K2's launches for n peers whose chunk j and output j lie on device
    index `devices[j]`: one `plan_gather` per device that holds sources,
    in the order of its first peer, covering that device's chunks and
    writing all n outputs.  `sms(device)` gives a device's SM count."""
    n = len(devices)
    plans = []
    for dev in dict.fromkeys(devices):
        sources = [j for j in range(n) if devices[j] == dev]
        plans.append(plan_gather(
            chunk_bytes, n, [src_addrs[j] for j in sources] + list(out_addrs),
            sms(dev), sources=sources, device=dev))
    return plans


@functools.cache
def _lib():
    lib = _kernels.load(KERNEL)
    lib.brpc_ring_all_gather.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
        ctypes.c_void_p]
    lib.brpc_ring_all_gather.restype = ctypes.c_int
    lib.brpc_ring_enable_peers.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.brpc_ring_enable_peers.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def enable_peers(devices: tuple) -> None:
    """Enables peer access between every pair of the CUDA device indices
    `devices` (already enabled is fine).  Raises RuntimeError naming the
    first pair that cannot reach the other: there is no fallback through
    host copies."""
    bad = (ctypes.c_int * 2)()
    rc = _lib().brpc_ring_enable_peers(
        (ctypes.c_int * len(devices))(*devices), len(devices), bad)
    if rc == -1:
        raise RuntimeError(f"cuda:{bad[0]} cannot access cuda:{bad[1]} as a "
                           "peer (cudaDeviceCanAccessPeer is 0); the ring "
                           "kernel needs peer access between every pair")
    if rc != 0:
        raise RuntimeError(f"enabling peer access among {devices} failed: "
                           f"cudaError {rc}")


def _launch(chunks: list, streams: list) -> list:
    """One launch per source device, each on the stream of that device's
    first peer, behind an event on every other peer's stream (its chunk
    made, its output's memory free); every peer's stream then waits for
    every launch.  Allocates only the outputs (and a contiguous copy of a chunk
    that is not contiguous), each on its peer's stream, and never waits
    for the card."""
    n = len(chunks)
    devs = [c.device.index for c in chunks]
    shape = _out_shape(chunks)
    current = {d: torch.cuda.current_stream(d) for d in set(devs)}
    outs, srcs = [], []
    for c, stream in zip(chunks, streams):
        if stream == current[c.device.index]:
            outs.append(torch.empty(shape, dtype=c.dtype, device=c.device))
            srcs.append(c.contiguous())
            continue
        with torch.cuda.stream(stream):  # also makes its device current
            outs.append(torch.empty(shape, dtype=c.dtype, device=c.device))
            srcs.append(c.contiguous())
    distinct = list(dict.fromkeys(streams))
    # Events only where peers' streams differ: one stream orders itself.
    ready = ({s: s.record_event() for s in distinct} if len(distinct) > 1
             else {})
    chunk_bytes = srcs[0].numel() * srcs[0].element_size()
    plans = plan_launches(chunk_bytes, devs,
                          [t.data_ptr() for t in srcs],
                          [t.data_ptr() for t in outs], _sms)
    if plans[0].units == 0:  # empty chunks: nothing to copy
        return outs
    if len(plans) > 1:
        enable_peers(tuple(sorted(set(devs))))
    out_ptrs = _ptrs(outs)
    done = []
    for plan in plans:
        stream = streams[plan.sources[0]]
        for other, ev in ready.items():
            if other != stream:
                stream.wait_event(ev)
        with torch.cuda.device(plan.device):
            rc = _lib().brpc_ring_all_gather(
                _ptrs([srcs[j] for j in plan.sources]),
                (ctypes.c_int * len(plan.sources))(*plan.sources),
                len(plan.sources), out_ptrs, n, chunk_bytes, plan.width,
                plan.tile_bytes, plan.grid, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ring kernel launch failed: cudaError {rc} "
                               f"({plan})")
        _kernels.count_launch(WRAPPER)
        if ready:
            done.append((stream, stream.record_event()))
    for stream in distinct:
        for launched_on, ev in done:
            if launched_on != stream:
                stream.wait_event(ev)
    return outs


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_uint64 * len(tensors))(*(t.data_ptr() for t in tensors))
