"""Ring all-gather — the explicit ring schedule as a kernel.  Port of
brpc_tpu/ops/ring_kernel.py.

`ring_all_gather(chunks)` gathers one chunk per logical peer into every
peer's own output with kernel K2 (csrc/ring_kernel.cu, replacing the
reference's Pallas `_ring_kernel`): one launch serves all peers, which on
one card are the fabric's threads.  CUDA chunks always go to the kernel, or
raise; CPU chunks take `ring_all_gather_plain`, the same hop, slot and
source-index schedule in plain torch on the same per-peer comm buffers (as
the JAX tests run the Pallas interpreter).

`ring_all_gather_kernel(fabric, axis)` puts it behind `Fabric.spmd` like the
reference's `ring_all_gather_pallas`; `ring_all_gather_reference` is the
collective it is checked against.  The kernel copies bytes, so it is
bit-exact for every dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P

KERNEL = "ring_kernel"      # csrc/<KERNEL>.cu
WRAPPER = "ring_all_gather"  # its name in _kernels.launches

_VEC = 16          # bytes per vector load/store of the kernel
_MAX_STRIPES = 64  # stripes per chunk (CTAs per peer)
_FLAG_WORDS = 8    # flag words per (peer, stripe)
_WAITS = {1: "entry barrier", 2: "arrival", 3: "capacity grant",
          4: "exit barrier"}


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
    """K2's schedule in plain torch, on per-peer comm buffers: own chunk to
    its output slot and comm[0]; hop 0 puts comm[0] into the right
    neighbour's comm[1]; hop `step` forwards comm[(step+1)%2] into the
    right neighbour's comm[step%2] (hop step+1) and then copies it to
    out[(r - step - 1) mod n].  Within a hop every write goes to a slot no
    read of that hop touches, so running the peers one after another is the
    parallel schedule."""
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


@functools.cache
def _lib():
    lib = _kernels.load(KERNEL)
    lib.brpc_ring_all_gather.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.brpc_ring_all_gather.restype = ctypes.c_int
    lib.brpc_ring_capacity.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.brpc_ring_capacity.restype = ctypes.c_int
    lib.brpc_ring_max_peers.argtypes = []
    lib.brpc_ring_max_peers.restype = ctypes.c_int
    return lib


@functools.cache
def capacity(device_index: int) -> int:
    """CTAs of K2 that can be resident at once on the device (0 without
    cooperative launch)."""
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _lib().brpc_ring_capacity(ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"ring kernel occupancy query failed: "
                           f"cudaError {rc}")
    return ctas.value


def stripes_for(chunk_bytes: int, n: int, ctas: int) -> int:
    """Stripes per chunk: the most (up to _MAX_STRIPES) whose n * stripes
    CTAs fit in `ctas` and whose bytes split into whole 16-byte vectors.
    Raises ValueError when a chunk is no whole number of vectors, and
    RuntimeError when even one CTA per peer cannot be resident."""
    if chunk_bytes % _VEC:
        raise ValueError(
            f"a chunk of {chunk_bytes} bytes does not split into "
            f"{_VEC}-byte vectors")
    if ctas < n:
        raise RuntimeError(
            f"ring kernel grid cannot be co-resident: {n} peers need "
            f"{n} CTAs, the device holds {ctas} at once")
    for s in range(min(_MAX_STRIPES, ctas // n), 0, -1):
        if chunk_bytes % (_VEC * s) == 0:
            return s
    raise AssertionError("unreachable: one stripe always fits")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_uint64 * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch(chunks: list) -> list:
    n = len(chunks)
    chunks = [c.contiguous() for c in chunks]
    chunk_bytes = _bytes(chunks[0]).numel()
    lib = _lib()
    if n > lib.brpc_ring_max_peers():
        raise RuntimeError(f"ring kernel takes at most "
                           f"{lib.brpc_ring_max_peers()} peers, got {n}")
    dev = chunks[0].device
    stripes = stripes_for(chunk_bytes, n, capacity(dev.index or 0))
    outs = _outputs(chunks)
    comm = torch.empty((n, 2 * chunk_bytes), dtype=torch.uint8, device=dev)
    flags = torch.empty(n * stripes * _FLAG_WORDS, dtype=torch.int32,
                        device=dev)
    err = torch.empty(4, dtype=torch.int32, device=dev)
    for t in (*chunks, *outs, comm):
        if t.data_ptr() % _VEC:
            raise ValueError("ring kernel buffers must be 16-byte aligned")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.brpc_ring_all_gather(
        _ptrs(chunks), _ptrs(outs), _ptrs(list(comm.unbind(0))), n, stripes,
        chunk_bytes, flags.data_ptr(), err.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ring kernel launch failed: cudaError {rc}")
    _kernels.count_launch(WRAPPER)
    kind, peer, hop, stripe = err.tolist()  # waits for the kernel
    if kind:
        raise RuntimeError(
            f"ring kernel stalled: peer {peer} waited past its bound for "
            f"the {_WAITS.get(kind, kind)} of hop {hop} (stripe {stripe})")
    return outs
