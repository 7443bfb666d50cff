"""Device staging arena — port of brpc_tpu/rpc/arena.py.

The C++ DeviceArena (cpp/base/device_arena.h) owns registered staging slabs;
Python wraps a block as a writable uint8 CPU tensor, a tensor's bytes land in
it (`ArenaBlock.put`: one D2H copy straight into the block for a CUDA
tensor, one memcpy for a CPU tensor), and the block then rides the RPC data
path with zero further host copies (`trpc_iobuf_append_block` hands the
block to the IOBuf by reference; writev sends straight from it).
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.rpc import zerocopy
from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.client import RpcError


class DeviceArena:
    """Registered staging-slab allocator (C++ DeviceArena)."""

    def __init__(self, block_size: int = 256 * 1024,
                 blocks_per_slab: int = 32, shm_backed: bool = False):
        self._lib = load_library()
        self._ptr = self._lib.trpc_arena_create(
            block_size, blocks_per_slab, 1 if shm_backed else 0)
        self.block_size = int(self._lib.trpc_arena_block_size(self._ptr))

    def alloc(self) -> "ArenaBlock":
        data = ctypes.c_void_p()
        meta = ctypes.c_uint64()
        block = self._lib.trpc_arena_alloc(
            self._ptr, ctypes.byref(data), ctypes.byref(meta))
        if not block:
            raise MemoryError("device arena exhausted")
        return ArenaBlock(self, block, data.value, meta.value)

    @property
    def blocks_in_use(self) -> int:
        return int(self._lib.trpc_arena_blocks_in_use(self._ptr))

    def close(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_arena_destroy(ptr)


class ArenaBlock:
    """One staging block; fill it with put() then send (send consumes it)."""

    def __init__(self, arena: DeviceArena, handle, data_ptr: int,
                 meta: int):
        self.arena = arena
        self.handle = handle
        self.meta = meta  # (slab_id << 32 | offset) — the lkey analogue
        buf = (ctypes.c_char * arena.block_size).from_address(data_ptr)
        self.view = torch.frombuffer(buf, dtype=torch.uint8)  # no copy

    def put(self, tensor: torch.Tensor) -> int:
        """Lands a (CPU or CUDA) tensor's bytes in the staging block: one
        D2H copy straight into the block for a CUDA tensor, one memcpy for
        a CPU tensor.  Returns the byte length.  For the fully copy-free
        path, see zerocopy.append_torch — a block only pays off when the
        bytes must live in registered/shm-backed memory."""
        return zerocopy.land(self.view, tensor)

    def release(self) -> None:
        if self.handle:
            self.arena._lib.trpc_arena_release(self.arena._ptr, self.handle)
            self.handle = None


def call_with_block(channel, method: str, block: ArenaBlock,
                    length: int, timeout_ms: int = 0) -> bytes:
    """Sync RPC whose request payload is the arena block's [0, length)
    bytes, entering the IOBuf WITHOUT copying (block reference handoff).
    The block is consumed; returns the response bytes."""
    lib = block.arena._lib
    req = lib.trpc_iobuf_create()
    resp = lib.trpc_iobuf_create()
    try:
        rc = lib.trpc_iobuf_append_block(req, block.handle, length)
        block.handle = None  # consumed either way
        if rc != 0:
            raise ValueError(f"length {length} exceeds block capacity")
        err = ctypes.create_string_buffer(256)
        rc = lib.trpc_channel_call_buf(channel._ptr, method.encode(), req,
                                       resp, timeout_ms, err, len(err))
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        n = lib.trpc_iobuf_size(resp)
        out = ctypes.create_string_buffer(n)
        lib.trpc_iobuf_copy_to(resp, out, n, 0)
        return out.raw
    finally:
        lib.trpc_iobuf_destroy(req)
        lib.trpc_iobuf_destroy(resp)
