"""Zero-copy tensor→wire path — port of brpc_tpu/rpc/zerocopy.py.

A tensor's bytes enter the C++ IOBuf by reference, with the fewest host
copies its device allows:

- A CPU tensor: zero copies.  Its own memory (a numpy view of it) goes to
  `IOBuf::append_user_data`, the wire writes straight from it, and a
  deleter keeps the tensor alive until the last IOBuf reference drops.
  Pointer identity is testable (`block_ptr`).
- A CUDA tensor: exactly ONE device→host copy, into pinned host memory,
  and that buffer enters the IOBuf by reference.  The copy is synchronised
  before the pointer is handed over, so the wire never carries bytes that
  have not landed.

`alloc_staging` gives a registered ici staging slab (cpp/net/ici_transport.h)
as a CPU tensor; for a CUDA caller the slab is also registered with the
CUDA driver (cudaHostRegister), so a device tensor's D2H copy lands in it
directly — the slab is adopted as the copy's destination, with no bounce
buffer.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from brpc_tpu_torch.rpc._lib import load_library

_DELETER_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)

# Buffers whose bytes are on the wire, keyed by token; the entry (and with
# it the last Python reference) drops when the C++ side runs the deleter.
_live: dict[int, tuple] = {}
_lock = threading.Lock()
_next_token = 1

# Slab base address -> True when it is registered with the CUDA driver.
_staging: dict[int, bool] = {}


@_DELETER_T
def _release(data, ctx):  # noqa: ARG001 - data unused, identity is ctx
    # Runs on whatever thread drops the last IOBuf reference (usually a
    # fiber worker after the wire write); ctypes re-acquires the GIL.
    with _lock:
        _live.pop(ctx, None)


#: The CFUNCTYPE deleter for ctypes callers outside this module: pass it as
#: the deleter with a `pin(...)` token as ctx.
release_cb = _release


def live_sends() -> int:
    """Number of buffers currently pinned by in-flight sends (tests)."""
    with _lock:
        return len(_live)


def pin(*objs) -> int:
    """Registers `objs` in the live-send registry and returns the token to
    hand the native side as deleter ctx (with `release_cb`); the entry —
    and the last Python reference to the pinned buffers — drops when the
    runtime runs the deleter."""
    global _next_token
    with _lock:
        token = _next_token
        _next_token += 1
        _live[token] = objs
    return token


def unpin(token: int) -> None:
    """Drops a pin that was never handed to the native side (failed submit
    paths); a pin the runtime owns is released by its deleter."""
    with _lock:
        _live.pop(token, None)


def _flat_bytes(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.contiguous().reshape(-1).view(torch.uint8)


def host_view(tensor: torch.Tensor):
    """(flat_uint8_ndarray, owner): host-visible bytes of a tensor with the
    fewest copies — zero for a contiguous CPU tensor (a view of its own
    memory), exactly one D2H copy into pinned memory for a CUDA tensor,
    synchronised before return."""
    if tensor.device.type == "cpu":
        flat = _flat_bytes(tensor)
        return flat.numpy(), flat
    if tensor.device.type != "cuda":
        raise RuntimeError(f"no host path for a {tensor.device} tensor")
    host = torch.empty(tensor.numel() * tensor.element_size(),
                       dtype=torch.uint8, pin_memory=True)
    land(host, tensor)
    return host.numpy(), host


def land(dst: torch.Tensor, tensor: torch.Tensor) -> int:
    """Copies `tensor`'s bytes into the front of `dst`, a flat uint8 CPU
    tensor (a staging slab, an arena block, pinned memory): one D2H copy
    for a CUDA tensor, synchronised before return, one memcpy for a CPU
    tensor.  Returns the byte length."""
    src = _flat_bytes(tensor)
    n = src.numel()
    if n > dst.numel():
        raise ValueError(f"{n} bytes > destination of {dst.numel()}")
    dst[:n].copy_(src, non_blocking=src.is_cuda)
    if src.is_cuda:
        torch.cuda.current_stream(src.device).synchronize()
    return n


def append_torch(iobuf_ptr: int, tensor: torch.Tensor, lib=None) -> int:
    """Appends `tensor`'s bytes to a trpc_iobuf by REFERENCE (no copy beyond
    the one D2H copy of a CUDA tensor).  The bytes stay alive until the
    IOBuf drops them.  Returns the byte length."""
    lib = lib or load_library()
    flat, owner = host_view(tensor)
    # Keep `flat` itself alive, not just its parents: flattening a
    # NON-contiguous tensor makes a fresh buffer, and pinning only
    # (owner, tensor) would leave the IOBuf holding a dangling pointer.
    token = pin(flat, owner, tensor)
    lib.trpc_iobuf_append_user_data(iobuf_ptr, flat.ctypes.data, flat.size,
                                    ctypes.cast(_release, ctypes.c_void_p),
                                    token)
    return flat.size


def _call_buf(channel, method: str, tensor: torch.Tensor, timeout_ms: int,
              receive):
    lib = channel._lib
    req = lib.trpc_iobuf_create()
    resp = lib.trpc_iobuf_create()
    try:
        append_torch(req, tensor, lib)
        err = ctypes.create_string_buffer(256)
        rc = lib.trpc_channel_call_buf(channel._ptr, method.encode(), req,
                                       resp, timeout_ms, err, len(err))
        if rc != 0:
            # A plain RpcError, as the reference's call_zero_copy raises
            # (lazily imported: client imports batch, which imports us).
            from brpc_tpu_torch.rpc.client import RpcError

            raise RpcError(rc, err.value.decode(errors="replace"))
        return receive(lib, resp, lib.trpc_iobuf_size(resp))
    finally:
        lib.trpc_iobuf_destroy(req)
        lib.trpc_iobuf_destroy(resp)


def call_zero_copy(channel, method: str, tensor: torch.Tensor,
                   timeout_ms: int = 0) -> bytes:
    """Sync RPC whose request payload is `tensor`'s bytes entering the wire
    path by reference.  Returns the response bytes."""
    def receive(lib, resp, n):
        out = ctypes.create_string_buffer(n)
        lib.trpc_iobuf_copy_to(resp, out, n, 0)
        return out.raw

    return _call_buf(channel, method, tensor, timeout_ms, receive)


def call_zero_copy_into(channel, method: str, tensor: torch.Tensor,
                        timeout_ms: int = 0) -> torch.Tensor:
    """call_zero_copy whose response lands in a flat uint8 CPU tensor —
    pinned when `tensor` is on a GPU, so the bytes can go back to the
    device with one H2D copy."""
    def receive(lib, resp, n):
        out = torch.empty(n, dtype=torch.uint8, pin_memory=tensor.is_cuda)
        lib.trpc_iobuf_copy_to(resp, out.data_ptr(), n, 0)
        return out

    return _call_buf(channel, method, tensor, timeout_ms, receive)


def alloc_staging(nbytes: int, device=None, lib=None) -> torch.Tensor:
    """Allocates a REGISTERED ici staging slab and returns a flat uint8 CPU
    tensor over it (no copy).  Bytes living here cross ici ring connections
    as SENDER-OWNED descriptors — one descriptor per payload, no ring DMA
    copy.  With a CUDA `device`, the slab is also registered with the CUDA
    driver, so `land(slab, cuda_tensor)` is one D2H DMA straight into it.
    Free with free_staging() only after every RPC referencing the region
    has completed."""
    lib = lib or load_library()
    ordinal = ctypes.c_uint32()
    base = lib.trpc_ici_staging_alloc(nbytes, ctypes.byref(ordinal))
    if not base:
        raise MemoryError(f"ici staging alloc of {nbytes} bytes failed")
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        rc = torch.cuda.cudart().cudaHostRegister(base, nbytes, 0)
        if int(rc) != 0:
            lib.trpc_ici_staging_free(base)
            raise RuntimeError(f"cudaHostRegister of the staging slab "
                               f"failed: cudaError {int(rc)}")
    with _lock:
        _staging[int(base)] = cuda
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(base),
                            dtype=torch.uint8)


def free_staging(view: torch.Tensor, lib=None) -> None:
    """Unregisters (from the CUDA driver first, when registered there) and
    unlinks a slab from alloc_staging; the unmap is deferred past any
    in-flight wrapped references by the native refcount.  Pass the
    slab-base tensor (resolution is by base address); no view of the slab
    may be used afterwards."""
    lib = lib or load_library()
    base = view.data_ptr()
    with _lock:
        cuda = _staging.pop(base, None)
    if cuda is None:
        return
    if cuda:
        rc = torch.cuda.cudart().cudaHostUnregister(base)
        if int(rc) != 0:
            raise RuntimeError(f"cudaHostUnregister of the staging slab "
                               f"failed: cudaError {int(rc)}")
    lib.trpc_ici_staging_free(base)


def zero_copy_counters(lib=None) -> tuple[int, int]:
    """Process-wide (descriptors, bytes) sent via the sender-owned path —
    asserts that a staged payload really elided the ring copy."""
    lib = lib or load_library()
    wrs, nbytes = ctypes.c_uint64(), ctypes.c_uint64()
    lib.trpc_ici_zero_copy_counters(ctypes.byref(wrs), ctypes.byref(nbytes))
    return wrs.value, nbytes.value


def bench_echo(payload: torch.Tensor, transport: str, iters: int,
               resp: torch.Tensor | None = None, lib=None):
    """The native echo loop over `transport` ("tcp", "shm" or "ici"): an
    in-process server and `iters` sync calls whose request references
    `payload`'s bytes (a flat uint8 CPU tensor, e.g. a staging slab).  The
    first response is content-checked natively; with `resp` (a uint8 CPU
    tensor of the payload's size) one more echo lands there.  Returns
    (goodput GB/s, transport used)."""
    lib = lib or load_library()
    for t in (payload, resp):
        if t is not None and (t.device.type != "cpu"
                              or t.dtype != torch.uint8
                              or not t.is_contiguous()):
            raise ValueError("bench_echo takes contiguous uint8 CPU tensors")
    if resp is not None and resp.numel() < payload.numel():
        raise ValueError("resp is smaller than the payload")
    gbps = ctypes.c_double()
    used = ctypes.create_string_buffer(32)
    err = ctypes.create_string_buffer(256)
    rc = lib.trpc_bench_echo_rpc(
        payload.data_ptr(), payload.numel(), iters, 1, transport.encode(),
        None if resp is None else resp.data_ptr(), ctypes.byref(gbps), used,
        len(used), err, len(err))
    if rc != 0:
        from brpc_tpu_torch.rpc.client import RpcError

        raise RpcError(rc, err.value.decode(errors="replace"))
    return gbps.value, used.value.decode()


def block_ptr(iobuf_ptr: int, index: int = 0, lib=None) -> int:
    """Data pointer of an IOBuf block ref (pointer-identity tests)."""
    lib = lib or load_library()
    return lib.trpc_iobuf_block_ptr(iobuf_ptr, index) or 0
