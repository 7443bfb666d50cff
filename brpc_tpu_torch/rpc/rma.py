"""One-sided RMA regions — registered, remotely-writable response buffers;
port of brpc_tpu/rpc/rma.py.

`RmaBuffer` is the Python surface of cpp/net/rma.h's region registry: the
buffer's bytes are shm-backed and registered under an rkey, so a batch call
that uses it as a `resp_bufs` entry advertises the rkey on the request
(meta tail-group 6) and — over shm/ici connections — the SERVER writes the
response payload straight into this buffer with zero receiver-side copies,
signalling completion with a release-fenced chunk bitmap plus one tiny
control frame.  Over TCP (or when the one-sided plane is off) the same
buffer degrades to the striped copy-path landing.

The port adds a uint8 CPU tensor over the registered bytes (`tensor`), and,
with a CUDA `device`, registers the region with the CUDA driver
(cudaHostRegister, as zerocopy.alloc_staging does for the staging slab):
a landed response then goes back to the card with one H2D DMA.  A failed
registration raises; the buffer never carries on unregistered.

Usage:

    buf = rma.RmaBuffer(64 << 20, device="cuda")
    pipe.submit("Echo.Echo", [req], resp_bufs=[buf])
    ...
    back = buf.tensor.to("cuda", non_blocking=True)
    buf.free()        # or use it as a context manager

The memory stays mapped until `free()` ran AND the runtime's references
drop: the region registry defers the unmap while any in-flight call is
still bound to the buffer, and views hold it past that.  Contract for
FAILED calls: a call that timed out or was cancelled while using this
buffer may have a server-side put still writing into the shared pages — do
not REUSE the buffer for a new call until that horizon passes; `free()`
and allocating a fresh buffer is the cheap, always-safe pattern.  No view
(`view`, `tensor`) may be used after `free()`.
"""

from __future__ import annotations

import ctypes

import torch

from brpc_tpu_torch.rpc._lib import load_library


class RmaBuffer:
    """`size` shm-backed bytes registered for one-sided remote writes —
    and with the CUDA driver too when `device` is a CUDA device."""

    def __init__(self, size: int, device=None):
        if size <= 0:
            raise ValueError("RmaBuffer size must be positive")
        lib = load_library()
        rkey = ctypes.c_uint64()
        base = lib.trpc_rma_alloc(size, ctypes.byref(rkey))
        if not base:
            raise MemoryError(f"trpc_rma_alloc({size}) failed")
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            try:
                rc = int(torch.cuda.cudart().cudaHostRegister(base, size, 0))
            except BaseException:  # no CUDA runtime: nothing registered
                lib.trpc_rma_free(base)
                raise
            if rc != 0:
                lib.trpc_rma_free(base)
                raise RuntimeError(f"cudaHostRegister of an RmaBuffer of "
                                   f"{size} bytes failed: cudaError {rc}")
        self._lib = lib
        self._base = base
        self._size = size
        self._rkey = rkey.value
        self._cuda = cuda
        # A ctypes array over the mapped bytes: buffer-protocol writable,
        # so it works anywhere a bytearray/numpy resp_buf does; the tensor
        # shares its memory and keeps it referenced.
        self._view = (ctypes.c_char * size).from_address(base)
        self._tensor = torch.frombuffer(self._view, dtype=torch.uint8)

    @property
    def view(self):
        """Writable buffer-protocol view of the registered bytes."""
        if self._base is None:
            raise ValueError("RmaBuffer already freed")
        return self._view

    @property
    def tensor(self) -> torch.Tensor:
        """Flat uint8 CPU tensor over the registered bytes (no copy)."""
        if self._base is None:
            raise ValueError("RmaBuffer already freed")
        return self._tensor

    @property
    def rkey(self) -> int:
        return self._rkey

    @property
    def nbytes(self) -> int:
        return self._size

    @property
    def address(self) -> int:
        if self._base is None:
            raise ValueError("RmaBuffer already freed")
        return self._base

    @property
    def cuda_registered(self) -> bool:
        return self._cuda and self._base is not None

    def free(self) -> None:
        """Unregisters the region (idempotent): from the CUDA driver first,
        then from the runtime, whose unmap is deferred while an in-flight
        call's landing registration still references the bytes; new calls
        can no longer use the buffer."""
        base, self._base = self._base, None
        if base is None:
            return
        self._view = self._tensor = None
        rc = 0
        if self._cuda:
            rc = int(torch.cuda.cudart().cudaHostUnregister(base))
        self._lib.trpc_rma_free(base)
        if rc != 0:
            raise RuntimeError(
                f"cudaHostUnregister of an RmaBuffer failed: cudaError {rc}")

    def __enter__(self) -> "RmaBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.free()

    def __len__(self) -> int:
        return self._size

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.free()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def kernel_supports(feature: str) -> int:
    """Runtime kernel-capability probe (base/proc.h): 1 supported, 0 not,
    -1 unknown.  ``kernel_supports("io_uring")`` gates an io_uring
    transport: kernels before 5.1 answer ENOSYS."""
    return int(load_library().trpc_kernel_supports(feature.encode()))
