"""Fused echo kernel — port of brpc_tpu/ops/echo_kernel.py.

The echo server's work per payload is "receive, verify, materialize the
response": a copy plus a checksum.  `echo_fused` does both in one pass over
device memory with kernel K1 (csrc/echo_kernel.cu, replacing the reference's
Pallas `_kernel`).  A CUDA payload always goes to the kernel, or raises; a
CPU payload takes the plain version, `echo_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.ops.checksum import sum32

_ROWS = 16       # block rows of the reference's tile contract
_COLS = 8192     # lanes per row
_BLOCK = _ROWS * _COLS  # uint32 lanes per reference grid step (512KB)

KERNEL = "echo_kernel"   # csrc/<KERNEL>.cu
WRAPPER = "echo_fused"   # its name in _kernels.launches
GEOM_WRAPPER = "echo_fused_geom"  # the geometry entry's name there

#: Launch geometries the geometry entry has compiled in, and the one
#: `brpc_echo_fused` launches: (threads per block, uint4 loads in flight
#: per thread, blocks per SM) — csrc's kThreads, kUnroll, kBlocksPerSm.
GEOM_THREADS = (128, 256, 512, 1024)
GEOM_UNROLLS = (2, 4, 8)
DEFAULT_GEOMETRY = (256, 4, 8)


@functools.cache
def _entry():
    fn = _kernels.load(KERNEL).brpc_echo_fused
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_size_t, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _geom_entry():
    fn = _kernels.load(KERNEL).brpc_echo_fused_geom
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(payload: torch.Tensor, copy: torch.Tensor,
            acc: torch.Tensor, geometry=None) -> None:
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    if geometry is None:
        rc = _entry()(payload.data_ptr(), copy.data_ptr(), acc.data_ptr(),
                      payload.numel(), stream)
    else:
        threads, unroll, blocks_per_sm = geometry
        rc = _geom_entry()(payload.data_ptr(), copy.data_ptr(),
                           acc.data_ptr(), payload.numel(), threads, unroll,
                           blocks_per_sm, stream)
    if rc != 0:
        raise RuntimeError(f"echo kernel launch failed: cudaError {rc}")
    _kernels.count_launch(WRAPPER if geometry is None else GEOM_WRAPPER)


def _check_cuda_payload(payload: torch.Tensor, what: str) -> None:
    if payload.device.type != "cuda":
        raise RuntimeError(
            f"{what} runs on cuda or cpu tensors, not {payload.device}")
    if payload.dtype != torch.uint32 or payload.dim() != 1:
        raise TypeError(
            f"{what} takes a flat uint32 payload, got {payload.dtype} "
            f"of shape {tuple(payload.shape)}")
    if not payload.is_contiguous():
        raise ValueError(f"{what} needs a contiguous payload")
    if payload.data_ptr() % 16 != 0:
        raise ValueError(f"{what} needs a 16-byte-aligned payload")


def check_geometry(geometry) -> tuple:
    """`geometry` as (threads, unroll, blocks_per_sm) ints, or ValueError
    when the geometry entry has not compiled it in."""
    threads, unroll, blocks_per_sm = (int(g) for g in geometry)
    if (threads not in GEOM_THREADS or unroll not in GEOM_UNROLLS
            or blocks_per_sm < 1):
        raise ValueError(
            f"geometry {geometry}: threads must be one of {GEOM_THREADS}, "
            f"unroll one of {GEOM_UNROLLS}, blocks per SM >= 1")
    return threads, unroll, blocks_per_sm


def echo_fused(payload: torch.Tensor, rows: int = _ROWS, cols: int = _COLS):
    """payload: uint32[n] with n % (rows*cols) == 0.  Returns (copy,
    checksum), the checksum a 0-dim uint32 tensor.  rows/cols keep the
    reference's tile contract (the alignment the caller must meet); the
    Hopper kernel picks its own launch geometry."""
    n = payload.shape[0]
    block = rows * cols
    if n % block != 0:
        raise AssertionError(f"payload lanes {n} not a multiple of {block}")
    if payload.device.type == "cpu":
        return echo_reference(payload)
    _check_cuda_payload(payload, "echo_fused")
    # int32 storage viewed as uint32: the allocation and zero fill stay
    # clear of gaps in torch's uint32 support.  The kernel launches on the
    # current device, so make it the payload's.
    with torch.cuda.device(payload.device):
        copy = torch.empty(n, dtype=torch.int32, device=payload.device)
        acc = torch.zeros(1, dtype=torch.int32, device=payload.device)
        _launch(payload, copy, acc)
    return copy.view(torch.uint32), acc.view(torch.uint32)[0]


def echo_fused_geom(payload: torch.Tensor, geometry):
    """echo_fused at a launch geometry (threads, unroll, blocks_per_sm) of
    the compiled set, through the geometry entry — the launch-geometry
    sweep's kernel.  Same result as echo_fused; a CPU payload takes the
    plain version."""
    geometry = check_geometry(geometry)
    if payload.device.type == "cpu":
        return echo_reference(payload)
    copy = torch.empty(payload.numel(), dtype=torch.int32,
                       device=payload.device)
    acc = torch.zeros(1, dtype=torch.int32, device=payload.device)
    echo_fused_into(payload, copy, acc, geometry)
    return copy.view(torch.uint32), acc.view(torch.uint32)[0]


def echo_fused_into(payload: torch.Tensor, copy: torch.Tensor,
                    acc: torch.Tensor, geometry=None) -> None:
    """K1 over preallocated buffers, for timing the device alone: copy (an
    int32 tensor of the payload's size) receives the payload and acc (one
    int32) gets the payload's sum added, mod 2^32 — acc is not zeroed.
    `geometry` None launches brpc_echo_fused, else the geometry entry.
    Allocates, fills and synchronises nothing, so a CUDA graph can capture
    it; a CPU payload takes the plain version."""
    if geometry is not None:
        geometry = check_geometry(geometry)
    if payload.device.type == "cpu":
        copy.copy_(payload.view(torch.int32))
        acc.add_(sum32(payload).view(torch.int32))
        return
    _check_cuda_payload(payload, "echo_fused_into")
    if (copy.dtype != torch.int32 or copy.numel() != payload.numel()
            or acc.dtype != torch.int32 or acc.numel() != 1
            or copy.device != payload.device or acc.device != payload.device):
        raise ValueError("echo_fused_into needs an int32 copy of the "
                         "payload's size and one int32 acc on its device")
    with torch.cuda.device(payload.device):
        _launch(payload, copy, acc, geometry)


def echo_reference(payload: torch.Tensor):
    """The plain torch composition the kernel fuses: a copy and sum32.
    Used for CPU payloads and as the kernel's check on the card."""
    if payload.dtype == torch.uint32:  # copied as int32 bits, as above
        return payload.view(torch.int32).clone().view(torch.uint32), \
            sum32(payload)
    return payload.clone(), sum32(payload)
