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


def phase_split(in_ptr: int, out_ptr: int, n: int):
    """How K1 moves n lanes from in_ptr to out_ptr, as its launch in
    csrc/echo_kernel.cu decides: (head, body, tail) lane counts when the
    two share a 16-byte phase — head scalar lanes up to in's first 16-byte
    boundary (at most 3), body lanes as 16-byte loads and stores, tail
    scalar lanes — or None when they do not, and every lane moves as a
    scalar (the ragged path).  Both must be 4-byte aligned."""
    if in_ptr % 4 or out_ptr % 4:
        raise ValueError(f"K1 needs 4-byte-aligned lanes, got in at "
                         f"{in_ptr:#x} and out at {out_ptr:#x}")
    if in_ptr % 16 != out_ptr % 16:
        return None
    head = min(-in_ptr % 16 // 4, n)
    body = (n - head) // 4 * 4
    return head, body, n - head - body


def copy_offset(in_ptr: int, alloc_ptr: int) -> int:
    """The lane (0 to 3) of an allocation at alloc_ptr at which a copy
    shares the 16-byte phase of a payload at in_ptr, so that K1 takes its
    16-byte body; the allocation holds 3 lanes more than the copy."""
    return (in_ptr - alloc_ptr) % 16 // 4


def _as_uint32(payload: torch.Tensor) -> torch.Tensor:
    """The payload as the uint32 lanes the reference's kernel stores:
    other integer types convert like `astype(uint32)` (one more pass);
    bool and floating payloads raise TypeError, as the reference's kernel
    refuses to store them into its uint32 copy."""
    if payload.dtype == torch.uint32:
        return payload
    if (payload.dtype == torch.bool or payload.is_floating_point()
            or payload.is_complex()):
        raise TypeError(f"the echo kernel takes integer lanes, not "
                        f"{payload.dtype}")
    return payload.to(torch.int32).view(torch.uint32)


def _cuda_payload(payload: torch.Tensor, what: str) -> torch.Tensor:
    """The payload as K1 reads it: flat, uint32, contiguous.  A strided
    view is made contiguous on the card first (one more pass; the
    reference's slice is a fresh array too)."""
    if payload.device.type != "cuda":
        raise RuntimeError(
            f"{what} runs on cuda or cpu tensors, not {payload.device}")
    if payload.dim() != 1:
        raise TypeError(f"{what} takes a flat payload, got shape "
                        f"{tuple(payload.shape)}")
    payload = _as_uint32(payload)
    if not payload.is_contiguous():
        payload = payload.view(torch.int32).contiguous().view(torch.uint32)
    return payload


def _alloc_copy(payload: torch.Tensor) -> torch.Tensor:
    """An int32 copy buffer in the payload's 16-byte phase (see
    copy_offset)."""
    n = payload.numel()
    if payload.data_ptr() % 16 == 0:
        return torch.empty(n, dtype=torch.int32, device=payload.device)
    buf = torch.empty(n + 3, dtype=torch.int32, device=payload.device)
    off = copy_offset(payload.data_ptr(), buf.data_ptr())
    return buf[off:off + n]


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
    """payload: uint32[n] with n % (rows*cols) == 0, any 4-byte-aligned
    or strided view (other integer types convert like astype(uint32)).
    Returns (copy, checksum): a uint32 copy, in the payload's 16-byte phase
    on the card, and a 0-dim uint32 checksum.  rows/cols keep the
    reference's tile contract (the alignment the caller must meet); the
    Hopper kernel picks its own launch geometry."""
    n = payload.shape[0]
    block = rows * cols
    if n % block != 0:
        raise AssertionError(f"payload lanes {n} not a multiple of {block}")
    return _fused(payload, None, "echo_fused")


def echo_fused_geom(payload: torch.Tensor, geometry):
    """echo_fused at a launch geometry (threads, unroll, blocks_per_sm) of
    the compiled set, through the geometry entry — the launch-geometry
    sweep's kernel.  Same result as echo_fused; a CPU payload takes the
    plain version."""
    return _fused(payload, check_geometry(geometry), "echo_fused_geom")


def _fused(payload: torch.Tensor, geometry, what: str):
    if payload.device.type == "cpu":
        return echo_reference(_as_uint32(payload))
    payload = _cuda_payload(payload, what)
    # int32 storage viewed as uint32: the allocation and zero fill stay
    # clear of gaps in torch's uint32 support.  The kernel launches on the
    # current device, so make it the payload's.
    with torch.cuda.device(payload.device):
        copy = _alloc_copy(payload)
        acc = torch.zeros(1, dtype=torch.int32, device=payload.device)
        _launch(payload, copy, acc, geometry)
    return copy.view(torch.uint32), acc.view(torch.uint32)[0]


def echo_fused_into(payload: torch.Tensor, copy: torch.Tensor,
                    acc: torch.Tensor, geometry=None) -> None:
    """K1 over preallocated buffers, for timing the device alone: copy (an
    int32 tensor of the payload's size) receives the payload and acc (one
    int32) gets the payload's sum added, mod 2^32 — acc is not zeroed.
    `geometry` None launches brpc_echo_fused, else the geometry entry.
    For a contiguous uint32 payload it allocates, fills and synchronises
    nothing, so a CUDA graph can capture it; a CPU payload takes the plain
    version."""
    if geometry is not None:
        geometry = check_geometry(geometry)
    if payload.device.type == "cpu":
        copy.copy_(_as_uint32(payload).view(torch.int32))
        acc.add_(sum32(payload).view(torch.int32))
        return
    payload = _cuda_payload(payload, "echo_fused_into")
    if (copy.dtype != torch.int32 or copy.numel() != payload.numel()
            or not copy.is_contiguous()
            or acc.dtype != torch.int32 or acc.numel() != 1
            or copy.device != payload.device or acc.device != payload.device):
        raise ValueError("echo_fused_into needs a contiguous int32 copy of "
                         "the payload's size and one int32 acc on its "
                         "device")
    with torch.cuda.device(payload.device):
        _launch(payload, copy, acc, geometry)


def echo_reference(payload: torch.Tensor):
    """The plain torch composition the kernel fuses: a copy and sum32.
    Used for CPU payloads and as the kernel's check on the card.  The copy
    has the reference's `payload + jnp.uint32(0)` type and value: small
    unsigned lanes and bools widen to uint32, signed ones to int32, int64
    wraps to int32, float64 rounds to float32, and -0.0 becomes +0.0."""
    if payload.dtype == torch.uint32:  # copied as int32 bits, as above
        return payload.view(torch.int32).clone().view(torch.uint32), \
            sum32(payload)
    if payload.is_floating_point():
        if payload.dtype == torch.float64:
            payload = payload.to(torch.float32)
        # x + 0 turns -0.0 into +0.0 and changes nothing else; torch's
        # bf16 add would also drop a NaN's sign, so it is not used.
        return payload.masked_fill(payload == 0, 0), sum32(payload)
    copy = payload.to(torch.int32, copy=True)
    if payload.dtype in (torch.bool, torch.uint8, torch.uint16):
        copy = copy.view(torch.uint32)
    return copy, sum32(payload)
