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


@functools.cache
def _entry():
    fn = _kernels.load(KERNEL).brpc_echo_fused
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_size_t, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(payload: torch.Tensor, copy: torch.Tensor,
            acc: torch.Tensor) -> None:
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    rc = _entry()(payload.data_ptr(), copy.data_ptr(), acc.data_ptr(),
                  payload.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"echo kernel launch failed: cudaError {rc}")
    _kernels.count_launch(WRAPPER)


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
    if payload.device.type != "cuda":
        raise RuntimeError(
            f"echo_fused runs on cuda or cpu tensors, not {payload.device}")
    if payload.dtype != torch.uint32 or payload.dim() != 1:
        raise TypeError(
            f"echo_fused takes a flat uint32 payload, got {payload.dtype} "
            f"of shape {tuple(payload.shape)}")
    if not payload.is_contiguous():
        raise ValueError("echo_fused needs a contiguous payload")
    if payload.data_ptr() % 16 != 0:
        raise ValueError("echo_fused needs a 16-byte-aligned payload")
    # int32 storage viewed as uint32: the allocation and zero fill stay
    # clear of gaps in torch's uint32 support.  The kernel launches on the
    # current device, so make it the payload's.
    with torch.cuda.device(payload.device):
        copy = torch.empty(n, dtype=torch.int32, device=payload.device)
        acc = torch.zeros(1, dtype=torch.int32, device=payload.device)
        _launch(payload, copy, acc)
    return copy.view(torch.uint32), acc.view(torch.uint32)[0]


def echo_reference(payload: torch.Tensor):
    """The plain torch composition the kernel fuses: a copy and sum32.
    Used for CPU payloads and as the kernel's check on the card."""
    if payload.dtype == torch.uint32:  # copied as int32 bits, as above
        return payload.view(torch.int32).clone().view(torch.uint32), \
            sum32(payload)
    return payload.clone(), sum32(payload)
