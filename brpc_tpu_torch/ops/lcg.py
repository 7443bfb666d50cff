"""The pipeline step's microbatch producer: an iterated uint32 LCG over a
seeded vector.  Port of the jitted jnp loop of tools/pipeline_step.py:63-80
(`_piece_seed` and `_make_kernel`), which is not a Pallas kernel.

`lcg(words, base, iters, device)` returns uint32[words] with
v[i] = i * 2654435761 + base, then `iters` times v = v * 1664525 +
1013904223, all mod 2^32.  On a CUDA device it is one launch of
csrc/lcg_kernel.cu (or raises); on the CPU it is `lcg_plain`, the same loop
in int64 masked to 32 bits after each step (torch's uint32 add and mul
raise).  `lcg_jump` gives the plain loop's result in a few tensor operations
(`iters` steps of an affine map compose to one affine map), for checking
many pieces at once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from brpc_tpu_torch import resolve_device
from brpc_tpu_torch.ops import _kernels

KERNEL = "lcg_kernel"  # csrc/<KERNEL>.cu
WRAPPER = "lcg"        # its name in _kernels.launches

MASK = 0xFFFFFFFF
SEED_MUL = 2654435761  # _piece_seed's multiplier
MUL = 1664525          # Numerical Recipes' LCG constants
ADD = 1013904223


def piece_base(rank: int, microbatch: int, piece: int) -> int:
    """The seed's base for one (rank, microbatch, piece), as `_piece_seed`
    makes it: deterministic, so every mode produces the same gradients."""
    return (rank * 1000003 + microbatch * 10007 + piece * 101 + 1) & MASK


@functools.cache
def _entry():
    fn = _kernels.load(KERNEL).brpc_lcg
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(words: int, base: int, iters: int) -> None:
    if words <= 0:
        raise ValueError(f"lcg needs a positive word count, got {words}")
    if not 0 <= base <= MASK or not 0 <= iters <= MASK:
        raise ValueError(f"lcg base {base} and iters {iters} must be uint32")


def _as_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as a uint32 tensor (int32 bits)."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(
        torch.int32).view(torch.uint32)


def _seed(words: int, base, device) -> torch.Tensor:
    idx = torch.arange(words, dtype=torch.int64, device=device)
    return (idx * SEED_MUL + base) & MASK


def lcg(words: int, base: int, iters: int, device=None) -> torch.Tensor:
    """uint32[words] on `device`: the seeded vector after `iters` LCG steps.
    A CUDA device launches the kernel once on the current stream (building
    it at first use, or raising); the CPU takes `lcg_plain`."""
    _check(words, base, iters)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return lcg_plain(words, base, iters, dev)
    if dev.type != "cuda":
        raise RuntimeError(f"lcg runs on cuda or cpu, not {dev}")
    entry = _entry()  # builds the kernel first: no build, no output
    with torch.cuda.device(dev):
        out = torch.empty(words, dtype=torch.int32, device=dev)
        rc = entry(out.data_ptr(), words, base, iters,
                   torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lcg kernel launch failed: cudaError {rc}")
        _kernels.count_launch(WRAPPER)
    return out.view(torch.uint32)


def lcg_plain(words: int, base: int, iters: int,
              device=None) -> torch.Tensor:
    """The plain torch loop: int64, masked to 32 bits after each step."""
    _check(words, base, iters)
    v = _seed(words, base, resolve_device(device))
    for _ in range(iters):
        v.mul_(MUL).add_(ADD).bitwise_and_(MASK)
    return _as_u32(v)


def affine(iters: int) -> tuple[int, int]:
    """(a, b) with lcg^iters(v) = a * v + b mod 2^32, by repeated squaring
    of the one-step map (MUL, ADD)."""
    a, b = 1, 0                  # the identity
    step_a, step_b = MUL, ADD    # the map for 2^k steps
    while iters:
        if iters & 1:
            a, b = (step_a * a) & MASK, (step_a * b + step_b) & MASK
        step_a, step_b = ((step_a * step_a) & MASK,
                          (step_a * step_b + step_b) & MASK)
        iters >>= 1
    return a, b


def lcg_jump(words: int, bases: torch.Tensor, iters: int) -> torch.Tensor:
    """uint32[len(bases), words]: `lcg_plain(words, base, iters)` for each
    int64 base, on the bases' device, through the composed map.  The
    multiply mod 2^32 splits `a` into 16-bit halves so no int64 overflows."""
    a, b = affine(iters)
    v = _seed(words, bases.to(torch.int64).reshape(-1, 1), bases.device)
    lo = v * (a & 0xFFFF)
    hi = ((v * (a >> 16)) & 0xFFFF) << 16
    return _as_u32((lo + hi + b) & MASK)
