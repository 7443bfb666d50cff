"""brpc_tpu_torch — the PyTorch/CUDA port of brpc_tpu (reference: brpc_tpu/).

The device data plane runs on an NVIDIA GPU through PyTorch, with the Pallas
kernels of the reference replaced by kernels written by hand for Hopper
(`csrc/`).  The native C++ runtime under cpp/ is shared with the reference and
bound again here (`brpc_tpu_torch.rpc`), so this package imports neither jax
nor anything of brpc_tpu.

Entry points run on the GPU unless the caller asks for the CPU
(`device="cpu"`); with no device given and no GPU present they raise.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

    from brpc_tpu_torch.parallel.fabric import Fabric  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name: str):
    # Loaded at first use, so `import brpc_tpu_torch` loads no torch and a
    # standard-library module of the package (tools.lint_trpc) runs alone.
    if name == "Fabric":
        from brpc_tpu_torch.parallel.fabric import Fabric

        return Fabric
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    GPU.  Raises RuntimeError when no device is given and there is no GPU —
    never a quiet move to the CPU."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def payload_from_numpy(arr, device=None) -> torch.Tensor:
    """A numpy payload as a flat uint32 tensor on `device` — the state that
    crosses from the JAX side, which takes `jnp.asarray(arr).astype(
    jnp.uint32)` of the same array: integer lanes wrap like
    `astype(np.uint32)`, floating lanes saturate (ops/checksum.py)."""
    import numpy as np
    import torch

    dev = resolve_device(device)
    host = np.asarray(arr)
    if host.dtype.kind == "f" or host.dtype.name == "bfloat16":
        from brpc_tpu_torch.ops.checksum import as_u32

        return as_u32(tensor_from_numpy(host, "cpu")).to(dev)
    host = np.ascontiguousarray(host.astype(np.uint32).ravel())
    # Moved as int32 bits: uint32 copies are the narrowest torch support.
    return torch.from_numpy(host.view(np.int32)).to(dev).view(torch.uint32)


#: 64-bit numpy types and the 32-bit ones `jnp.asarray` gives for them.
_NARROW = {"int64": "int32", "uint64": "uint32", "float64": "float32"}


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same shape and type on `device` —
    how f32, bf16, uint8 and uint32 state crosses from the JAX side, which
    takes `jnp.asarray` of the same array.  uint32 moves as its int32 bits,
    and a bfloat16 array (numpy has no bf16 of its own: ml_dtypes',
    as `np.asarray` of a jax bf16 array gives) as its int16 bits, NaN
    payloads included.  64-bit arrays narrow as
    `jnp.asarray` narrows them in 32-bit mode: int64 to int32 and uint64
    to uint32 with wrap, float64 to float32."""
    import numpy as np
    import torch

    dev = resolve_device(device)
    host = np.asarray(arr)
    if host.dtype.name in _NARROW:
        with np.errstate(over="ignore"):
            host = host.astype(_NARROW[host.dtype.name])
    host = np.ascontiguousarray(host)
    # torch.tensor copies: the result never aliases `arr`, on the CPU too.
    if host.dtype.name == "bfloat16":
        return torch.tensor(host.view(np.int16), device=dev).view(
            torch.bfloat16)
    if host.dtype == np.uint32:
        return torch.tensor(host.view(np.int32), device=dev).view(
            torch.uint32)
    return torch.tensor(host, device=dev)
