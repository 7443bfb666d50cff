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
    crosses from the JAX side, which takes `jnp.asarray` of the same array.
    Values convert like `astype(np.uint32)`."""
    import numpy as np
    import torch

    dev = resolve_device(device)
    host = np.ascontiguousarray(np.asarray(arr).astype(np.uint32).ravel())
    # Moved as int32 bits: uint32 copies are the narrowest torch support.
    return torch.from_numpy(host.view(np.int32)).to(dev).view(torch.uint32)


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same shape and type on `device` —
    how f32, bf16, uint8 and uint32 state crosses from the JAX side, which
    takes `jnp.asarray` of the same array.  uint32 moves as its int32 bits;
    a bfloat16 array (numpy has no bf16 of its own: ml_dtypes', as
    `np.asarray` of a jax bf16 array gives) converts exactly by way of
    float32, which holds every bf16 value."""
    import numpy as np
    import torch

    dev = resolve_device(device)
    host = np.ascontiguousarray(np.asarray(arr))
    # torch.tensor copies: the result never aliases `arr`, on the CPU too.
    if host.dtype.name == "bfloat16":
        return torch.tensor(host.astype(np.float32), device=dev).to(
            torch.bfloat16)
    if host.dtype == np.uint32:
        return torch.tensor(host.view(np.int32), device=dev).view(
            torch.uint32)
    return torch.tensor(host, device=dev)
