"""Build, load and count the port's hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into a shared library with a plain
C interface, at first use, under build/torch_kernels/ with a hash of the
source in its name; ctypes loads it.  Nothing here runs at import: this
module is imported on machines without nvcc or a GPU, where the wrappers
take their plain versions for CPU tensors and raise for anything else.

`launches` counts, per wrapper, the kernel launches that wrapper made — a run
resets it and reads it back to show the main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_OUT = _CSRC.parent.parent / "build" / "torch_kernels"
_ARCH = "arch=compute_90a,code=sm_90a"
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

#: Kernel launches per wrapper name since the last reset_launches().
launches: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    """Called by a wrapper right after its kernel launched (and only then)."""
    launches[name] += 1


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension  # noqa: PLC0415 - heavy, lazy

    home = os.environ.get("CUDA_HOME") or cpp_extension.CUDA_HOME
    if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (not on PATH, no CUDA_HOME): the CUDA kernels of "
        "brpc_tpu_torch build only where the CUDA toolkit is installed")


def build(name: str) -> pathlib.Path:
    """Compiles csrc/<name>.cu (when not built yet, judged under a file
    lock shared with other processes) and returns the library's path.  The compiler's resource report (-Xptxas -v) is kept
    beside it as <library>.log.  Raises RuntimeError without nvcc, without
    a GPU, or when the compile fails."""
    nvcc = _nvcc()
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device; none found")
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _OUT / f"lib{name}-{digest}.so"
    _OUT.mkdir(parents=True, exist_ok=True)
    # One build per source across processes: the first to hold the lock
    # compiles, the others find the library when they get it.
    with open(_OUT / f"lib{name}.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return lib
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
                   str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            lib.with_name(lib.name + ".log").write_text(
                proc.stdout + proc.stderr)
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
