"""Probe: which CUDA pointers can enter the IOBuf path, the way RDMA lkeys
do — port of tools/pjrt_probe.py.

The reference asks what the PJRT stack will give the ICI transport's
`ici_set_slab_registrar` seam (cpp/net/ici_transport.h): a raw device
pointer, a DLPack export, a host staging copy, an adopted slab, pointer
identity through an IOBuf.  The same five attempts on the card:

  A. `tensor.data_ptr()`        — the raw device pointer.
  B. DLPack (`torch.utils.dlpack`) — export, device type, and whether the
     round trip keeps the pointer (zero copy).
  C. host staging: one D2H copy into pinned memory; where the bytes land.
  D. `cudaHostRegister` of the port's own slab (the ici staging slab,
     `zerocopy.alloc_staging`), then a device copy into it through its
     mapped device pointer (under UVA the same address, handed to torch
     by `__cuda_array_interface__`): the card writes the slab directly.
  E. pointer identity through the IOBuf user-data seam
     (`trpc_iobuf_append_user_data`, then `trpc_iobuf_block_ptr`), only
     for a pointer the host can read — read first through /proc/self/mem,
     which cannot fault, and counted readable only when the bytes read
     are the tensor's (a device address reads without error) — for A's
     and D's pointers.

Each attempt runs in a child of its own (killed, with its process group,
when it overruns), all at once.  `--cpu` probes the CPU as the control:
there A, B, C and E must succeed, which proves the probe itself works.
The results are printed and written as Markdown to `--out` (by default
brpc_tpu_torch/tools/CUDA_PROBE.md).

Run on the GPU:  python -m brpc_tpu_torch.tools.cuda_probe
The control:     python -m brpc_tpu_torch.tools.cuda_probe --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "brpc_tpu_torch", "tools", "CUDA_PROBE.md")
ATTEMPTS = ("A_data_ptr", "B_dlpack", "C_host_staging",
            "D_register_our_slab", "E_pointer_identity")

CHILD = r"""
import ctypes, json, sys
import torch
attempt, device = sys.argv[1], sys.argv[2]
dev = torch.device(device)
cuda = dev.type == "cuda"
n = 4096
t = torch.arange(n, dtype=torch.int32, device=dev).remainder(256).to(
    torch.uint8).reshape(64, 64)
want = bytes(i % 256 for i in range(n))
if cuda:
    torch.cuda.synchronize()
out = {"ok": True}


# The bytes at ptr read through /proc/self/mem (no fault possible), or
# None.  A device address can read without error (its virtual range is
# reserved in the process), so only bytes equal to the tensor's count as
# readable.
def host_read(ptr, size):
    try:
        with open("/proc/self/mem", "rb") as m:
            m.seek(ptr)
            return m.read(size)
    except (OSError, ValueError, OverflowError):
        return None


def host_readable(ptr, size=16):
    return host_read(ptr, size) == want[:size]


def through_iobuf(ptr, size):
    from brpc_tpu_torch.rpc import zerocopy
    from brpc_tpu_torch.rpc._lib import load_library
    lib = load_library()
    iob = lib.trpc_iobuf_create()
    try:
        token = zerocopy.pin(t)
        lib.trpc_iobuf_append_user_data(
            iob, ptr, size, ctypes.cast(zerocopy.release_cb,
                                        ctypes.c_void_p), token)
        block = zerocopy.block_ptr(iob, 0, lib)
        got = ctypes.create_string_buffer(size)
        lib.trpc_iobuf_copy_to(iob, got, size, 0)
        return {"block_ptr": hex(block), "identity": block == ptr,
                "bytes_match": got.raw == want}
    finally:
        lib.trpc_iobuf_destroy(iob)


def our_slab():
    from brpc_tpu_torch.rpc import zerocopy
    slab = zerocopy.alloc_staging(n, device=dev)
    res = {"our_ptr": hex(slab.data_ptr()), "registered": cuda,
           "is_pinned": bool(cuda and slab.is_pinned())}
    src = t.reshape(-1)
    if cuda:
        class Mapped:
            __cuda_array_interface__ = {
                "shape": (n,), "typestr": "|u1", "version": 2,
                "data": (slab.data_ptr(), False), "strides": None}
        alias = torch.as_tensor(Mapped(), device=dev)
        res["device_ptr"] = hex(alias.data_ptr())
        res["device_ptr_is_host_ptr"] = alias.data_ptr() == slab.data_ptr()
        alias.copy_(src)
        torch.cuda.synchronize()
    else:
        slab.copy_(src)
    res["bytes_match"] = bytes(slab.numpy().tobytes()) == want
    return slab, res


try:
    if attempt == "A_data_ptr":
        raw = host_read(t.data_ptr(), 16)
        out.update(ptr=hex(t.data_ptr()), device=str(t.device),
                   proc_mem_read=raw is not None,
                   host_readable=raw == want[:16])
    elif attempt == "B_dlpack":
        from torch.utils import dlpack
        cap = dlpack.to_dlpack(t)
        back = dlpack.from_dlpack(cap)
        out.update(dl_device=list(t.__dlpack_device__()),
                   capsule=type(cap).__name__,
                   same_ptr=back.data_ptr() == t.data_ptr())
    elif attempt == "C_host_staging":
        host = torch.empty(n, dtype=torch.uint8, pin_memory=cuda)
        host.copy_(t.reshape(-1))
        if cuda:
            torch.cuda.synchronize()
        out.update(ptr=hex(host.data_ptr()), pinned=bool(host.is_pinned()),
                   bytes_match=bytes(host.numpy().tobytes()) == want,
                   note=("one device->host copy into pinned memory"
                         if cuda else "one host copy (no device)"))
    elif attempt == "D_register_our_slab":
        slab, res = our_slab()
        out.update(res)
        out["ok"] = res["bytes_match"]
        from brpc_tpu_torch.rpc import zerocopy
        zerocopy.free_staging(slab)
    elif attempt == "E_pointer_identity":
        cands = {"A_data_ptr": t.data_ptr()}
        slab, _ = our_slab()
        cands["D_register_our_slab"] = slab.data_ptr()
        for name, ptr in cands.items():
            readable = host_readable(ptr)
            entry = {"ptr": hex(ptr), "host_readable": readable}
            if readable:
                entry.update(through_iobuf(ptr, n))
            out[name] = entry
        out["ok"] = any(e.get("identity") and e.get("bytes_match")
                        for e in out.values() if isinstance(e, dict))
except Exception as e:  # noqa: BLE001 - the attempt's outcome
    out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
print(json.dumps(out), flush=True)
"""


def run_attempt(attempt: str, device: str, timeout: float = 120.0) -> dict:
    """One attempt in a child of its own; its JSON result, or the error."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, attempt, device], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait(timeout=10)
        return {"ok": False, "error": f"timeout after {timeout}s"}
    for line in stdout.decode(errors="replace").splitlines()[::-1]:
        if line.startswith("{"):
            return json.loads(line)
    return {"ok": False, "error": f"no result (rc {proc.returncode})",
            "stderr": stderr.decode(errors="replace")[-2000:]}


def probe(device: str, timeout: float = 120.0) -> dict:
    """Every attempt on `device`, in parallel children."""
    with ThreadPoolExecutor(max_workers=len(ATTEMPTS)) as pool:
        futs = {a: pool.submit(run_attempt, a, device, timeout)
                for a in ATTEMPTS}
        attempts = {a: f.result() for a, f in futs.items()}
    return {"backend": _backend(device), "attempts": attempts}


def _backend(device: str) -> dict:
    import torch

    out = {"device": device, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if device != "cpu":
        out["kind"] = torch.cuda.get_device_name(0)
    return out


def report(results: dict) -> str:
    return "\n".join([
        "# CUDA pointer registration probe — committed output",
        "",
        "Written by `python -m brpc_tpu_torch.tools.cuda_probe` (re-run to "
        "reproduce).  Question: which CUDA pointers can enter the IOBuf "
        "path by reference, the way the reference's tools/PJRT_PROBE.md "
        "asks of the PJRT stack: a raw device pointer (A), a DLPack export "
        "(B), a pinned staging copy (C), the port's own staging slab "
        "registered with the CUDA driver and written by the card (D), and "
        "pointer identity through the IOBuf user-data seam for a pointer "
        "the host can read (E).  `cpu_control` is the same probe on the "
        "CPU, where A, B, C and E must succeed.",
        "",
        "```json",
        json.dumps(results, indent=2),
        "```",
        ""])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="probe the CPU only (the control)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="Markdown report path")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    results = {}
    if not args.cpu:
        from brpc_tpu_torch import resolve_device

        dev = resolve_device()  # no card: raise, before any child
        results["cuda"] = probe(str(dev), args.timeout)
    results["cpu_control"] = probe("cpu", args.timeout)
    print(json.dumps(results, indent=2))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(report(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
