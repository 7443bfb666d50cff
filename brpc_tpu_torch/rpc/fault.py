"""Deterministic fault injection from Python (cpp/net/fault.h) — port of
brpc_tpu/rpc/fault.py.

Drives the process-wide transport FaultActor: seeded, schedule-driven
packet drop / delay / corruption / truncation / partial writes /
connection resets, applied by the FaultTransport decorator wrapping every
socket's transport.  The same schedule string also works through the
"fault_schedule" flag and a live server's /faults HTTP endpoint — this
module is the pytest-facing form.

Schedule grammar (';'-separated key=value; see cpp/net/fault.h):
    seed=N peer=ip:port after=N max=N
    drop=P corrupt=P trunc=P partial=P reset=P refuse=P delay=P:MS

The svr_* fields (svr_delay=P:MS, svr_error=P:CODE, svr_reject=P) belong
to a SERVER's private actor — install them with `Server.set_faults`, not
here; this transport actor rejects them loudly rather than accepting a
schedule that could never fire.

Determinism: decision i is a pure function of (seed, i), so a given seed
replays the identical fault sequence; `reset()` restarts the sequence and
`log()` returns the injected faults for replay comparison.
"""

from __future__ import annotations

import ctypes

from brpc_tpu_torch.rpc._lib import load_library


def set_schedule(spec: str) -> None:
    """Installs the transport fault schedule ('' disables).  Raises on a
    malformed spec — a typo must not silently mean 'no faults'."""
    if load_library().trpc_fault_set(spec.encode()) != 0:
        raise ValueError(f"bad fault schedule: {spec!r}")


def get_schedule() -> str:
    """The canonical active schedule ('' when off)."""
    lib = load_library()
    out = ctypes.create_string_buffer(4096)
    if lib.trpc_fault_get(out, 4096) != 0:
        return ""
    return out.value.decode()


def log(max_bytes: int = 1 << 16) -> list[str]:
    """Injected faults as '#index point kind' lines, oldest first."""
    lib = load_library()
    out = ctypes.create_string_buffer(max_bytes)
    lib.trpc_fault_log(out, max_bytes)
    text = out.value.decode()
    return [line for line in text.splitlines() if line]


def reset() -> None:
    """Restarts the deterministic sequence (counter + log; schedule
    kept)."""
    load_library().trpc_fault_reset()


def injected() -> int:
    """Faults injected since the last set/reset."""
    return load_library().trpc_fault_injected()
