"""Runtime flag access from Python — port of brpc_tpu/rpc/flags.py (the
/flags service's programmatic form; parity: reloadable_flags.h +
flags_service).  Flags defined by the native runtime (e.g. rpcz_enabled,
per-method max_concurrency_*) can be read and flipped live."""

from __future__ import annotations

import ctypes

from brpc_tpu_torch.rpc._lib import load_library


def set_flag(name: str, value: str) -> None:
    """Validated runtime flip; raises on unknown/bad/immutable flags."""
    rc = load_library().trpc_flag_set(name.encode(), str(value).encode())
    if rc != 0:
        reason = {-1: "unknown flag", -2: "rejected value",
                  -3: "immutable"}.get(rc, f"error {rc}")
        raise ValueError(f"set_flag({name!r}): {reason}")


def get_flag(name: str) -> str:
    lib = load_library()
    size = 256
    while True:
        out = ctypes.create_string_buffer(size)
        rc = lib.trpc_flag_get(name.encode(), out, ctypes.c_size_t(size))
        if rc == 0:
            return out.value.decode()
        if rc == -2 and size < 1 << 20:  # value larger than the buffer
            size *= 4
            continue
        raise KeyError(name)
