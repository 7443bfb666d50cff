"""Python-facing RPC server over the native runtime — port of
brpc_tpu/rpc/server.py (Call.respond and the Server lifecycle).

Handlers run on fiber worker threads (ctypes re-acquires the GIL); they may
respond inline or keep the call handle and respond later (async), mirroring
the done-closure contract of the C++ `Server` (cpp/net/server.h).  The QoS,
KV, naming, collective, tuner, SLO and inference attachments of the
reference are left to later slices of the port.
"""

from __future__ import annotations

import ctypes
from typing import Callable

from brpc_tpu_torch.rpc._lib import load_library

_HANDLER_CFUNC = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.POINTER(ctypes.c_char), ctypes.c_size_t,
    ctypes.c_void_p
)


class Call:
    """One in-flight request; respond() completes it.

    Completion is idempotent — the native side accepts exactly one respond
    per call and ignores the rest, so an async handler racing an error path
    can never double-complete.
    """

    def __init__(self, lib, handle: int):
        self._lib = lib
        self._handle = handle

    def respond(self, data: bytes = b"", error_code: int = 0,
                error_text: str = "") -> bool:
        """Returns True if this respond completed the call (False if it was
        already completed elsewhere)."""
        rc = self._lib.trpc_call_respond(
            self._handle, data, len(data), error_code, error_text.encode()
        )
        return rc == 0


class Server:
    def __init__(self):
        self._lib = load_library()
        self._ptr = self._lib.trpc_server_create()
        self._keepalive = []  # ctypes callbacks must outlive the server

    def register(self, method: str, fn: Callable[[Call, bytes], None]) -> None:
        """fn(call, request_bytes) — call call.respond(...) when done."""
        lib = self._lib

        def thunk(handle, req_ptr, req_len, _ctx):
            call = Call(lib, handle)
            try:
                fn(call, ctypes.string_at(req_ptr, req_len))
            except Exception as e:  # noqa: BLE001 - never leak the call
                # respond is idempotent: a handler that already responded
                # makes this a no-op, otherwise the caller gets the error.
                call.respond(error_code=13, error_text=repr(e))

        cb = _HANDLER_CFUNC(thunk)
        self._keepalive.append(cb)
        if lib.trpc_server_register(self._ptr, method.encode(), cb, None) != 0:
            raise RuntimeError(f"register {method!r} failed (server running?)")

    def register_native_echo(self, method: str = "Echo.Echo") -> None:
        """Registers a NATIVE zero-copy echo handler for `method` — the
        request blocks are ref-shared into the response with no Python
        callback and no GIL: the server side of the data-plane runs."""
        if self._lib.trpc_server_register_echo(
                self._ptr, method.encode()) != 0:
            raise RuntimeError(
                f"register_native_echo {method!r} failed (server running?)")

    def start(self, port: int = 0) -> int:
        if self._lib.trpc_server_start(self._ptr, port) != 0:
            raise RuntimeError("server start failed")
        return self.port

    @property
    def port(self) -> int:
        return self._lib.trpc_server_port(self._ptr)

    def stop(self) -> None:
        self._lib.trpc_server_stop(self._ptr)

    def close(self) -> None:
        """Stops and frees the native server.  Only call once no requests
        are in flight (handlers hold references into the server)."""
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_server_stop(ptr)
            self._lib.trpc_server_destroy(ptr)
