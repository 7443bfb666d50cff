"""Python RPC client — port of brpc_tpu/rpc/client.py (single-server Channel).

This slice carries the sync call path.  The reference Channel's client-side
latency recorder (observe plane), QoS tags and batch pipelines, and the
ClusterChannel, are left to later slices of the port.
"""

from __future__ import annotations

import ctypes

from brpc_tpu_torch.rpc._lib import IOBuf, load_library


class RpcError(Exception):
    def __init__(self, code: int, text: str):
        super().__init__(f"rpc failed (code {code}): {text}")
        self.code = code
        self.text = text


class Channel:
    """Client stub for one server (parity: cpp/net/channel.h).

    use_shm routes same-host calls over shared-memory rings (TCP-handshaked;
    transparent TCP fallback)."""

    def __init__(self, addr: str, timeout_ms: int = 1000,
                 use_shm: bool = False, connection_type: str = "single"):
        self._lib = load_library()
        self._ptr = self._lib.trpc_channel_create_ex(
            addr.encode(), timeout_ms, connection_type.encode(),
            1 if use_shm else 0)
        if not self._ptr:
            raise ValueError(
                f"bad address or options: {addr!r} / {connection_type!r}")

    def call(self, method: str, request: bytes, timeout_ms: int = 0) -> bytes:
        resp = IOBuf()
        err = ctypes.create_string_buffer(256)
        rc = self._lib.trpc_channel_call(
            self._ptr, method.encode(), request, len(request), resp._ptr,
            timeout_ms, err, len(err))
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        return resp.to_bytes()

    @property
    def transport(self) -> str:
        """Live transport name ("tcp", "shm_ring"); "" before first call."""
        out = ctypes.create_string_buffer(32)
        self._lib.trpc_channel_transport(self._ptr, out, 32)
        return out.value.decode()

    def close(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_channel_destroy(ptr)
