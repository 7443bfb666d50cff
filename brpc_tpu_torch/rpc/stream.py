"""Ordered byte-chunk streams with credit flow control — port of
brpc_tpu/rpc/stream.py (parity: cpp/net/stream.h over capi/stream_capi.cc).

A stream rides an ordinary RPC: the client OFFERS one with
``open_stream(channel, method, request)`` (StreamCreate before
CallMethod); the server handler ACCEPTS it via ``Call.accept_stream()``
before responding.  After the response both ends hold an established
Stream and exchange ordered chunks — writes park while the peer's credit
window is exhausted (the GIL is released, so other Python threads run),
reads block on a plain condition variable fed by the consume fiber.

Thousands of logical streams multiplex over ONE connection: a StreamId
is a runtime handle, not a socket, which is how the inference front door
(rpc/infer.py) holds 100k+ token streams under a 20k fd cap.
"""

from __future__ import annotations

import ctypes

from brpc_tpu_torch.rpc._lib import IOBuf, load_library
from brpc_tpu_torch.rpc.client import RpcError, make_rpc_error


class StreamClosedError(RpcError):
    """The peer closed (or the connection died) and every buffered chunk
    has been drained — raised by read()/read_exactly() instead of
    returning data.  Writes after this surface EPIPE via RpcError."""

    def __init__(self, stream_id: int):
        super().__init__(0, f"stream {stream_id} closed and drained")
        self.stream_id = stream_id


class StreamTimeoutError(RpcError):
    """read() hit its timeout with no chunk buffered and the stream
    still open.  The stream remains usable — retry the read."""

    def __init__(self, stream_id: int, timeout_ms: int):
        super().__init__(
            0, f"stream {stream_id} read timed out after {timeout_ms}ms")
        self.stream_id = stream_id


class StreamChunkTooLargeError(RpcError):
    """The next buffered chunk is larger than read()'s max_bytes.
    NOTHING was consumed or truncated — the chunk stays queued; retry
    with max_bytes >= .needed (silently dropping the tail would
    desynchronize framed readers without any error)."""

    def __init__(self, stream_id: int, needed: int, cap: int):
        super().__init__(
            0, f"stream {stream_id} next chunk is {needed} bytes but the "
               f"read buffer holds only {cap}")
        self.stream_id = stream_id
        self.needed = needed
        self.cap = cap


class Stream:
    """One end of an established stream.  Wraps the capi handle; close()
    is graceful (buffered chunks stay readable on the peer), __del__
    frees the native handle."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    @property
    def id(self) -> int:
        """The runtime StreamId (diagnostics; matches /streams dump)."""
        return int(self._lib.trpc_stream_id(self._handle))

    def read(self, max_bytes: int = 65536, timeout_ms: int = -1) -> bytes:
        """One ordered chunk (chunks never coalesce, split, or
        truncate).  timeout_ms < 0 waits forever.  Raises
        StreamClosedError once the stream is closed and drained,
        StreamTimeoutError on timeout, and StreamChunkTooLargeError
        when the next chunk exceeds max_bytes — the chunk stays queued,
        so retry with max_bytes >= the error's .needed."""
        if self._handle is None:
            raise StreamClosedError(0)
        buf = ctypes.create_string_buffer(max_bytes)
        n = self._lib.trpc_stream_read(self._handle, buf, max_bytes,
                                       timeout_ms)
        if n == -1:
            raise StreamClosedError(self.id)
        if n == -2:
            raise StreamTimeoutError(self.id, timeout_ms)
        if n == -3:
            needed = int(self._lib.trpc_stream_next_len(self._handle))
            raise StreamChunkTooLargeError(self.id, needed, max_bytes)
        return buf.raw[:n]

    def write(self, data: bytes) -> None:
        """Ordered write; parks while the peer's credit window is
        exhausted (GIL released).  Raises on a closed stream or dead
        connection (EPIPE/EINVAL as RpcError)."""
        if self._handle is None:
            raise StreamClosedError(0)
        rc = self._lib.trpc_stream_write(self._handle, data, len(data))
        if rc != 0:
            raise make_rpc_error(self._lib, rc,
                                 f"stream write failed (errno {rc})")

    def pending(self) -> int:
        """Chunks buffered locally, readable without blocking."""
        if self._handle is None:
            return 0
        return int(self._lib.trpc_stream_pending(self._handle))

    def close(self) -> None:
        """Graceful close of this end (idempotent).  The peer reads any
        in-flight chunks, then its reads raise StreamClosedError."""
        if self._handle is not None:
            self._lib.trpc_stream_close(self._handle)

    def destroy(self) -> None:
        """Close and free the native handle.  The stream's callbacks
        hold their own reference, so a consume batch mid-delivery
        finishes safely."""
        handle, self._handle = self._handle, None
        if handle is not None:
            self._lib.trpc_stream_destroy(handle)

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.destroy()

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


def open_stream(channel, method: str, request: bytes = b"",
                timeout_ms: int = 0, window_bytes: int = 0,
                tenant: str = "", priority: int = 0):
    """Offers a stream on `method`'s request over `channel` (a
    client.Channel) and returns ``(Stream, response_bytes)`` once the
    server accepts.  window_bytes = 0 keeps the flag default credit
    window (trpc_stream_window_bytes); tenant/priority override the
    channel's QoS for this call only.  Raises the typed RpcError when
    the call fails (the offered stream is torn down server-side)."""
    lib = load_library()
    resp = IOBuf()
    err_code = ctypes.c_int(0)
    err = ctypes.create_string_buffer(256)
    handle = lib.trpc_stream_open(
        channel._ptr, method.encode(), request, len(request), timeout_ms,
        window_bytes, tenant.encode(), int(priority), resp._ptr,
        ctypes.byref(err_code), err, 256)
    if not handle:
        raise make_rpc_error(lib, err_code.value,
                             err.value.decode(errors="replace"))
    return Stream(lib, handle), resp.to_bytes()
