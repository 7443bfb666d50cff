"""Client for the streamed-inference front door — port of
brpc_tpu/rpc/infer.py (parity: cpp/net/infer.h).

Submit a prompt (a list of token ids) and get back a live token stream:
the server's continuous-batching scheduler admits the request into the
running decode batch, prefills through the content-addressed prefix
cache (matched prompt blocks skip recompute), and pushes one TokenRecord
per decode step down a credit-windowed logical stream — thousands of
which multiplex per connection, so a 20k-fd box serves 100k+ concurrent
completions.

    client = InferClient(channel)
    completion = client.submit([1, 2, 3, 4], max_new_tokens=16)
    print(completion.cached_tokens)        # prompt tokens served by cache
    for tok in completion:                 # one token per decode step
        ...

Cancel by closing the completion (or just dropping the channel): the
server reaps the slot next step and aborts any in-flight prefix pulls
mid-RPC.  An overloaded tenant's submit raises OverloadedError (2005);
an expired deadline surfaces DeadlineExpiredError (2007).

Wire formats mirror cpp/net/infer.h exactly (infer-wire marker):
  InferSubmitWire   <IIII  magic, flags, max_new_tokens, n_prompt_tokens
                    then n x <Q token ids
  InferSubmitReply  <QII   request_id, cached_tokens, block_tokens
  TokenRecord       <QII   token, index, flags   (16 bytes per chunk)
"""

from __future__ import annotations

import struct
from typing import Iterator

from brpc_tpu_torch.rpc import stream as _stream

INFER_MAGIC = 0x31464E49  # "INF1"
SUBMIT_NO_PUBLISH = 1

TOKEN_EOS = 1
TOKEN_CANCELLED = 2

_SUBMIT_HEADER = struct.Struct("<IIII")
_SUBMIT_REPLY = struct.Struct("<QII")
_TOKEN_RECORD = struct.Struct("<QII")

SUBMIT_METHOD = "Infer.Submit"


def pack_submit(prompt_tokens, max_new_tokens: int = 0,
                publish: bool = True) -> bytes:
    """The Infer.Submit request body for `prompt_tokens` (u64 ids)."""
    flags = 0 if publish else SUBMIT_NO_PUBLISH
    return _SUBMIT_HEADER.pack(
        INFER_MAGIC, flags, max_new_tokens, len(prompt_tokens)
    ) + struct.pack(f"<{len(prompt_tokens)}Q", *prompt_tokens)


class TokenRecord:
    """One decode step's output: (token, index, flags)."""

    __slots__ = ("token", "index", "flags")

    def __init__(self, token: int, index: int, flags: int):
        self.token = token
        self.index = index
        self.flags = flags

    @property
    def eos(self) -> bool:
        return bool(self.flags & TOKEN_EOS)

    @property
    def cancelled(self) -> bool:
        return bool(self.flags & TOKEN_CANCELLED)

    def __repr__(self):
        return (f"TokenRecord(token={self.token}, index={self.index}, "
                f"flags={self.flags})")


class CancelledError(Exception):
    """The server cancelled this completion mid-decode (deadline expiry
    or admission reaping) — the final record carried TOKEN_CANCELLED."""


class Completion:
    """A live completion: the submit reply plus the token stream.

    Iterate for token ids (stops cleanly at EOS, raises CancelledError
    on a server-side cancel); records() yields full TokenRecords.
    close() cancels server-side — the scheduler reaps the slot at the
    next step and re-admits a waiter in its place."""

    def __init__(self, stream: "_stream.Stream", request_id: int,
                 cached_tokens: int, block_tokens: int):
        self.stream = stream
        self.request_id = request_id
        # Prompt tokens served by the prefix cache (0 = fully recomputed).
        self.cached_tokens = cached_tokens
        self.block_tokens = block_tokens
        self.finished = False
        self.cancelled = False

    def records(self, timeout_ms: int = -1) -> Iterator[TokenRecord]:
        """Yields TokenRecords until the EOS or CANCELLED record
        (inclusive), or until the stream closes without one (connection
        death — surfaces as plain StopIteration after marking
        cancelled).  A chunk that is not exactly one TokenRecord is a
        protocol desync and raises: an oversized chunk (e.g. a widened
        record from a newer server) surfaces StreamChunkTooLargeError
        from the read, a short one raises ValueError — never silently
        skipped, which would desynchronize the token stream."""
        while not self.finished:
            try:
                chunk = self.stream.read(max_bytes=_TOKEN_RECORD.size,
                                         timeout_ms=timeout_ms)
            except _stream.StreamClosedError:
                self.finished = True
                self.cancelled = True
                return
            if len(chunk) != _TOKEN_RECORD.size:
                self.finished = True
                raise ValueError(
                    f"request {self.request_id}: malformed token record "
                    f"({len(chunk)} bytes, expected {_TOKEN_RECORD.size})")
            rec = TokenRecord(*_TOKEN_RECORD.unpack(chunk))
            if rec.eos or rec.cancelled:
                self.finished = True
                self.cancelled = rec.cancelled
            yield rec

    def __iter__(self) -> Iterator[int]:
        """Token ids in order; raises CancelledError on a server cancel."""
        for rec in self.records():
            if rec.cancelled:
                raise CancelledError(
                    f"request {self.request_id} cancelled at token "
                    f"{rec.index}")
            yield rec.token
        if self.cancelled:
            raise CancelledError(
                f"request {self.request_id} cancelled (stream closed)")

    def close(self) -> None:
        """Client-side cancel: closes the token stream; the scheduler
        observes the close and frees the slot at its next step."""
        self.finished = True
        self.stream.destroy()

    def __enter__(self) -> "Completion":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class InferClient:
    """Submits prompts to a server running Server.enable_infer()."""

    def __init__(self, channel, tenant: str = "", priority: int = 0):
        self._channel = channel
        self._tenant = tenant
        self._priority = priority

    def submit(self, prompt_tokens, max_new_tokens: int = 0,
               publish: bool = True, timeout_ms: int = 0,
               window_bytes: int = 0) -> Completion:
        """One completion request.  max_new_tokens = 0 takes the server's
        trpc_infer_max_new_tokens default; publish=False skips the
        post-prefill publish of this prompt's uncached blocks.  Raises
        OverloadedError when the tenant is shed (2005) and
        DeadlineExpiredError past budget (2007)."""
        req = pack_submit(prompt_tokens, max_new_tokens, publish)
        st, resp = _stream.open_stream(
            self._channel, SUBMIT_METHOD, req, timeout_ms=timeout_ms,
            window_bytes=window_bytes, tenant=self._tenant,
            priority=self._priority)
        if len(resp) < _SUBMIT_REPLY.size:
            st.destroy()
            raise ValueError(
                f"short Infer.Submit reply: {len(resp)} bytes")
        request_id, cached, block = _SUBMIT_REPLY.unpack(
            resp[:_SUBMIT_REPLY.size])
        return Completion(st, request_id, cached, block)
