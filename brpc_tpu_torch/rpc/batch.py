"""Pipelined zero-copy batch pipeline — port of brpc_tpu/rpc/batch.py:
submit N calls in one crossing, poll completions with the GIL released.

`submit` hands the native runtime (cpp/capi/batch_capi.cc) N requests by
reference and returns immediately; an issuing fiber replays them as
concurrent async calls; `poll` drains a lock-light completion ring while the
calling pthread sleeps OUTSIDE the GIL, so Python handler servers,
background threads and the submitting thread all make progress during a
deep poll.

Ownership rules (the zero-copy contract):

- Request buffers are pinned by this module until the native side drops
  its last IOBuf reference (a deleter callback, exactly like
  `zerocopy.append_torch`) — NOT merely until the completion is polled,
  because a timed-out call's bytes may still sit in a socket write queue.
- Response bytes either land in a caller-provided writable buffer (one
  native memcpy on the completion fiber, pool blocks recycled
  immediately) or ride out as a `ZeroCopyResponse` view over the pool
  blocks themselves; `release()` (or GC) recycles them.  No intermediate
  `bytes` object is created at the boundary on either path.

Tensors at the boundary:

- A request may be any buffer-protocol object, or a tensor.  A CPU tensor
  enters by reference with zero copies (its own memory, pointer-identical).
  A CUDA tensor takes exactly one D2H copy into pinned host memory,
  synchronised on its stream before the native submit sees the pointer —
  one copy per distinct tensor in a submit, however many entries name it
  (`[payload] * k` pins the same host copy k times, each entry with its own
  deleter ctx).  The pinned copy comes from torch's caching host
  allocator, so windows of the same size reuse its blocks; its last
  reference drops in the deleter.
- A `resp_bufs` entry may be a writable buffer, a contiguous CPU tensor
  (pinned when the caller's data lives on a GPU, so the landed bytes go
  back with one H2D DMA) or an `rma.RmaBuffer`.
- `ZeroCopyResponse.tensor()` is a uint8 CPU tensor over the response; it
  keeps the response alive as `view()` does.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from brpc_tpu_torch.rpc import zerocopy as _zc
from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.rma import RmaBuffer


def pinned_requests() -> int:
    """Number of buffers currently pinned by in-flight sends (shared
    registry with zerocopy.live_sends — one registry, one deleter)."""
    return _zc.live_sends()


class BatchCompletion(ctypes.Structure):
    """ABI mirror of `struct trpc_batch_completion` (batch_capi.cc)."""

    _fields_ = [
        ("token", ctypes.c_uint64),
        ("status", ctypes.c_int32),
        ("resp_copied", ctypes.c_uint32),
        ("resp_len", ctypes.c_uint64),
        ("resp_iobuf", ctypes.c_void_p),
        ("err", ctypes.c_char * 120),
    ]


class ZeroCopyResponse:
    """Response bytes viewed IN PLACE from the runtime's pool blocks.

    `view()` is a zero-copy memoryview when the response is physically
    contiguous (single block — the common case for pool-block responses);
    otherwise it materializes once.  `tensor()` is the same bytes as a
    uint8 CPU tensor.  `release()` (or GC) hands the blocks back to the
    pool; views must not outlive it."""

    def __init__(self, lib, iobuf_ptr: int, nbytes: int):
        self._lib = lib
        self._ptr = iobuf_ptr
        self.nbytes = nbytes

    def _block(self):
        """A ctypes array over the single block, or None when the response
        spans several.  The array pins this response (cbuf._owner), so
        dropping every other reference cannot recycle the pool block under
        a live view; an EXPLICIT release() while views exist is still the
        caller's contract to honor."""
        lib = self._lib
        if not self._ptr:
            raise ValueError("response already released")
        if lib.trpc_iobuf_block_count(self._ptr) != 1:
            return None
        base = lib.trpc_iobuf_block_ptr(self._ptr, 0)
        cbuf = (ctypes.c_char * self.nbytes).from_address(base)
        cbuf._owner = self
        return cbuf

    def view(self) -> memoryview:
        cbuf = self._block()
        if cbuf is not None:
            return memoryview(cbuf).cast("B")
        return memoryview(self.tobytes())

    def tensor(self) -> torch.Tensor:
        """Flat uint8 CPU tensor over the response: zero-copy over a single
        block (the tensor keeps the response alive), one copy otherwise."""
        if self.nbytes == 0:
            return torch.empty(0, dtype=torch.uint8)
        cbuf = self._block()
        if cbuf is None:
            cbuf = bytearray(self.tobytes())
        return torch.frombuffer(cbuf, dtype=torch.uint8)

    def tobytes(self) -> bytes:
        if not self._ptr:
            raise ValueError("response already released")
        out = ctypes.create_string_buffer(self.nbytes)
        got = self._lib.trpc_iobuf_copy_to(self._ptr, out, self.nbytes, 0)
        return out.raw[:got]

    def release(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_iobuf_destroy(ptr)

    def __len__(self) -> int:
        return self.nbytes

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class Completion:
    """One finished call: `token`, `ok`, `status`/`error`, and the
    response — `data` is None when it landed in the caller's buffer
    (`resp_len` bytes written there), a `ZeroCopyResponse` otherwise."""

    __slots__ = ("token", "status", "error", "resp_len", "in_caller_buffer",
                 "data")

    def __init__(self, token, status, error, resp_len, in_caller_buffer,
                 data):
        self.token = token
        self.status = status
        self.error = error
        self.resp_len = resp_len
        self.in_caller_buffer = in_caller_buffer
        self.data = data

    @property
    def ok(self) -> bool:
        return self.status == 0

    def tobytes(self) -> bytes:
        """Materializes the response (b'' for empty / caller-buffer)."""
        if isinstance(self.data, ZeroCopyResponse):
            return self.data.tobytes()
        return b""

    def __repr__(self):
        state = "ok" if self.ok else f"err {self.status}: {self.error!r}"
        return f"<Completion token={self.token} {state} len={self.resp_len}>"


def _request_bytes(r, staged: dict):
    """(flat uint8 ndarray, owner) for one request entry: a view of a
    buffer or CPU tensor's own memory, or the pinned host copy of a CUDA
    tensor — made once per distinct tensor of the submit (`staged`)."""
    if not isinstance(r, torch.Tensor):
        return np.frombuffer(r, dtype=np.uint8), r
    if r.device.type != "cuda":
        return _zc.host_view(r)
    hit = staged.get(id(r))
    if hit is None:
        hit = staged[id(r)] = _zc.host_view(r)
    return hit


def _landing_bytes(buf) -> np.ndarray:
    """Flat writable uint8 ndarray over one resp_bufs entry (no copy)."""
    if isinstance(buf, RmaBuffer):
        buf = buf.view
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("resp_bufs tensors must be contiguous CPU "
                             "tensors (pinned for a GPU caller)")
        return buf.reshape(-1).view(torch.uint8).numpy()
    v = np.frombuffer(buf, dtype=np.uint8)
    if not v.flags.writeable:
        raise ValueError("resp_bufs entries must be writable")
    return v


class Batch:
    """A submission pipeline over one Channel/ClusterChannel.

    submit() is one GIL crossing for N calls and returns their tokens
    without blocking on the network; poll() drains completions (GIL
    released while waiting).  Completions are correlation-matched by
    token, not ordered: issue order IS wire order on a single-connection
    channel, but responses complete as the server finishes them.

    The batch holds a reference to its channel; buffered completions
    remain drainable after `channel.close()` as long as nothing was in
    flight at close time."""

    def __init__(self, channel, is_cluster: bool | None = None):
        self._lib = load_library()
        if is_cluster is None:
            from brpc_tpu_torch.rpc.client import ClusterChannel

            is_cluster = isinstance(channel, ClusterChannel)
        self._channel = channel  # keeps the native channel alive
        self._ptr = self._lib.trpc_batch_create(channel._ptr,
                                                1 if is_cluster else 0)
        if not self._ptr:
            raise ValueError("batch over a closed channel")
        self._resp_pins: dict[int, object] = {}
        # Serializes submit/cancel/introspection against close, and
        # counts pollers so close can wait for them to drain out of the
        # native poll before destroying the handle.
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._active_polls = 0

    def submit(self, method: str, requests, resp_bufs=None,
               timeout_ms: int = 0) -> list[int]:
        """Submits len(requests) calls in ONE crossing; returns tokens in
        request order.  Each request is a buffer-protocol object (bytes,
        numpy, memoryview) or a tensor; its bytes enter the wire path by
        reference and stay pinned until the runtime drops them.  resp_bufs
        (optional, per-call, entries may be None) are WRITABLE landing
        buffers — buffers, CPU tensors or RmaBuffers — the responses land
        in natively; they must stay alive until their completion is
        polled."""
        if not self._ptr:
            raise ValueError("batch is closed")
        n = len(requests)
        if n == 0:
            return []
        # Validate and stage the response buffers BEFORE any request is
        # pinned: a raise past the pin loop would strand entries in the
        # pin registry forever (the native deleter only fires for
        # submitted calls).
        rb = rc = None
        resp_views = []
        if resp_bufs is not None:
            if len(resp_bufs) != n:
                raise ValueError("resp_bufs length must match requests")
            rb = (ctypes.c_void_p * n)()
            rc = (ctypes.c_size_t * n)()
            for i, buf in enumerate(resp_bufs):
                if buf is None:
                    continue
                v = _landing_bytes(buf)
                rb[i] = v.ctypes.data
                rc[i] = v.nbytes
                resp_views.append((v, buf))
        req_ptrs = (ctypes.c_void_p * n)()
        req_lens = (ctypes.c_size_t * n)()
        pin_ctxs = (ctypes.c_void_p * n)()
        tokens = (ctypes.c_uint64 * n)()
        pins = []
        staged: dict[int, tuple] = {}
        try:
            for i, r in enumerate(requests):
                flat, owner = _request_bytes(r, staged)
                if flat.nbytes == 0:
                    continue
                req_ptrs[i] = flat.ctypes.data
                req_lens[i] = flat.nbytes
                tok = _zc.pin(flat, owner, r)
                pin_ctxs[i] = tok
                pins.append(tok)
        except Exception:
            for tok in pins:  # a bad request mid-loop must not leak pins
                _zc.unpin(tok)
            raise
        # self._lock is held across the native submit AND the pin
        # insertion: tokens are only known once submit returns, and a
        # concurrent poller that drained a completion in that window
        # would pop a pin that isn't registered yet (leaking it for the
        # batch's lifetime).  poll() pops under the same lock, so it
        # blocks those few microseconds until the pins are in place.
        with self._lock:
            if not self._ptr:
                for tok in pins:
                    _zc.unpin(tok)
                raise ValueError("batch is closed")
            got = self._lib.trpc_batch_submit(
                self._ptr, method.encode(), req_ptrs, req_lens, rb, rc, n,
                timeout_ms, ctypes.cast(_zc.release_cb, ctypes.c_void_p),
                pin_ctxs, tokens)
            if got != n:
                for tok in pins:  # nothing was issued; undo the pins
                    _zc.unpin(tok)
                raise RuntimeError("batch rejected the submit (closing?)")
            out = list(tokens)
            landed = (t for i, t in enumerate(out)
                      if resp_bufs is not None and resp_bufs[i] is not None)
            for t, pin in zip(landed, resp_views):
                self._resp_pins[t] = pin
        return out

    def poll(self, max_n: int = 64, timeout_ms: int = -1) -> list[Completion]:
        """Drains up to max_n completions, blocking OUTSIDE the GIL until
        at least one is ready or timeout_ms passes (0 = non-blocking,
        < 0 = wait forever).  Returns [] on timeout, and early (with
        whatever is buffered) once the batch is closing."""
        arr = (BatchCompletion * max_n)()
        with self._lock:
            if not self._ptr:
                raise ValueError("batch is closed")
            ptr = self._ptr
            self._active_polls += 1
        try:
            # The native handle stays valid for the whole call: close()
            # quiesces (which wakes parked pollers out of the wait) and
            # only destroys after _active_polls drains to zero.
            got = self._lib.trpc_batch_poll(ptr, arr, max_n, timeout_ms)
        finally:
            with self._lock:
                self._active_polls -= 1
                self._cond.notify_all()
        out = []
        if got:
            with self._lock:  # one locked pass, not one lock per record
                for i in range(got):
                    self._resp_pins.pop(arr[i].token, None)
        for i in range(got):
            c = arr[i]
            data = None
            if c.resp_iobuf:
                data = ZeroCopyResponse(self._lib, c.resp_iobuf, c.resp_len)
            out.append(Completion(
                token=c.token, status=c.status,
                error=c.err.decode(errors="replace") if c.status else "",
                resp_len=c.resp_len,
                in_caller_buffer=bool(c.resp_copied), data=data))
        return out

    def cancel(self, token: int) -> bool:
        """Best-effort cancel of one member: an in-flight call completes
        with ECANCELED via the runtime's StartCancel; a call that already
        completed (or was polled) is untouched.  True when the token was
        still live."""
        with self._lock:  # the native call is quick and must not race
            if not self._ptr:  # a concurrent destroy
                return False
            return self._lib.trpc_batch_cancel(self._ptr, token) == 0

    @property
    def outstanding(self) -> int:
        """Calls submitted but not yet drained by poll()."""
        with self._lock:
            if not self._ptr:
                return 0
            return self._lib.trpc_batch_outstanding(self._ptr)

    @property
    def inflight(self) -> int:
        """Calls still in flight (not yet completed into the ring).
        Zero means the batch no longer needs its channel: everything has
        settled, and only buffered completions remain to drain."""
        with self._lock:
            if not self._ptr:
                return 0
            return self._lib.trpc_batch_inflight(self._ptr)

    def quiesce(self) -> None:
        """Rejects further submits, cancels in-flight members and waits
        for them to settle; buffered completions remain pollable.  After
        this the batch no longer touches its channel (Channel.close runs
        it on every live pipeline before destroying the native channel)."""
        with self._lock:  # held across the call so a concurrent close
            if self._ptr:  # cannot destroy the handle mid-quiesce
                self._lib.trpc_batch_quiesce(self._ptr)

    def close(self) -> None:
        """Cancels in-flight members, waits for them (and any poller on
        another thread) to settle, frees unpolled completions."""
        with self._lock:
            ptr, self._ptr = self._ptr, None
        if ptr:
            # Quiesce wakes parked pollers; they observe the closed state
            # and drain out.  Destroy only once none is inside the native
            # poll — the handle dies with nobody touching it.
            self._lib.trpc_batch_quiesce(ptr)
            with self._lock:
                while self._active_polls > 0:
                    self._cond.wait(timeout=1.0)
            self._lib.trpc_batch_destroy(ptr)
        with self._lock:
            # Only after quiesce settled the in-flight members: a pin is
            # what keeps a caller-dropped landing buffer alive, and an
            # in-flight completion memcpys into it natively.
            self._resp_pins.clear()
        self._channel = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def call_batch(channel, method: str, requests, resp_bufs=None,
               timeout_ms: int = 0):
    """Synchronous batched call: submits all requests in one crossing,
    waits for every completion, returns results ALIGNED with `requests`.
    Per-call error isolation: a failed member yields an `RpcError`
    INSTANCE at its position (not raised), everything else completes
    normally.  Success entries are `bytes` (or None when the response
    landed in the matching resp_bufs entry).  Runs on its own private
    pipeline — a shared one could hand it completions belonging to other
    submitters."""
    from brpc_tpu_torch.rpc.client import make_rpc_error

    b = Batch(channel)
    track = getattr(channel, "_track_pipeline", None)
    if track is not None:
        track(b)  # channel.close() on another thread settles us first
    try:
        tokens = b.submit(method, requests, resp_bufs=resp_bufs,
                          timeout_ms=timeout_ms)
        want = set(tokens)
        by_token: dict[int, object] = {}
        while want:
            for c in b.poll(max_n=len(want), timeout_ms=-1):
                want.discard(c.token)
                if not c.ok:
                    by_token[c.token] = make_rpc_error(
                        channel._lib, c.status, c.error)
                elif c.in_caller_buffer:
                    by_token[c.token] = None
                elif c.data is not None:
                    by_token[c.token] = c.data.tobytes()
                    c.data.release()
                else:
                    by_token[c.token] = b""
        return [by_token[t] for t in tokens]
    finally:
        b.close()
