"""Python RPC clients — port of brpc_tpu/rpc/client.py: the single-server
Channel and the ClusterChannel, their batch pipelines (rpc/batch.py), the
typed errors and the ambient end-to-end deadline."""

from __future__ import annotations

import ctypes
import time
import weakref

from brpc_tpu_torch.rpc import batch as _batch
from brpc_tpu_torch.rpc import observe as _observe
from brpc_tpu_torch.rpc._lib import IOBuf, load_library


class RpcError(Exception):
    def __init__(self, code: int, text: str):
        super().__init__(f"rpc failed (code {code}): {text}")
        self.code = code
        self.text = text


class OverloadedError(RpcError):
    """The server shed this request via per-tenant admission control
    (cpp/net/qos.h kEOverloaded, code 2005): the node is ALIVE but over
    this tenant's bound.  Back off or route elsewhere — a ClusterChannel
    does that automatically (immediate failover to a different node +
    quarantine backoff on the shedding one)."""


class DrainingError(RpcError):
    """The server is draining gracefully (cpp/net/server.h Drain,
    kEDraining code 2006): healthy, just leaving the fleet.  A
    ClusterChannel fails over to a different node inside the same call
    WITHOUT quarantining the endpoint (its hot-restart successor revives
    there moments later); only a bare Channel surfaces this."""


class DeadlineExpiredError(RpcError):
    """The call's end-to-end budget ran out (cpp/net/deadline.h
    kEDeadlineExpired, code 2007): the request was shed before dispatch
    (server side, budget expired in flight or queued), or failed fast
    locally because the ambient budget was already exhausted.  NOT
    retriable — the budget is just as dead on every other node, and a
    ClusterChannel stops its attempt chain on it."""


def make_rpc_error(lib, code: int, text: str) -> RpcError:
    """The typed error for a failed call's status code — OverloadedError
    for an admission-control shed, DrainingError for a graceful leave,
    DeadlineExpiredError for an exhausted end-to-end budget, RpcError
    otherwise.  Shared by the sync call paths and the batch plane so
    both surface the same type."""
    if code == lib.trpc_qos_overloaded_code():
        return OverloadedError(code, text)
    if code == lib.trpc_draining_code():
        return DrainingError(code, text)
    if code == lib.trpc_deadline_expired_code():
        return DeadlineExpiredError(code, text)
    return RpcError(code, text)


class deadline_scope:
    """Ambient end-to-end budget for the CURRENT THREAD's sync calls
    (cpp/net/deadline.h): inside the scope, every call stamps
    min(timeout, remaining budget) into meta tail-group 7, so a chain of
    proxied calls decrements one budget instead of each hop restarting
    its own.  Re-entrant scopes tighten only (an inner, longer budget is
    clamped to the outer one's remainder).

        with rpc.deadline_scope(50):       # 50ms end to end
            ch.call("A.Plan", req)          # stamps <= 50ms
            ch.call("A.Execute", req2)      # stamps what's left
    """

    def __init__(self, budget_ms: float):
        self._budget_us = int(budget_ms * 1000)
        self._lib = load_library()
        self._outer = -1

    def __enter__(self) -> "deadline_scope":
        self._outer = self._lib.trpc_deadline_ambient_remaining()
        self._t0 = time.monotonic()
        budget = self._budget_us
        if 0 <= self._outer < budget:
            budget = self._outer  # inner scopes only ever tighten
        self._lib.trpc_deadline_ambient_set(max(budget, 1))
        return self

    def __exit__(self, *exc) -> None:
        if self._outer >= 0:
            # Restore the OUTER budget minus the time this scope burned:
            # a nested scope must never hand time back.
            elapsed = int((time.monotonic() - self._t0) * 1e6)
            self._lib.trpc_deadline_ambient_set(
                max(self._outer - elapsed, 1))
        else:
            self._lib.trpc_deadline_ambient_clear()

    @property
    def remaining_us(self) -> int:
        """Remaining budget right now (0 = exhausted)."""
        rem = self._lib.trpc_deadline_ambient_remaining()
        return rem if rem >= 0 else 0


class _BatchMixin:
    """Pipelined data plane shared by Channel and ClusterChannel: one GIL
    crossing submits N calls, completions drain with the GIL released
    (rpc/batch.py over cpp/capi/batch_capi.cc)."""

    _default_batch = None
    _pipelines = None

    def pipeline(self) -> "_batch.Batch":
        """A dedicated submit/poll pipeline over this channel."""
        b = _batch.Batch(self)
        self._track_pipeline(b)
        return b

    def _track_pipeline(self, b) -> None:
        # Weakly tracked so close() can settle every live pipeline before
        # the native channel dies under their issuing fibers; a pipeline
        # the caller dropped closes itself via __del__ and falls out.
        if self._pipelines is None:
            self._pipelines = weakref.WeakSet()
        self._pipelines.add(b)

    def _batch_default(self) -> "_batch.Batch":
        if self._default_batch is None:
            self._default_batch = _batch.Batch(self)
            self._track_pipeline(self._default_batch)
        return self._default_batch

    def submit(self, method: str, requests, resp_bufs=None,
               timeout_ms: int = 0) -> list[int]:
        """Async pipelined issue: submits the requests (buffer-protocol
        objects or tensors, by reference) on this channel's default
        pipeline and returns their tokens immediately; pair with poll()."""
        return self._batch_default().submit(
            method, requests, resp_bufs=resp_bufs, timeout_ms=timeout_ms)

    def poll(self, max_n: int = 64, timeout_ms: int = -1):
        """Drains completions from the default pipeline (GIL released
        while waiting); see batch.Batch.poll."""
        return self._batch_default().poll(max_n=max_n, timeout_ms=timeout_ms)

    def cancel(self, token: int) -> bool:
        """Cancels one in-flight submitted call by token."""
        return self._batch_default().cancel(token)

    def call_batch(self, method: str, requests, resp_bufs=None,
                   timeout_ms: int = 0) -> list:
        """Synchronous batched call over a fresh pipeline: all requests
        issue concurrently (one crossing in, one poll loop out), results
        return ALIGNED with requests, failed members as RpcError
        instances (error isolation — one failure never poisons the
        rest)."""
        return _batch.call_batch(self, method, requests,
                                 resp_bufs=resp_bufs, timeout_ms=timeout_ms)

    def _close_default_batch(self) -> None:
        b, self._default_batch = self._default_batch, None
        if b is not None:
            b.close()
        # Explicit pipelines with members in flight would be left calling
        # into a freed channel: quiesce each (cancel + settle).  Their
        # buffered completions stay drainable; only close() frees them.
        for p in list(self._pipelines or ()):
            p.quiesce()


def _call(lib, fn, ptr, method: str, request: bytes, extra,
          latency=None) -> bytes:
    resp = IOBuf()
    err = ctypes.create_string_buffer(256)
    t0 = time.perf_counter()
    rc = fn(ptr, method.encode(), request, len(request), resp._ptr, extra,
            err, 256)
    if latency is not None:
        # Client-side view of the same call the server's per-method
        # recorder times: includes queueing, wire, and (on errors) the
        # full timeout wait — the gap between the two IS the network.
        latency.record(int((time.perf_counter() - t0) * 1e6))
    if rc != 0:
        raise make_rpc_error(lib, rc, err.value.decode(errors="replace"))
    return resp.to_bytes()


class Channel(_BatchMixin):
    """Client stub for one server (parity: cpp/net/channel.h).

    use_shm routes same-host calls over shared-memory rings (TCP-handshaked;
    transparent TCP fallback)."""

    def __init__(self, addr: str, timeout_ms: int = 1000,
                 use_shm: bool = False, connection_type: str = "single",
                 qos_tenant: str = "", qos_priority: int = 0):
        self._lib = load_library()
        self._ptr = self._lib.trpc_channel_create_ex(
            addr.encode(), timeout_ms, connection_type.encode(),
            1 if use_shm else 0)
        if not self._ptr:
            raise ValueError(
                f"bad address or options: {addr!r} / {connection_type!r}")
        if qos_tenant or qos_priority:
            self.set_qos(qos_tenant, qos_priority)
        # Client-side latency recorder in the shared var registry: shows
        # in /vars + /brpc_metrics next to the server's rpc_server_*
        # series.  unique_var_name: a second channel to the same address
        # gets rpc_client_<addr>#2 instead of shadowing this recorder.
        self.latency = _observe.Latency(
            _observe.unique_var_name(f"rpc_client_{addr}"),
            f"client-side latency of sync calls on channel {addr}")

    def set_qos(self, tenant: str, priority: int = 0) -> None:
        """Default QoS tag for subsequent calls on this channel: `tenant`
        bills the server's per-tenant admission control (cpp/net/qos.h),
        `priority` picks the dispatch lane (0 = highest).  A shed request
        raises OverloadedError."""
        self._lib.trpc_channel_set_qos(self._ptr, tenant.encode(),
                                       int(priority))

    def call(self, method: str, request: bytes, timeout_ms: int = 0) -> bytes:
        return _call(self._lib, self._lib.trpc_channel_call, self._ptr,
                     method, request, timeout_ms, latency=self.latency)

    @property
    def transport(self) -> str:
        """Live transport name ("tcp", "shm_ring"); "" before first call."""
        out = ctypes.create_string_buffer(32)
        self._lib.trpc_channel_transport(self._ptr, out, 32)
        return out.value.decode()

    def close(self) -> None:
        # The default pipeline settles first: destroying the channel with
        # batch members in flight would pull the socket out from under
        # them.  Buffered completions on explicit pipelines stay
        # drainable after this returns.
        self._close_default_batch()
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_channel_destroy(ptr)
        self.latency.close()


class ClusterChannel(_BatchMixin):
    """Client over a named cluster with LB + retry + circuit breaking +
    hedging (parity: cpp/net/cluster.h).  naming_url: list://h:p,... or
    file://path; lb: rr | random | c_hash | wrr | p2c | la.

    backup_request_ms > 0 arms hedging: if the primary attempt hasn't
    answered within that budget a backup races it on another node and the
    first success wins.  health_check_method probes quarantined nodes every
    refresh tick and revives any that answer ('' disables probing);
    refresh_interval_ms is the re-resolve/probe cadence."""

    def __init__(self, naming_url: str, lb: str = "rr",
                 timeout_ms: int = 1000, max_retry: int = 2,
                 backup_request_ms: int = 0,
                 health_check_method: str | None = None,
                 health_check_timeout_ms: int = 0,
                 refresh_interval_ms: int = 0,
                 qos_tenant: str = "", qos_priority: int = 0):
        self._lib = load_library()
        self._ptr = self._lib.trpc_cluster_create_ex(
            naming_url.encode(), lb.encode(), timeout_ms, max_retry,
            backup_request_ms,
            None if health_check_method is None
            else health_check_method.encode(),
            health_check_timeout_ms, refresh_interval_ms)
        if not self._ptr:
            raise ValueError(f"cluster init failed: {naming_url!r}")
        if qos_tenant or qos_priority:
            self.set_qos(qos_tenant, qos_priority)
        self.latency = _observe.Latency(
            _observe.unique_var_name(f"rpc_client_{naming_url}"),
            f"client-side latency of sync calls on cluster {naming_url} "
            "(includes retries and hedges)")

    def set_qos(self, tenant: str, priority: int = 0) -> None:
        """Default QoS tag for every member channel's subsequent calls
        (cpp/net/qos.h).  A node shedding this tenant (OverloadedError
        code) fails over to a different node inside the same call."""
        self._lib.trpc_cluster_set_qos(self._ptr, tenant.encode(),
                                       int(priority))

    def call(self, method: str, request: bytes, hash_key: int = 0,
             hint: str = "") -> bytes:
        """One cluster call.  `hint` ("host:port") names the preferred
        member — the node holding the longest cached KV prefix — and is
        honored by the c_hash_bl walk unless bounded load vetoes it
        (cpp/net/lb_hint.h).  Advisory only: an unknown or overloaded
        hint falls back to the plain ring walk."""
        if not hint:
            return _call(self._lib, self._lib.trpc_cluster_call, self._ptr,
                         method, request, hash_key, latency=self.latency)
        resp = IOBuf()
        err = ctypes.create_string_buffer(256)
        t0 = time.perf_counter()
        rc = self._lib.trpc_cluster_call_hinted(
            self._ptr, method.encode(), request, len(request), resp._ptr,
            hash_key, hint.encode(), err, 256)
        self.latency.record(int((time.perf_counter() - t0) * 1e6))
        if rc != 0:
            raise make_rpc_error(self._lib, rc,
                                 err.value.decode(errors="replace"))
        return resp.to_bytes()

    def close(self) -> None:
        self._close_default_batch()
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_cluster_destroy(ptr)
        self.latency.close()


def lb_hint_counters() -> tuple[int, int, int]:
    """(hit, veto, miss) cache-aware routing outcomes since process
    start: hit = hinted member selected, veto = bounded load overrode
    the hint (the ring walk took over), miss = hinted member absent or
    unhealthy (cpp/net/lb_hint.h)."""
    lib = load_library()
    hit = ctypes.c_uint64()
    veto = ctypes.c_uint64()
    miss = ctypes.c_uint64()
    lib.trpc_lb_hint_counters(ctypes.byref(hit), ctypes.byref(veto),
                              ctypes.byref(miss))
    return hit.value, veto.value, miss.value
