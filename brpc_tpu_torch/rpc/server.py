"""Python-facing RPC server over the native runtime — port of
brpc_tpu/rpc/server.py.

Handlers run on fiber worker threads (ctypes re-acquires the GIL); they may
respond inline or keep the call handle and respond later (async), mirroring
the done-closure contract of the C++ `Server` (cpp/net/server.h).  The KV,
naming and collective attachments are native one-liners; the Python
clients that talk to them (the reference's kv, naming and collective
modules) are not ported yet.
"""

from __future__ import annotations

import ctypes
import json
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

    def __init__(self, lib, handle: int, tenant: str = "",
                 priority: int = 0):
        self._lib = lib
        self._handle = handle
        #: QoS tag of this request (cpp/net/qos.h): the tenant it bills
        #: and its dispatch-lane priority (0 = highest).  Empty/0 on
        #: untagged traffic.
        self.tenant = tenant
        self.priority = priority

    def respond(self, data: bytes = b"", error_code: int = 0,
                error_text: str = "") -> bool:
        """Returns True if this respond completed the call (False if it was
        already completed elsewhere)."""
        rc = self._lib.trpc_call_respond(
            self._handle, data, len(data), error_code, error_text.encode()
        )
        return rc == 0

    @property
    def remaining_us(self) -> int:
        """Remaining end-to-end budget of this request in µs
        (cpp/net/deadline.h): the caller's wire-propagated deadline minus
        elapsed time since arrival.  A very large value (INT64 max) when
        the caller set none, 0 when already past.  Only valid BEFORE
        respond() — the handle dies with the call."""
        return self._lib.trpc_call_remaining_us(self._handle)

    @property
    def cancelled(self) -> bool:
        """True when the caller cancelled this request (kCancel control
        frame) or its connection died — abandon work nobody will
        receive.  Only valid BEFORE respond()."""
        return bool(self._lib.trpc_call_cancelled(self._handle))

    def accept_stream(self, window_bytes: int = 0):
        """Accepts the stream the request OFFERED (stream.open_stream
        client-side) and returns an established stream.Stream.  MUST be
        called before respond() — acceptance rides the response wire.
        Returns None when the request offered no stream.  window_bytes
        = 0 keeps the flag default credit window."""
        from brpc_tpu_torch.rpc import stream as _stream
        handle = self._lib.trpc_call_stream_accept(self._handle,
                                                   window_bytes)
        if not handle:
            return None
        return _stream.Stream(self._lib, handle)


class Server:
    def __init__(self):
        self._lib = load_library()
        self._ptr = self._lib.trpc_server_create()
        self._keepalive = []  # ctypes callbacks must outlive the server
        self._infer = None  # InferScheduler handle (enable_infer)

    def register(self, method: str, fn: Callable[[Call, bytes], None]) -> None:
        """fn(call, request_bytes) — call call.respond(...) when done."""
        lib = self._lib

        def thunk(handle, req_ptr, req_len, _ctx):
            # QoS tag fetched EAGERLY: the handle dies at respond(), and a
            # lazy property read after an async respond would be a
            # use-after-free.
            tbuf = ctypes.create_string_buffer(80)
            prio = lib.trpc_call_qos(handle, tbuf, 80)
            call = Call(lib, handle, tbuf.value.decode(errors="replace"),
                        prio)
            try:
                data = ctypes.string_at(req_ptr, req_len)
                fn(call, data)
            except BaseException as e:  # noqa: BLE001 - never leak the call
                # BaseException, not Exception: nothing can be raised out
                # of a ctypes callback, so a handler raising SystemExit,
                # KeyboardInterrupt or its own BaseException subclass must
                # still answer, or the caller waits out its whole timeout.
                try:
                    call.respond(error_code=13, error_text=repr(e))
                except BaseException:  # noqa: BLE001
                    pass  # respond is idempotent; worst case client times out

        cb = _HANDLER_CFUNC(thunk)
        self._keepalive.append(cb)
        if self._lib.trpc_server_register(self._ptr, method.encode(), cb, None) != 0:
            raise RuntimeError(f"register {method!r} failed (server running?)")

    def register_native_echo(self, method: str = "Echo.Echo") -> None:
        """Registers a NATIVE zero-copy echo handler for `method` — the
        request blocks are ref-shared into the response with no Python
        callback and no GIL.  The server-side anchor for data-plane
        benchmarks: a Python handler would measure the server's GIL, not
        the client pipeline."""
        if self._lib.trpc_server_register_echo(
                self._ptr, method.encode()) != 0:
            raise RuntimeError(
                f"register_native_echo {method!r} failed (server running?)")

    def enable_kv_store(self) -> None:
        """Attaches the NATIVE KV block-store fetch handler (Kv.Fetch,
        cpp/net/kvstore.h): blocks published from this process (kv.publish)
        are served zero-copy out of their registered pages with no Python
        callback and no GIL — the prefill side of the disaggregation
        workload.  Call before start."""
        if self._lib.trpc_server_enable_kv_store(self._ptr) != 0:
            raise RuntimeError("enable_kv_store failed (server running?)")

    def enable_kv_registry(self) -> None:
        """Attaches the NATIVE KV-block registry handlers
        (KvReg.Register/Lookup/Evict/Renew, cpp/net/kvstore.h): this
        server becomes a block directory mapping block_id -> {node, rkey,
        offset, len, generation} under lease-based ownership.  Call
        before start."""
        if self._lib.trpc_server_enable_kv_registry(self._ptr) != 0:
            raise RuntimeError("enable_kv_registry failed (server running?)")

    def enable_collective(self) -> None:
        """Attaches the NATIVE collective handlers (Coll.Put/Abort,
        Reshard.Plan/Execute, cpp/net/collective.h): this server can
        receive group put schedules — chunks land one-sided through the
        RMA plane and wake the local member's step countdown — and
        serve the resharding service (Plan is stateless; Execute moves
        KV-block-addressed shards).  Call before start."""
        if self._lib.trpc_server_enable_collective(self._ptr) != 0:
            raise RuntimeError("enable_collective failed (server running?)")

    def enable_tuner(self) -> None:
        """Attaches the self-tuning controller (cpp/stat/tuner.h):
        registers the trpc_tuner* flags/vars and flips `trpc_tuner` on
        through the validated reload path.  The controller is
        process-wide (it actuates process-wide flags); disable with
        rpc.tuner.enable_tuner(False).  Callable before or after
        start."""
        if self._lib.trpc_server_enable_tuner(self._ptr) != 0:
            raise RuntimeError("enable_tuner failed")

    def enable_infer(self, prefix_cache: bool = True,
                     kv_fetch_addr: str = "", node: str = "") -> None:
        """Attaches the streamed-inference front door (cpp/net/infer.h):
        registers Infer.Submit and starts the continuous-batching decode
        loop — requests join/leave the running batch every step, tokens
        push down per-request logical streams (infer.InferClient).
        prefix_cache wires the process kv_store()/kv_registry()
        singletons so matched prompt blocks skip recompute (composes
        with enable_kv_store/enable_kv_registry); kv_fetch_addr pulls
        matched blocks over Kv.FetchPrefix from that node instead
        (prefill/decode disaggregation).  Call before start; the
        scheduler stops automatically on close()."""
        sched = self._lib.trpc_server_enable_infer(
            self._ptr, 1 if prefix_cache else 0, kv_fetch_addr.encode(),
            node.encode())
        if not sched:
            raise RuntimeError("enable_infer failed (server running?)")
        self._infer = sched

    def infer_dump(self) -> dict:
        """The inference scheduler's live stats (the bench/orchestrator
        read): active/waiting/streams_live/streams_peak, admission and
        token counters, prefill cache bytes, and ttft/tpot percentile
        blocks.  Raises without enable_infer()."""
        if self._infer is None:
            raise RuntimeError("enable_infer() was not called")
        size = 1 << 12
        while True:
            out = ctypes.create_string_buffer(size)
            need = self._lib.trpc_infer_dump(self._infer, out, size)
            if need < size:
                return json.loads(out.raw[:need].decode())
            size = need + 1

    def infer_streams_live(self) -> int:
        if self._infer is None:
            return 0
        return int(self._lib.trpc_infer_streams_live(self._infer))

    def infer_streams_peak(self) -> int:
        if self._infer is None:
            return 0
        return int(self._lib.trpc_infer_streams_peak(self._infer))

    def enable_naming_registry(self) -> None:
        """Attaches the NATIVE naming-registry handlers
        (Naming.Announce/Withdraw/Resolve/Watch, cpp/net/naming.h): this
        server becomes a membership directory — nodes announce {addr,
        zone, weight, epoch} under leases, clients watch for push-based
        deltas.  Call before start."""
        if self._lib.trpc_server_enable_naming(self._ptr) != 0:
            raise RuntimeError("enable_naming_registry failed "
                               "(server running?)")

    def announce(self, registry_addr: str, service: str, zone: str = "",
                 weight: int = 1) -> None:
        """Announces this RUNNING server's address into `service` at the
        registry and keeps the lease renewed from a native fiber.  The
        announcement withdraws automatically on drain() (FIRST, so
        watchers re-balance before in-flight work finishes) and on
        close."""
        rc = self._lib.trpc_server_announce(
            self._ptr, registry_addr.encode(), service.encode(),
            zone.encode(), int(weight))
        if rc != 0:
            raise RuntimeError(
                f"announce to {registry_addr!r} failed (server not "
                "started, or registry unreachable)")

    def drain(self, deadline_ms: int = 0, handoff_path: str = "") -> bool:
        """Graceful drain (cpp/net/server.h Drain): new requests answer
        the draining status (DrainingError on a bare Channel; silent
        failover on a ClusterChannel), drain hooks withdraw this node's
        naming announcements and tombstone its KV blocks, and — with
        handoff_path — the SO_REUSEPORT listener set is served to a
        successor process (start_from_handoff) before our own fds close,
        so no connection is ever refused.  Then waits out in-flight
        requests and RMA window spans.  deadline_ms <= 0 uses the
        trpc_drain_deadline_ms flag.  Returns True when fully quiesced,
        False when the deadline cut the wait short."""
        return self._lib.trpc_server_drain(
            self._ptr, int(deadline_ms), handoff_path.encode()) == 0

    def start_from_handoff(self, handoff_path: str,
                           timeout_ms: int = 10000) -> int:
        """Hot-restart successor entry point: adopts the draining
        predecessor's listener fds from its handoff socket (retrying
        until the predecessor serves them) and starts THIS server on
        them — same port, shared accept queues, fresh process (and
        fresh RMA rkeys).  Register methods first, like start()."""
        if self._lib.trpc_server_start_handoff(
                self._ptr, handoff_path.encode(), int(timeout_ms)) != 0:
            raise RuntimeError(
                f"listener handoff from {handoff_path!r} failed")
        return self.port

    @property
    def draining(self) -> bool:
        return bool(self._lib.trpc_server_draining(self._ptr))

    def set_qos(self, spec: str) -> None:
        """Per-tenant QoS admission control (cpp/net/qos.h grammar):
        ';'-separated `tenant:weight=N,limit=<spec>` clauses, tenant '*'
        as the default.  Shed requests answer the overloaded status
        (OverloadedError client-side).  '' removes.  Call before start;
        raises on a malformed spec."""
        if self._lib.trpc_server_set_qos(self._ptr, spec.encode()) != 0:
            raise ValueError(f"bad qos spec (or server running): {spec!r}")

    def set_slo(self, spec: str) -> None:
        """Per-tenant SLO targets (cpp/stat/slo.h grammar): ';'-separated
        `tenant:p99_us=N,avail=PCT` clauses, tenant '*' as the default —
        e.g. "tenantA:p99_us=2000,avail=99.9;*:p99_us=10000".  Needs the
        reloadable `trpc_slo` flag on (observe.enable_slo) to record;
        exposes slo_tenant_* vars, the /slo builtin, and — with
        trpc_fleet_publish — this node's digest blob over naming://.
        '' removes.  Call before start; raises on a malformed spec."""
        if self._lib.trpc_server_set_slo(self._ptr, spec.encode()) != 0:
            raise ValueError(f"bad slo spec (or server running): {spec!r}")

    def slo_dump(self) -> dict:
        """This server's per-tenant SLO attainment/burn-rate view (the
        /slo builtin body): {"enabled", "tenants": [{tenant, targets,
        window counters, burn_fast/burn_slow, attainment, breached}]}."""
        size = 1 << 14
        while True:
            out = ctypes.create_string_buffer(size)
            need = self._lib.trpc_slo_dump(self._ptr, out, size)
            if need < size:
                return json.loads(out.raw[:need].decode())
            size = need + 1

    def fleet_blob(self) -> bytes:
        """This node's fleet publication blob (digest-wire 2 — the exact
        bytes the Announcer publishes; observe.fleet_blob_decode reads
        it).  b'' without an SLO engine."""
        size = 1 << 14
        while True:
            out = ctypes.create_string_buffer(size)
            need = self._lib.trpc_fleet_blob(self._ptr, out, size)
            if need < size:
                return out.raw[:need]
            size = need + 1

    def set_reuseport_shards(self, shards: int) -> None:
        """Shards the TCP acceptor across `shards` SO_REUSEPORT listeners
        (each on its own event-dispatcher slot — see the
        trpc_event_dispatchers flag).  Call before start."""
        if self._lib.trpc_server_set_reuseport(self._ptr, shards) != 0:
            raise ValueError(
                f"bad shard count (or server running): {shards}")

    def accept_counts(self) -> list:
        """Connections accepted per REUSEPORT shard (scale telemetry)."""
        out = (ctypes.c_uint64 * 16)()
        n = self._lib.trpc_server_accept_counts(self._ptr, out, 16)
        return [int(out[i]) for i in range(n)]

    def set_faults(self, spec: str) -> None:
        """Server-side fault injection (cpp/net/fault.h svr_* fields):
        svr_delay=P:MS delays dispatch, svr_error=P:CODE answers with an
        injected error, svr_reject=P closes fresh connections.  ''
        disables.  Callable at runtime; raises on a malformed spec."""
        if self._lib.trpc_server_fault_set(self._ptr, spec.encode()) != 0:
            raise ValueError(f"bad server fault schedule: {spec!r}")

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
        # The inference scheduler must stop BEFORE the server dies: its
        # loop fiber cancels/closes every live token stream on the way
        # out, and those streams reference server-side sockets.
        sched, self._infer = self._infer, None
        if sched is not None:
            self._lib.trpc_infer_stop(sched)
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_server_stop(ptr)
            self._lib.trpc_server_destroy(ptr)
