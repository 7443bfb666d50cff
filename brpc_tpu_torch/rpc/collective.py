"""Collective transfer schedules over the RMA fabric — group put plans;
port of brpc_tpu/rpc/collective.py (the wire structs are this module's own
copies).

Collectives move host memory: `send`, `recv` and a `ReadyMap`'s buffer are
`RmaBuffer`s (the one-sided landings), contiguous CPU tensors, writable
buffers or (send side) `bytes`.  A CUDA tensor raises TypeError; staging a
device tensor is the caller's job — copy it into a CUDA-registered
RmaBuffer's tensor view on its stream, wait for that copy, and only then
stamp the ReadyMap or start the collective
(brpc_tpu_torch/tools/pipeline_step.py does this).

The Python surface of cpp/net/collective.h: all-gather, reduce-scatter,
all-to-all and generic array resharding expressed as *planned sets of
one-sided RMA puts* between group members.  Every member holds a
``Group`` over the same ordered member list (explicit, or snapshotted
from a ``naming://`` view so drained members are excluded and an epoch
change mid-schedule fails the step whole-or-nothing), and calls the same
sequence of collectives; transfers are cut into ``trpc_coll_chunk_bytes``
chunks issued ``trpc_coll_inflight`` deep so chunk k+1's put overlaps
chunk k's verification (T3, arXiv 2401.16677).  A dropped/corrupted
chunk fails the step for the WHOLE group (CollAbortError) — a failed
run's buffers are undefined, and no successful run ever contains torn
bytes.

Resharding follows the portable-collectives decomposition of arXiv
2112.01075: ``plan_reshard_bytes`` factors a source→target redistribution
into the minimal put set (bytes whose owner does not change are reused
in place, never re-fetched), and ``Group.reshard`` executes it.  The
service form (``Reshard.Plan`` / ``Reshard.Execute``, served by any
``Server`` with ``enable_collective()``) plans over the wire and — for
Execute — moves shards addressed as KV blocks: each member's
source shard is block ``src_block_base + rank``, and the resharded
result re-publishes as ``dst_block_base + rank``.

Typical 4-member all-gather (each process)::

    srv = Server(); srv.enable_collective(); srv.start(port)
    g = collective.Group(members, my_rank)        # same list everywhere
    send = rma.RmaBuffer(S); recv = rma.RmaBuffer(4 * S)
    g.all_gather(send, recv, shard_bytes=S)
"""

from __future__ import annotations

import ctypes
import struct

import torch

from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.client import Channel, RpcError

# Wire forms — MUST mirror cpp/net/collective.h (coll-wire markers):
# CollPutWire (80 bytes), ReshardReqWire (64), ShardRangeWire (24),
# ReshardPlanWire (40), all fixed little-endian.
_PUT_WIRE = struct.Struct("<QQIIIIIIQQQQII")
assert _PUT_WIRE.size == 80
_RESHARD_WIRE = struct.Struct("<QQQQIIIIIIQ")
assert _RESHARD_WIRE.size == 64
_RANGE_WIRE = struct.Struct("<IIQQ")
assert _RANGE_WIRE.size == 24
_PLAN_WIRE = struct.Struct("<QQQIIQ")
assert _PLAN_WIRE.size == 40

PLAN_METHOD = "Reshard.Plan"
EXECUTE_METHOD = "Reshard.Execute"

ALL_GATHER = 1
REDUCE_SCATTER = 2
ALL_TO_ALL = 3


class CollError(RpcError):
    """Base of the collective error family (codes 2121..2123)."""


class CollAbortError(CollError):
    """The step failed for the whole group (a peer's chunk dropped, a
    member timed out, or a Coll.Abort arrived) — whole-or-nothing."""


class CollEpochError(CollError):
    """The group's naming view changed mid-schedule; recompile the
    group from the registry and re-run."""


class CollMismatchError(CollError):
    """Buffer sizes or shardings do not fit the compiled plan."""


def _codes() -> tuple[int, int, int]:
    lib = load_library()
    a = ctypes.c_int()
    e = ctypes.c_int()
    m = ctypes.c_int()
    lib.trpc_coll_codes(ctypes.byref(a), ctypes.byref(e), ctypes.byref(m))
    return a.value, e.value, m.value


def _coll_error(code: int, text: str) -> RpcError:
    a, e, m = _codes()
    cls = {a: CollAbortError, e: CollEpochError, m: CollMismatchError}.get(
        code)
    return (cls or CollError)(code, text)


def _buf_addr_len(buf) -> tuple[int, int]:
    """(address, nbytes) of an RmaBuffer, a contiguous CPU tensor, a
    writable buffer-protocol object, or `bytes` (send-side only — the
    caller keeps the object alive through the blocking run, so the address
    stays valid).  A CUDA tensor raises TypeError: no host address."""
    if hasattr(buf, "address"):
        return buf.address, buf.nbytes
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise TypeError(
                f"collectives move host memory, not a {buf.device} tensor "
                "— copy it into an RmaBuffer (registered with device=) and "
                "pass the RmaBuffer")
        if not buf.is_contiguous():
            raise TypeError("collective tensors must be contiguous")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    mv = memoryview(buf)
    if mv.readonly:
        if isinstance(buf, bytes):
            addr = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
            return addr, mv.nbytes
        raise TypeError(
            "read-only buffers other than bytes are not supported — pass "
            "an RmaBuffer (one-sided landings) or a writable buffer")
    view = (ctypes.c_char * 0).from_buffer(buf)
    return ctypes.addressof(view), mv.nbytes


def pack_ranges(ranges) -> bytes:
    """Packs [(rank, off, len), ...] as ShardRangeWire rows (the wire
    Reshard.Plan/Execute and the local planner both consume)."""
    return b"".join(_RANGE_WIRE.pack(rank, 0, off, ln)
                    for rank, off, ln in ranges)


def plan_reshard_bytes(src_ranges, dst_ranges, total: int,
                       nmembers: int) -> dict:
    """Plans src→dst locally (no RPC): {"bytes_moved", "bytes_reused",
    "naive_bytes", "steps"}.  bytes_moved < naive_bytes whenever the
    shardings overlap — the 2112.01075 minimality the bench row stamps.
    Ranges are (rank, global_off, len) tuples tiling [0, total)."""
    lib = load_library()
    rows = pack_ranges(list(src_ranges) + list(dst_ranges))
    moved = ctypes.c_uint64()
    reused = ctypes.c_uint64()
    naive = ctypes.c_uint64()
    steps = ctypes.c_uint32()
    rc = lib.trpc_coll_reshard_plan(
        rows, len(src_ranges), len(dst_ranges), total, nmembers,
        ctypes.byref(moved), ctypes.byref(reused), ctypes.byref(naive),
        ctypes.byref(steps))
    if rc != 0:
        raise ValueError("invalid shardings (must tile [0, total) with "
                         "ranks < nmembers)")
    return {"bytes_moved": moved.value, "bytes_reused": reused.value,
            "naive_bytes": naive.value, "steps": steps.value}


class ReadyMap:
    """Producer-stamped chunk-ready bitmap over a send buffer (the
    overlap-aware collective seam).  Create it over the SAME
    buffer a collective will read, ``stamp(off, len)`` ranges as the
    producer fills them (release-fenced after the writes), and pass the
    map as ``ready=`` to a Group collective: with ``trpc_coll_overlap``
    on, transfers fire the moment their compiled input chunks are
    stamped — microbatch i's communication overlapping microbatch i+1's
    compute; off, the executor waits once for the whole producer extent
    (byte-identical results either way).  The map does not own the
    buffer — keep the buffer alive while the map exists.

        ready = collective.ReadyMap(send, granularity=1 << 20)
        fill(send, 0, CHUNK); ready.stamp(0, CHUNK)   # ... keep filling
        g.reduce_scatter(send, recv, shard_bytes=S, ready=ready)
    """

    def __init__(self, buf, granularity: int = 0):
        lib = load_library()
        addr, nbytes = _buf_addr_len(buf)
        handle = lib.trpc_coll_ready_create(addr, nbytes, granularity)
        if handle == 0:
            raise ValueError(
                "ready map creation failed (empty buffer or bad "
                "granularity)")
        self._lib = lib
        self._handle = handle
        self.nbytes = nbytes

    @property
    def handle(self) -> int:
        """The opaque native handle (0 after close)."""
        return self._handle or 0

    def stamp(self, off: int, length: int) -> None:
        """Marks [off, off+length) ready.  `off` must be chunk-aligned
        and `length` a chunk multiple (or reach the buffer end); call it
        AFTER writing the bytes.  Monotonic — restamping is a no-op."""
        rc = self._lib.trpc_coll_ready_stamp(self._handle, off, length)
        if rc != 0:
            raise ValueError(
                f"bad stamp [{off}, {off + length}) — misaligned or "
                f"outside the {self.nbytes}-byte map")

    def close(self) -> None:
        handle, self._handle = self._handle, None
        if handle:
            self._lib.trpc_coll_ready_destroy(handle)

    def __enter__(self) -> "ReadyMap":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def ready_maps_live() -> int:
    """Readiness maps currently registered in THIS process (0 when all
    closed — the quiescence probe for overlap tests)."""
    return int(load_library().trpc_coll_ready_maps())


class Group:
    """Channels to one member snapshot; every member must issue the same
    sequence of collectives.  Not safe for concurrent calls."""

    def __init__(self, members=None, my_rank: int = 0,
                 naming_url: str | None = None, self_addr: str = "",
                 timeout_ms: int = 30000, use_shm: bool = True):
        lib = load_library()
        if naming_url is not None:
            ptr = lib.trpc_coll_group_create_naming(
                naming_url.encode(), self_addr.encode(), timeout_ms,
                1 if use_shm else 0)
            if not ptr:
                raise RuntimeError(
                    f"group snapshot from {naming_url!r} failed (registry "
                    f"unreachable, or {self_addr!r} is not a member)")
        else:
            csv = ",".join(members)
            ptr = lib.trpc_coll_group_create(
                csv.encode(), my_rank, timeout_ms, 1 if use_shm else 0)
            if not ptr:
                raise RuntimeError(f"group init failed for {members!r}")
        self._lib = lib
        self._ptr = ptr

    @property
    def rank(self) -> int:
        return self._lib.trpc_coll_group_rank(self._ptr)

    @property
    def size(self) -> int:
        return self._lib.trpc_coll_group_size(self._ptr)

    @property
    def naming_version(self) -> int:
        """The snapshotted naming-view version (0 for explicit groups)."""
        return self._lib.trpc_coll_group_version(self._ptr)

    def _run(self, op: int, send, recv, shard_bytes: int,
             run_seq: int, ready=None) -> None:
        saddr, slen = _buf_addr_len(send)
        raddr, rlen = _buf_addr_len(recv)
        if ready is not None:
            handle = ready if isinstance(ready, int) else ready.handle
            rc = self._lib.trpc_coll_run_ready(
                self._ptr, op, saddr, slen, raddr, rlen, shard_bytes,
                run_seq, handle)
        else:
            rc = self._lib.trpc_coll_run(self._ptr, op, saddr, slen, raddr,
                                         rlen, shard_bytes, run_seq)
        if rc != 0:
            raise _coll_error(rc, f"collective op {op} failed (rc={rc})")

    def all_gather(self, send, recv, shard_bytes: int = 0,
                   run_seq: int = 0, ready=None) -> None:
        """Gathers every member's `send` shard into everyone's `recv`
        (rank-ordered).  shard_bytes defaults to len(send).  `ready`:
        an optional ReadyMap over `send` (overlap-aware path)."""
        self._run(ALL_GATHER, send, recv, shard_bytes, run_seq, ready)

    def reduce_scatter(self, send, recv, shard_bytes: int = 0,
                       run_seq: int = 0, ready=None) -> None:
        """Element-wise u32-sums the members' `send` arrays (n*shard
        each) and scatters chunk r to rank r's `recv`.  MUTATES `send`
        (it is the ring accumulator).  `ready`: an optional ReadyMap
        over `send` (overlap-aware path)."""
        self._run(REDUCE_SCATTER, send, recv, shard_bytes, run_seq, ready)

    def all_to_all(self, send, recv, shard_bytes: int = 0,
                   run_seq: int = 0, ready=None) -> None:
        """Transposes blocks: rank r's block d lands at rank d's block
        r.  shard_bytes defaults to len(send) / group size.  `ready`:
        an optional ReadyMap over `send` (overlap-aware path)."""
        self._run(ALL_TO_ALL, send, recv, shard_bytes, run_seq, ready)

    def reshard(self, src_ranges, dst_ranges, total: int, send, recv,
                run_seq: int = 0) -> None:
        """Moves this rank's source ranges (concatenated in `send`) into
        the target layout (`recv` receives this rank's target ranges) —
        only bytes whose owner changes ride the fabric."""
        rows = pack_ranges(list(src_ranges) + list(dst_ranges))
        saddr, slen = _buf_addr_len(send)
        raddr, rlen = _buf_addr_len(recv)
        rc = self._lib.trpc_coll_reshard_run(
            self._ptr, rows, len(src_ranges), len(dst_ranges), total,
            saddr, slen, raddr, rlen, run_seq)
        if rc != 0:
            raise _coll_error(rc, f"reshard failed (rc={rc})")

    def close(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_coll_group_destroy(ptr)

    def __enter__(self) -> "Group":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def sessions_live() -> int:
    """Receive sessions currently registered in THIS process (0 when no
    run is in flight — the cancel/abort quiescence probe)."""
    return int(load_library().trpc_coll_sessions())


def rma_scavenge() -> int:
    """One explicit RMA span-scavenger pass (net/rma.h rma_scavenge);
    returns window slots reclaimed.  The runtime also runs it lazily."""
    return int(load_library().trpc_rma_scavenge())


class ReshardClient:
    """RPC client for the resharding service on any collective-enabled
    server (Reshard.Plan is stateless; Reshard.Execute moves KV-block-
    addressed shards on the member fleet)."""

    def __init__(self, channel: Channel):
        self._ch = channel

    def plan(self, src_ranges, dst_ranges, total: int,
             nmembers: int) -> dict:
        """Plans over the wire; same dict shape as plan_reshard_bytes
        plus "transfers"."""
        req = _RESHARD_WIRE.pack(0, 0, 0, total, 0, nmembers,
                                 len(src_ranges), len(dst_ranges), 0, 0, 0)
        req += pack_ranges(list(src_ranges) + list(dst_ranges))
        try:
            resp = self._ch.call(PLAN_METHOD, req)
        except RpcError as e:
            raise _coll_error(e.code, e.text) from None
        moved, reused, naive, steps, transfers, _ = _PLAN_WIRE.unpack(resp)
        return {"bytes_moved": moved, "bytes_reused": reused,
                "naive_bytes": naive, "steps": steps,
                "transfers": transfers}

    @staticmethod
    def execute_request(run_id: int, members, my_rank: int, src_ranges,
                        dst_ranges, total: int, src_block_base: int,
                        dst_block_base: int, use_shm: bool = True,
                        timeout_ms: int = 30000) -> bytes:
        """The personalized Reshard.Execute request for `my_rank` — a
        coordinator builds one per member and fans them out (each member
        reshards kv block src_block_base+rank into dst_block_base+rank)."""
        req = _RESHARD_WIRE.pack(
            run_id, src_block_base, dst_block_base, total, my_rank,
            len(members), len(src_ranges), len(dst_ranges),
            1 if use_shm else 0, timeout_ms, 0)
        for m in members:
            req += m.encode()[:63].ljust(64, b"\0")
        req += pack_ranges(list(src_ranges) + list(dst_ranges))
        return req

    def execute(self, request: bytes, timeout_ms: int = 0) -> tuple[int, int]:
        """Sends one prepared execute_request; returns (dst_len,
        generation) of the member's re-published shard block."""
        try:
            resp = self._ch.call(EXECUTE_METHOD, request,
                                 timeout_ms=timeout_ms)
        except RpcError as e:
            raise _coll_error(e.code, e.text) from None
        return struct.unpack("<QQ", resp)
