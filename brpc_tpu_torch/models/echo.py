"""Benchmark workloads — port of brpc_tpu/models/echo.py.

- ``single_chip_echo_step`` → example/echo_c++ (single sync echo, one chip),
  as in the reference.
- ``rpc_echo_step`` → the device → RPC stack → device leg of bench.py's
  rpc child (bench.py:207-357) as one call: the echo data plane end to end.
- ``EchoPipeline`` and ``rpc_batch_echo_step`` → the device side of
  bench.py's pipelined batch leg (``_rpc_batch_goodput``,
  bench.py:396-520): a window of calls in flight on a batch pipeline,
  responses landing in the caller's buffers, each checked on the device.
- ``make_nton_exchange`` → example/rdma_performance N-to-N 64MB exchange,
  over the peers of a Fabric (cards of one host, or peers sharing one).
- ``make_ring_exchange`` → the explicit ring variant of that exchange.
- ``make_full_dataplane_step`` → the combined fan-out + partition + ring
  step `dryrun_multichip` runs over a multi-device mesh.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

from brpc_tpu_torch.ops.checksum import sum32
from brpc_tpu_torch.ops.echo_kernel import (_COLS, _ROWS, batched_landing,
                                            echo_fused, echo_land_batch)
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P
from brpc_tpu_torch.rpc import zerocopy
from brpc_tpu_torch.rpc.client import make_rpc_error
from brpc_tpu_torch.rpc.observe import Gauge, span
from brpc_tpu_torch.transport.ici import IciTransport, _ring_perm

#: Process-wide counters in /vars: calls that EchoPipelines landed, and
#: those of them landed by the batched launch (`echo_land_batch`); calls
#: they submitted, and those of them whose request the runtime copied in
#: the crossing (`PreparedSubmit.copied`); D2H stagings of a pipeline's
#: request, one for each pipeline on a card.
LANDED = "trpc_echo_landed"
LANDED_BATCHED = "trpc_echo_landed_batched"
SUBMITTED = "trpc_echo_submitted"
SUBMITTED_COPIED = "trpc_echo_submitted_copied"
STAGED = "trpc_echo_staged"
#: Process-wide clocks of the threads that drive EchoPipelines, in /vars,
#: taken with or without a profiler: polls that landed calls; wall ns
#: inside `poll` less its native wait, and inside that wait (GIL released);
#: wall ns of `submit`.  A pipeline sums these in Python (`_clock`) and
#: adds them to the gauges every CLOCK_FLUSH_POLLS polls that land calls,
#: at a poll that leaves nothing in flight, and at close.  A flush at
#: least CPU_READ_NS after the thread's last reading of its CPU clock reads
#: it again and adds the thread's CPU ns and wall ns in between: the CPU
#: clock is a system call (microseconds on the card's host, more under
#: load) that steps by 10 ms there, far coarser than a poll.
POLLS = "trpc_echo_polls"
POLL_NS = "trpc_echo_poll_ns"
POLL_WAIT_NS = "trpc_echo_poll_wait_ns"
SUBMIT_NS = "trpc_echo_submit_ns"
HOST_CPU_NS = "trpc_echo_host_cpu_ns"
HOST_CPU_WALL_NS = "trpc_echo_host_cpu_wall_ns"
_CLOCKS = (
    (POLLS, "echo pipeline polls that landed calls"),
    (POLL_NS, "wall ns inside echo pipeline polls, less their native waits"),
    (POLL_WAIT_NS, "wall ns echo pipeline polls waited in the native poll, "
     "GIL released"),
    (SUBMIT_NS, "wall ns inside echo pipeline submits"),
    (HOST_CPU_NS, "CPU ns of the threads that drive echo pipelines, "
     "between their readings of the CPU clock at flushes"),
    (HOST_CPU_WALL_NS, "wall ns of the stretches trpc_echo_host_cpu_ns "
     "covers"))
_POLLS, _POLL, _WAIT, _SUBMIT, _CPU, _CPU_WALL = range(len(_CLOCKS))
CLOCK_FLUSH_POLLS = 64
CPU_READ_NS = 500_000_000
#: .last: (perf_counter_ns, thread_time_ns) at this thread's last reading
_thread_clock = threading.local()
#: Per-tenant counters in /vars of pipelines whose channel carries a QoS
#: tag: calls landed, and host microseconds their constructors and submits
#: spent blocked on device work (`.format(tenant)`).
TENANT_LANDED = "trpc_echo_{}_landed"
TENANT_DEVICE_WAIT_US = "trpc_echo_{}_device_wait_us"
_EchoVars = collections.namedtuple(
    "_EchoVars", "landed landed_batched submitted submitted_copied staged "
    "clocks")
_landed_lock = threading.Lock()
_echo = None
_tenants: dict = {}  # tenant -> (landed, device_wait_us) gauges
_streams: dict = {}  # (device index, tenant, priority) -> its class stream
_NO_STREAM = contextlib.nullcontext()


def _echo_vars() -> _EchoVars:
    global _echo
    with _landed_lock:
        if _echo is None:
            _echo = _EchoVars(
                Gauge(LANDED, "calls that echo pipelines landed"),
                Gauge(LANDED_BATCHED, "calls that echo pipelines landed "
                      "through the batched in-place launch"),
                Gauge(SUBMITTED, "calls that echo pipelines submitted"),
                Gauge(SUBMITTED_COPIED, "calls that echo pipelines "
                      "submitted whose request the runtime copied"),
                Gauge(STAGED, "D2H stagings of echo pipelines' requests"),
                tuple(Gauge(*c) for c in _CLOCKS))
    return _echo


def _tenant_vars(tenant: str):
    with _landed_lock:
        pair = _tenants.get(tenant)
        if pair is None:
            pair = _tenants[tenant] = (
                Gauge(TENANT_LANDED.format(tenant),
                      f"calls that echo pipelines of tenant {tenant!r} "
                      "landed"),
                Gauge(TENANT_DEVICE_WAIT_US.format(tenant),
                      f"host microseconds the submits of echo pipelines of "
                      f"tenant {tenant!r} spent blocked on device work"))
    return pair


def class_stream(device: torch.device, tenant: str,
                 priority: int) -> torch.cuda.Stream:
    """The CUDA stream of the QoS class (tenant, priority) on `device`,
    taken once from torch's stream pool and shared by the class's
    pipelines (so the caching allocator's blocks for it stay warm): lane 0
    (priority 0) at the highest priority torch offers, every other lane at
    priority 0, the default."""
    key = (device.index, tenant, priority)
    with _landed_lock:
        stream = _streams.get(key)
        if stream is None:
            prio = torch.cuda.Stream.priority_range()[1] if priority == 0 \
                else 0
            stream = _streams[key] = torch.cuda.Stream(device, priority=prio)
    return stream


def single_chip_echo_step(payload: torch.Tensor):
    """One echo round trip on one chip: the server 'receives' the request
    buffer, verifies it, and materializes the response copy in device
    memory.  Returns (response, checksum).  The copy rolls by one lane like
    the reference's (jnp.roll direction)."""
    if payload.dtype == torch.uint32:  # rolled as int32 bits
        resp = torch.roll(payload.view(torch.int32), 1).view(torch.uint32)
    else:
        resp = torch.roll(payload, 1)
    return resp, sum32(resp)


def rpc_echo_step(channel, payload: torch.Tensor, method: str = "Echo.Echo",
                  timeout_ms: int = 0):
    """The echo data plane end to end for a uint32 payload that meets
    echo_fused's block contract.

    On the payload's device, one fused pass materializes the response copy
    and its checksum (echo_fused).  The copy enters the RPC stack by
    reference — zero host copies for a CPU tensor, exactly one D2H copy
    into pinned memory for a GPU tensor — and is echoed by the server at
    `method`.  The echoed bytes land in (pinned) host memory, return to the
    device, and the fused pass checksums them there.

    Returns (echoed tensor on the payload's device, sent checksum, echoed
    checksum); the checksums are 0-dim uint32 tensors on that device."""
    resp, sent = echo_fused(payload)
    landed = zerocopy.call_zero_copy_into(channel, method, resp,
                                          timeout_ms=timeout_ms)
    if landed.numel() != resp.numel() * 4:
        raise RuntimeError(
            f"echo returned {landed.numel()} bytes for {resp.numel() * 4}")
    back = landed.view(torch.int32).to(payload.device, non_blocking=True)
    back = back.view(torch.uint32)
    _, got = echo_fused(back)
    return back, sent, got


class EchoPipeline:
    """The echo data plane as a windowed pipeline: the device side of
    bench.py's batch goodput leg.

    On the payload's device, one fused pass (K1, `echo_fused`) makes the
    response copy and the sent checksum once, and the constructor prepares
    the submit of that copy once (`Batch.prepare`): a copy on a card is
    staged to pinned host memory with one D2H copy and one synchronise, a
    CPU copy is sent from its own memory.  A pipeline sends the bytes
    `copy` held at construction.  `submit(k)` puts k calls of it on a
    batch pipeline over `channel` in one crossing, each response landing
    in one of the caller's `resp_bufs` (any `Batch.submit` takes: CPU
    tensors, pinned for a GPU payload, or `RmaBuffer`s, CUDA-registered
    for a GPU payload).  At or below `batch.COPY_REQUEST_MAX` bytes the
    runtime copies the request into each call; above it each call
    references the staged bytes, with a pin and a deleter.
    `poll()` drains completions with the GIL released and lands them on
    the device, returning (echoed tensor, echoed checksum) pairs, in one
    of two ways that the pipeline picks once, in its constructor, from
    what it can observe (`echo_kernel.batched_landing`):

    - batched: a CUDA payload below LAND_BATCH_BELOW (1 MiB) bytes whose
      every landing buffer is device-mapped host memory (pinned, or a
      CUDA-registered RmaBuffer) in K1's 16-byte phase.  One launch per
      64 calls a poll (`echo_land_batch`) reads the drained responses in
      place over PCIe, writes each to a row of one device output and its
      wrapping sum to one sums tensor; the pairs are row and element
      views of those.  One event per poll, recorded after the launch,
      guards every landing buffer it read.
    - per call, otherwise: each landed response is copied back to the
      device (non_blocking) and checksummed there by K1 (`echo_fused`),
      with an event per call after its H2D copy; a CPU payload takes the
      plain version.

    A QoS class runs on a stream of its own.  When `channel.qos` carries
    a tag (tenant, priority) and the payload is on a card, every device op
    of the pipeline runs on the class's stream (`class_stream`; lane 0 at
    the highest priority): K1's copy in the constructor (after the caller's
    current stream, which made the payload), the staging D2H, so that its
    synchronise waits on this class's work only, the per-call H2D and K1,
    the batched launch, and every landing-buffer event.  What the
    constructor and `poll` hand back is safe on the caller's current
    stream: that stream waits on the class stream's work so far, and
    `record_stream` keeps the tensors' blocks from the allocator until it
    is done with them.  An untagged pipeline runs on
    the caller's current stream.  A tagged pipeline also adds to its
    tenant's gauges `trpc_echo_<tenant>_landed` and
    `trpc_echo_<tenant>_device_wait_us` (the event synchronises of
    `reuse_wait` and the constructor's staging, its D2H and synchronise,
    host microseconds; a poll blocks on none).

    A landing buffer goes back to the free list with its event and is
    reused only once that event has completed: a submit synchronises each
    distinct event of the buffers it takes once (on the batched path a
    poll's buffers share one).  A failed member raises its typed error
    once the rest of the drained completions are accounted for; its
    landing buffer is retired, never reused, since a late server-side put
    may still reach an RmaBuffer.  `rows`/`cols` are
    echo_fused's tile contract (a 1 KiB payload passes rows=1, cols=256).
    The process-wide gauges `trpc_echo_landed` and
    `trpc_echo_landed_batched` count the calls landed, and those landed
    batched; `trpc_echo_submitted` and `trpc_echo_submitted_copied` the
    calls submitted, and those whose request the runtime copied;
    `trpc_echo_staged` the D2H stagings.  The calling thread's clocks,
    profiler or not, go to `trpc_echo_polls` (polls that landed calls),
    `trpc_echo_poll_ns` (wall time in `poll` less the native wait),
    `trpc_echo_poll_wait_ns` (that wait, stamped by `Batch.poll`'s
    `waited`) and `trpc_echo_submit_ns` (wall time in `submit`), read
    every poll and submit.  A pipeline sums them and adds them to the
    gauges every CLOCK_FLUSH_POLLS polls that land calls, whenever a poll
    leaves nothing in flight, and at close; a flush at least CPU_READ_NS
    after the thread last read its CPU clock reads it again and adds the
    thread's CPU time and wall time in between to `trpc_echo_host_cpu_ns`
    and `trpc_echo_host_cpu_wall_ns`.

    Under a torch profiler each step is a span (`observe.span`):
    `trpc.echo.submit` holds `trpc.echo.reuse_wait` (the taken buffers'
    earlier landing reads) and the prepared submit's
    `trpc.batch.stage`/`.issue`;
    `trpc.echo.poll` holds `trpc.batch.wait` and, per completion,
    `trpc.echo.land` and `trpc.echo.check`: per call the H2D copy and
    its event, then K1 on the landed copy; batched the call's landing
    address taken, then its row and sum handed out, with the poll's one
    launch and event between them in the poll's own time."""

    def __init__(self, channel, payload: torch.Tensor, resp_bufs,
                 method: str = "Echo.Echo", timeout_ms: int = 0,
                 rows: int = _ROWS, cols: int = _COLS):
        self._tile = (rows, cols)
        self.device = payload.device
        self.qos = channel.qos
        self._stream = None
        if self.qos is not None and payload.is_cuda:
            self._stream = class_stream(self.device, *self.qos)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            payload.record_stream(self._stream)
        self._vars = _echo_vars()
        self._clock = [0] * len(_CLOCKS)  # readings not yet in the gauges
        self._tenant = None if self.qos is None else _tenant_vars(
            self.qos[0])
        self._pipe = channel.pipeline()
        try:
            with self._on_stream():
                self.copy, self.sent = echo_fused(payload, rows, cols)
                self._prep = self._pipe.prepare(method, self.copy, resp_bufs,
                                                timeout_ms)
            self.nbytes = self.copy.numel() * 4
            if any(cap < self.nbytes for _, cap in self._prep.landing):
                raise ValueError(f"a landing buffer is smaller than the "
                                 f"{self.nbytes}-byte response")
        except BaseException:
            self._pipe.close()
            raise
        self._hand_back([(self.copy, self.sent)])
        # device waits not yet in the tenant gauge: here the staging's
        self._wait_ns = self._prep.staged_wait_ns
        if self._prep.staged:
            self._vars.staged.add(1)
        self._lib = channel._lib
        self._free = [(buf, None) for buf in resp_bufs]
        self._inflight: dict[int, object] = {}
        addrs = batched_landing(self.device, self.nbytes,
                                [a for a, _ in self._prep.landing])
        # id(landing buffer) -> its device address, where poll lands batched
        self._mapped = None if addrs is None else {
            id(buf): a for buf, a in zip(resp_bufs, addrs)}
        self._add_wait()

    def _flush_clock(self) -> None:
        """Adds the clock readings summed since the last flush, and the
        thread's CPU and wall time since its last reading of its CPU clock
        (by any pipeline) where that is CPU_READ_NS old, to the
        process-wide gauges."""
        wall = time.perf_counter_ns()
        last = getattr(_thread_clock, "last", None)
        if last is None or wall - last[0] >= CPU_READ_NS:
            cpu = time.thread_time_ns()
            _thread_clock.last = (wall, cpu)
            if last is not None:
                self._clock[_CPU_WALL] += wall - last[0]
                self._clock[_CPU] += cpu - last[1]
        for gauge, value in zip(self._vars.clocks, self._clock):
            if value:
                gauge.add(value)
        self._clock = [0] * len(_CLOCKS)

    def _on_stream(self):
        """The class stream as the current stream (a no-op untagged)."""
        return _NO_STREAM if self._stream is None else torch.cuda.stream(
            self._stream)

    def _hand_back(self, pairs) -> None:
        """Makes the tensors of `pairs`, written on the class stream, safe
        on the caller's current stream."""
        if self._stream is None:
            return
        caller = torch.cuda.current_stream(self.device)
        caller.wait_stream(self._stream)
        for pair in pairs:
            for t in pair:
                t.record_stream(caller)

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def _add_wait(self) -> None:
        """Whole microseconds of device waits to the tenant's gauge."""
        if self._tenant is not None and self._wait_ns >= 1000:
            self._tenant[1].add(self._wait_ns // 1000)
        self._wait_ns %= 1000

    def submit(self, k: int) -> None:
        """Puts k more calls in flight; needs k free landing buffers."""
        if k > len(self._free):
            raise ValueError(f"{k} calls but {len(self._free)} free "
                             "landing buffers")
        if k <= 0:
            return
        start = time.perf_counter_ns()
        with span("trpc.echo.submit"):
            cut = len(self._free) - k
            taken = self._free[cut:]
            del self._free[cut:]
            with span("trpc.echo.reuse_wait"):
                # what read them (a copy or a launch) is done
                events = {id(e): e for _, e in taken if e is not None}
                if events:
                    t0 = time.perf_counter_ns()
                    for event in events.values():
                        event.synchronize()
                    self._wait_ns += time.perf_counter_ns() - t0
            bufs = [buf for buf, _ in taken]
            tokens = self._prep.submit(bufs)
            self._inflight.update(zip(tokens, bufs))
        self._vars.submitted.add(k)
        if self._prep.copied:
            self._vars.submitted_copied.add(k)
        self._add_wait()
        self._clock[_SUBMIT] += time.perf_counter_ns() - start

    def poll(self, max_n: int = 64, timeout_ms: int = -1):
        """[(echoed uint32 tensor on the payload's device, its K1 checksum
        as a 0-dim uint32 tensor)] for the completions drained.  Raises the
        first failure among them after handling all of them."""
        start = time.perf_counter_ns()
        waited = [start, start]  # the native wait's start and return
        with span("trpc.echo.poll"):
            out, error = self._poll(max_n, timeout_ms, waited)
        wait = waited[1] - waited[0]
        clock = self._clock
        clock[_POLLS] += bool(out)
        clock[_WAIT] += wait
        clock[_POLL] += time.perf_counter_ns() - start - wait
        if clock[_POLLS] >= CLOCK_FLUSH_POLLS or not self._inflight:
            self._flush_clock()
        if error is not None:
            raise error
        return out

    def _poll(self, max_n: int, timeout_ms: int, waited: list):
        landed, error = [], None
        for c in self._pipe.poll(max_n=max_n, timeout_ms=timeout_ms,
                                 waited=waited):
            buf = self._inflight.pop(c.token)
            if not c.ok:  # retired: the buffer leaves the free list
                error = error or make_rpc_error(self._lib, c.status, c.error)
                continue
            if not c.in_caller_buffer or c.resp_len != self.nbytes:
                self._free.append((buf, None))
                error = error or RuntimeError(
                    f"echo returned {c.resp_len} bytes for {self.nbytes} "
                    f"(in caller buffer: {c.in_caller_buffer})")
                continue
            landed.append(buf)
        if not landed:
            return [], error
        self._vars.landed.add(len(landed))
        if self._tenant is not None:
            self._tenant[0].add(len(landed))
        with self._on_stream():
            if self._mapped is None:
                out = made = [self._land(buf) for buf in landed]
            else:
                self._vars.landed_batched.add(len(landed))
                out, made = self._land_batched(landed)
        self._hand_back(made)
        return out, error

    def _land(self, buf):
        """One call's response: an H2D copy, its event, K1."""
        with span("trpc.echo.land"):
            landed = torch.from_numpy(
                self._prep.landed(buf, self.nbytes)).view(torch.int32)
            back = landed.to(self.device, non_blocking=True, copy=True)
            copied = None
            if back.is_cuda:
                copied = torch.cuda.Event()
                copied.record()
            self._free.append((buf, copied))
        back = back.view(torch.uint32)
        with span("trpc.echo.check"):
            _, got = echo_fused(back, *self._tile)
        return back, got

    def _land_batched(self, bufs):
        """A poll's responses read in place by one launch per 64 calls,
        and one event after it for every buffer read; returns the pairs,
        and as a pair the two tensors they view."""
        addrs = []
        for buf in bufs:
            with span("trpc.echo.land"):
                addrs.append(self._mapped[id(buf)])
        with torch.cuda.device(self.device):
            backs, sums = echo_land_batch(addrs, self.copy.numel(),
                                          self.device)
            read = torch.cuda.Event()
            read.record()
        out = []
        for buf, back, got in zip(bufs, backs.unbind(0), sums.unbind(0)):
            with span("trpc.echo.check"):
                self._free.append((buf, read))
                out.append((back, got))
        return out, [(backs, sums)]

    def close(self) -> None:
        self._flush_clock()
        self._pipe.close()
        for _, copied in self._free:
            if copied is not None:
                copied.synchronize()


def rpc_batch_echo_step(channel, payload: torch.Tensor, depth: int,
                        resp_bufs, method: str = "Echo.Echo",
                        timeout_ms: int = 0, rows: int = _ROWS,
                        cols: int = _COLS):
    """One window of the pipelined echo data plane: K1 makes the copy and
    the sent checksum on the payload's device, `depth` calls of it go out
    on a batch pipeline at once, the responses land in `resp_bufs` (at
    least `depth` of them), come back to the device and are checksummed
    there by K1.  Returns (echoed tensors, sent checksum, echoed
    checksums); the tensors are on the payload's device."""
    pipe = EchoPipeline(channel, payload, resp_bufs, method=method,
                        timeout_ms=timeout_ms, rows=rows, cols=cols)
    try:
        pipe.submit(depth)
        echoed = []
        while pipe.inflight:
            echoed += pipe.poll(max_n=depth)
    finally:
        pipe.close()
    return [b for b, _ in echoed], pipe.sent, [g for _, g in echoed]


def make_nton_exchange(fabric: Fabric, axis: str = "link"):
    """Every peer sends a distinct row block to every other peer and
    checksums what it received — one all-to-all over the mesh.

    Input layout per shard: (n, chunk) uint32, row j destined for peer j.
    Returns (received, checksum_per_peer)."""
    t = IciTransport(fabric, axis)

    def spmd(local):
        recv = t.all_to_all(local)
        return recv, sum32(recv)[None]

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=(P(axis), P(axis)))


def make_ring_exchange(fabric: Fabric, axis: str = "link"):
    """Explicit ring N-to-N (the schedule variant): N-1 hops, each hop's
    arrival checksummed into the carry."""
    t = IciTransport(fabric, axis)

    def spmd(local):
        buf, carry, _ = t.ring_exchange(local)
        return buf, carry[None]

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=(P(axis), P(axis)))


def make_full_dataplane_step(fabric: Fabric, fan_axis: str = "dp",
                             part_axis: str = "link"):
    """The composite step exercising every channel kind at once:

    - the request tensor is partitioned over `part_axis` (PartitionChannel),
    - replicated over `fan_axis` where each replica applies its own handler
      transform (ParallelChannel fan-out),
    - replicas' responses merge with psum over `fan_axis` (ResponseMerger),
    - partitions then run one ring hop over `part_axis` to their neighbour
      and back (streaming echo), and
    - a final sum over the partitions verifies the whole exchange.

    Returns fn: (payload[(rows, cols) f32]) -> (response, checksum)."""
    n_part = fabric.axis_size(part_axis)
    perm = _ring_perm(n_part, 1)
    perm_back = _ring_perm(n_part, -1)

    def spmd(payload):
        rep = coll.axis_index(fan_axis).to(payload.dtype)
        handled = payload * (rep + 1.0)  # per-replica handler
        merged = coll.psum(handled, fan_axis)  # ResponseMerger: sum
        sent = coll.ppermute(merged, part_axis, perm)  # stream out
        back = coll.ppermute(sent, part_axis, perm_back)  # echo back
        csum = coll.psum(torch.sum(back), part_axis)
        return back, csum[None]

    return fabric.spmd(spmd, in_specs=P(part_axis, None),
                       out_specs=(P(part_axis, None), P()))
