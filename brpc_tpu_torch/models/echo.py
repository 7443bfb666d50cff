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

import threading

import torch

from brpc_tpu_torch.ops.checksum import sum32
from brpc_tpu_torch.ops.echo_kernel import (_COLS, _ROWS, batched_landing,
                                            echo_fused, echo_land_batch)
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P
from brpc_tpu_torch.rpc import zerocopy
from brpc_tpu_torch.rpc.batch import _landing_bytes
from brpc_tpu_torch.rpc.client import make_rpc_error
from brpc_tpu_torch.rpc.observe import Gauge, span
from brpc_tpu_torch.transport.ici import IciTransport, _ring_perm

#: Process-wide counters in /vars: calls that EchoPipelines landed, and
#: those of them landed by the batched launch (`echo_land_batch`).
LANDED = "trpc_echo_landed"
LANDED_BATCHED = "trpc_echo_landed_batched"
_landed_lock = threading.Lock()
_landed = None


def _landed_vars():
    global _landed
    with _landed_lock:
        if _landed is None:
            _landed = (
                Gauge(LANDED, "calls that echo pipelines landed"),
                Gauge(LANDED_BATCHED, "calls that echo pipelines landed "
                      "through the batched in-place launch"))
    return _landed


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
    response copy and the sent checksum once.  `submit(k)` puts k calls of
    that copy on a batch pipeline over `channel` (one D2H copy into pinned
    memory per submit for a GPU payload), each response landing in one of
    the caller's `resp_bufs` (any `Batch.submit` takes: CPU tensors, pinned
    for a GPU payload, or `RmaBuffer`s, CUDA-registered for a GPU payload).
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

    A landing buffer goes back to the free list with its event and is
    reused only once that event has completed.  A failed member raises
    its typed error once the rest of the drained completions are
    accounted for; its landing buffer is retired, never reused, since a
    late server-side put may still reach an RmaBuffer.  `rows`/`cols` are
    echo_fused's tile contract (a 1 KiB payload passes rows=1, cols=256).
    The process-wide gauges `trpc_echo_landed` and
    `trpc_echo_landed_batched` count the calls landed, and those landed
    batched.

    Under a torch profiler each step is a span (`observe.span`):
    `trpc.echo.submit` holds `trpc.echo.reuse_wait` (a buffer's earlier
    landing read) and the batch's `trpc.batch.stage`/`.issue`;
    `trpc.echo.poll` holds `trpc.batch.wait` and, per completion,
    `trpc.echo.land` and `trpc.echo.check`: per call the H2D copy and
    its event, then K1 on the landed copy; batched the call's landing
    address taken, then its row and sum handed out, with the poll's one
    launch and event between them in the poll's own time."""

    def __init__(self, channel, payload: torch.Tensor, resp_bufs,
                 method: str = "Echo.Echo", timeout_ms: int = 0,
                 rows: int = _ROWS, cols: int = _COLS):
        self._tile = (rows, cols)
        self.copy, self.sent = echo_fused(payload, rows, cols)
        self.device = payload.device
        self.nbytes = self.copy.numel() * 4
        self._lib = channel._lib
        self._method = method
        self._timeout_ms = timeout_ms
        hosts = []
        for buf in resp_bufs:
            view = _landing_bytes(buf)
            if view.size < self.nbytes:
                raise ValueError(f"a landing buffer is smaller than the "
                                 f"{self.nbytes}-byte response")
            hosts.append(view.ctypes.data)
        self._free = [(buf, None) for buf in resp_bufs]
        self._inflight: dict[int, object] = {}
        addrs = batched_landing(self.device, self.nbytes, hosts)
        # id(landing buffer) -> its device address, where poll lands batched
        self._mapped = None if addrs is None else {
            id(buf): a for buf, a in zip(resp_bufs, addrs)}
        self._landed = _landed_vars()
        self._pipe = channel.pipeline()

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def _take(self):
        buf, copied = self._free.pop()
        with span("trpc.echo.reuse_wait"):
            if copied is not None:
                copied.synchronize()  # what read it (copy or launch) is done
        return buf

    def submit(self, k: int) -> None:
        """Puts k more calls in flight; needs k free landing buffers."""
        if k > len(self._free):
            raise ValueError(f"{k} calls but {len(self._free)} free "
                             "landing buffers")
        with span("trpc.echo.submit"):
            bufs = [self._take() for _ in range(k)]
            tokens = self._pipe.submit(self._method, [self.copy] * k,
                                       resp_bufs=bufs,
                                       timeout_ms=self._timeout_ms)
            self._inflight.update(zip(tokens, bufs))

    def poll(self, max_n: int = 64, timeout_ms: int = -1):
        """[(echoed uint32 tensor on the payload's device, its K1 checksum
        as a 0-dim uint32 tensor)] for the completions drained.  Raises the
        first failure among them after handling all of them."""
        with span("trpc.echo.poll"):
            out, error = self._poll(max_n, timeout_ms)
        if error is not None:
            raise error
        return out

    def _poll(self, max_n: int, timeout_ms: int):
        landed, error = [], None
        for c in self._pipe.poll(max_n=max_n, timeout_ms=timeout_ms):
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
        total, batched = self._landed
        total.add(len(landed))
        if self._mapped is None:
            return [self._land(buf) for buf in landed], error
        batched.add(len(landed))
        return self._land_batched(landed), error

    def _land(self, buf):
        """One call's response: an H2D copy, its event, K1."""
        with span("trpc.echo.land"):
            landed = torch.from_numpy(
                _landing_bytes(buf)[:self.nbytes]).view(torch.int32)
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
        and one event after it for every buffer read."""
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
        return out

    def close(self) -> None:
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
