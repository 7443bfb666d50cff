"""Ring all-gather: one chunk per peer into every peer's output.  Port of
brpc_tpu/ops/ring_kernel.py.

`ring_all_gather(chunks, streams)` gathers one chunk per peer into every
peer's own output with kernel K2 (csrc/ring_kernel.cu, replacing the
reference's Pallas `_ring_kernel`).  Peers may share a card or lie on
cards of one host: K2 makes one launch per device that holds sources, on
the stream of that device's first peer, covering that device's sources and
writing all n outputs (one launch on one card).  It computes the gather
directly (each source byte read once, each output byte written once)
instead of the reference's ring of hops; `plan_launches` (one
`plan_gather` per source device, pure Python) chooses each launch's path,
width, tile and grid.  Launches on several cards are fenced inside the
kernel (a barrier over flags in peer-mapped memory, `barrier_flags`), so
each peer's stream waits only for its own card's launch, and fenced
gathers on other streams of the same cards take turns on each card
(`fenced_turns`); `ring_all_gather_fenced` runs the same fenced
launches, one per stream, on streams of one card.  CUDA chunks always go
to the kernel, or raise; CPU chunks take `ring_all_gather_plain`, the
reference kernel's hop schedule in plain torch (as the JAX tests run the
Pallas interpreter).

`ring_all_gather_kernel(fabric, axis)` puts it behind `Fabric.spmd` like the
reference's `ring_all_gather_pallas`; `ring_all_gather_reference` is the
collective it is checked against.  The kernel copies bytes, so it is
bit-exact for every dtype and every chunk size.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading

import torch

from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P
from brpc_tpu_torch.rpc.observe import span

KERNEL = "ring_kernel"      # csrc/<KERNEL>.cu
WRAPPER = "ring_all_gather"  # its name in _kernels.launches
# ... and that of its fenced launches (brpc_ring_all_gather_xcard)
FENCED_WRAPPER = "ring_all_gather_xcard"

# Mirrors of csrc/ring_kernel.cu's limits.
_MAX_PEERS = 64           # kMaxPeers
_BULK_WIDTH = 16          # bulk copies need 16-byte addresses and sizes
_BULK_TILE = 32 * 1024    # kMaxTile: bytes per shared-memory stage
_BULK_STAGES = 4          # kStages: tiles in flight in a bulk CTA
_RAGGED_TILE = 16 * 1024  # bytes per unit of the vector (ragged) path
_RAGGED_CTAS_PER_SM = 8   # kRaggedCtasPerSm: 256-thread CTAs, 2048 threads
#: The longest a fenced launch waits for another launch of its gather to
#: start (or to land its stores) before it traps.
BARRIER_TIMEOUT_S = 10.0


def ring_all_gather_reference(fabric: Fabric, axis: str = "link"):
    """Collective-based reference: out[j] = shard j's rows, on every peer."""

    def spmd(x):
        return coll.all_gather(x, axis, tiled=True)

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=P())


def ring_all_gather_kernel(fabric: Fabric, axis: str = "link"):
    """The kernel-backed all-gather over `fabric`, the port of
    `ring_all_gather_pallas`: fn(global (n*rows, cols)) -> peer 0's gathered
    (n*rows, cols) (every peer holds its own copy).  Raises RuntimeError for
    fewer than 2 peers or a mesh that is not 1-D, as the reference does."""
    n = fabric.axis_size(axis)
    if n < 2:
        raise RuntimeError("the ring kernel needs at least 2 peers; use "
                           "ring_all_gather_reference for one")
    if len(fabric.shape) != 1:
        raise RuntimeError("the ring kernel needs a 1-D mesh over the "
                           "gathered axis; build a dedicated Fabric for it")

    def spmd(x):
        return coll.group_call(x, axis, ring_all_gather)

    return fabric.spmd(spmd, in_specs=P(axis), out_specs=P())


def _check(chunks: list) -> None:
    if len(chunks) < 2:
        raise RuntimeError(f"ring all-gather needs at least 2 peers, got "
                           f"{len(chunks)}")
    first = chunks[0]
    for c in chunks[1:]:
        if (c.shape, c.dtype, c.device.type) != (first.shape, first.dtype,
                                                 first.device.type):
            raise ValueError("every peer's chunk must have one shape, dtype "
                             "and device type")
    if first.dim() == 0:
        raise ValueError("chunks must have a leading row dim")


def _out_shape(chunks: list) -> tuple:
    return (len(chunks) * chunks[0].shape[0], *chunks[0].shape[1:])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def ring_all_gather(chunks: list, streams=None) -> list:
    """chunks: one (rows, ...) tensor per peer, in ring order, each on its
    peer's device.  Returns each peer's gathered (n*rows, ...) tensor, its
    own allocation on that peer's device.  `streams` (CUDA only): the
    stream of each peer, on which its chunk was made and its output will
    be read; by default each chunk's device's current stream.  Fenced
    gathers (across cards) on other streams of the same cards take turns
    there (`fenced_turns`).  Under a torch profiler the CUDA path is the
    span `trpc.k2.gather`, holding `trpc.k2.alloc` (outputs), `.plan`
    (plans, barrier flags), `.order` (event waits; the fenced lock's
    turns) and `.launch` (the C call) (`observe.span`)."""
    _check(chunks)
    kind = chunks[0].device.type
    if kind == "cpu":
        return ring_all_gather_plain(chunks)
    if kind != "cuda":
        raise RuntimeError(
            f"ring_all_gather runs on cuda or cpu tensors, not {kind}")
    with span("trpc.k2.gather"):
        if streams is None:
            streams = [torch.cuda.current_stream(c.device) for c in chunks]
        if len(streams) != len(chunks):
            raise ValueError(
                f"{len(streams)} streams for {len(chunks)} chunks")
        return _launch(chunks, list(streams))


def ring_all_gather_fenced(chunks: list, streams: list, *,
                           timeout_s: float = BARRIER_TIMEOUT_S) -> list:
    """`ring_all_gather` as fenced launches, one per distinct stream of
    `streams` (CUDA only; at least two), each covering the chunks of the
    peers on that stream and ordered against the others only by the
    barrier inside the kernel: the launches that `ring_all_gather` makes
    across cards, here also on streams of one card.  Launches that share a
    card get a share of its SMs each so that all are resident at once, or
    RuntimeError is raised.  A launch that waits longer than `timeout_s`
    for another traps (a CUDA error at the next synchronise)."""
    _check(chunks)
    if chunks[0].device.type != "cuda":
        raise RuntimeError("fenced launches run on cuda tensors only")
    if len(streams) != len(chunks):
        raise ValueError(f"{len(streams)} streams for {len(chunks)} chunks")
    streams = list(streams)
    if len(set(streams)) < 2:
        raise ValueError("fenced launches need at least two distinct streams")
    first = {}
    groups = [first.setdefault(s, j) for j, s in enumerate(streams)]
    return _launch(chunks, streams, groups=groups, timeout_s=timeout_s)


def ring_all_gather_plain(chunks: list) -> list:
    """The reference kernel's hop schedule (`_ring_kernel`) in plain torch,
    on per-peer comm buffers: own chunk to its output slot and comm[0];
    hop 0 puts comm[0] into the right neighbour's comm[1]; hop `step`
    forwards comm[(step+1)%2] into the right neighbour's comm[step%2] (hop
    step+1) and then copies it to out[(r - step - 1) mod n].  Within a hop
    every write goes to a slot no read of that hop touches, so running the
    peers one after another is the parallel schedule.  It computes K2's
    function by another route, so it checks the kernel on the card."""
    _check(chunks)
    n = len(chunks)
    dev = chunks[0].device  # the hops run here; outputs go to each peer
    size = _bytes(chunks[0]).numel()
    outs = [torch.empty(_out_shape(chunks), dtype=c.dtype, device=dev)
            for c in chunks]
    out = [_bytes(o).view(n, size) for o in outs]
    comm = torch.empty((n, 2, size), dtype=torch.uint8, device=dev)
    for r, c in enumerate(chunks):
        out[r][r] = _bytes(c.contiguous()).to(dev)
        comm[r, 0] = out[r][r]
    for r in range(n):
        comm[(r + 1) % n, 1] = comm[r, 0]
    for step in range(n - 1):
        recv_slot, parity = (step + 1) % 2, step % 2
        if step + 1 < n - 1:
            for r in range(n):
                comm[(r + 1) % n, parity] = comm[r, recv_slot]
        for r in range(n):
            out[r][(r - step - 1) % n] = comm[r, recv_slot]
    return [o.to(c.device) for o, c in zip(outs, chunks)]


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """One launch of K2.  Path "bulk" (width 16): bulk copies through
    shared memory, stored to every output, on this card or (over NVLink)
    another; "ragged" (width 8, 4, 2 or 1): threads copy `width` bytes at
    a time.  Each chunk is cut into tiles of `tile_bytes`; a unit is one
    (source, tile) pair, and `grid` CTAs walk the `units` with a grid
    stride.  `device` is the launch's device index and `sources` the
    chunks it reads.  A `fenced` launch is one of several of a gather,
    ordered by the barrier in the kernel; on the bulk path its unit is a
    (destination, source, tile) triple, stored to that one output."""

    width: int
    tile_bytes: int
    units: int
    grid: int
    path: str = "bulk"
    device: int = 0
    sources: tuple = ()
    fenced: bool = False


def plan_gather(chunk_bytes: int, n: int, addrs, sms: int, *,
                sources=None, device: int = 0,
                fenced: bool = False) -> GatherPlan:
    """The launch for `sources` (default: all n chunks) of `chunk_bytes`
    each, given the addresses of those chunks and of every output, and the
    SMs the launch may fill (its device's count, or its share of them).
    The width is the widest of 16, 8, 4, 2, 1 that divides the chunk size
    and every address.  A fenced bulk launch has n units a tile, one per
    destination, and at most one CTA per `_BULK_STAGES` units, so that
    every CTA's ring of stages fills.  Raises RuntimeError for fewer than
    2 or more than 64 peers."""
    if not 2 <= n <= _MAX_PEERS:
        raise RuntimeError(f"the ring kernel takes 2 to {_MAX_PEERS} peers, "
                           f"got {n}")
    sources = tuple(range(n)) if sources is None else tuple(sources)
    width = _BULK_WIDTH
    while width > 1 and (chunk_bytes % width
                         or any(a % width for a in addrs)):
        width //= 2
    path = "bulk" if width == _BULK_WIDTH else "ragged"
    if path == "bulk":
        tile, per_sm = min(_BULK_TILE, chunk_bytes), 1
    else:
        tile, per_sm = min(_RAGGED_TILE, chunk_bytes), _RAGGED_CTAS_PER_SM
    units = len(sources) * -(-chunk_bytes // tile) if chunk_bytes else 0
    grid = min(units, per_sm * sms)
    if fenced and path == "bulk":
        units *= n
        grid = max(1, min(per_sm * sms, units // _BULK_STAGES))
    return GatherPlan(width, tile, units, grid, path, device, sources,
                      fenced)


def plan_launches(chunk_bytes: int, devices, src_addrs, out_addrs,
                  sms, groups=None) -> list:
    """K2's launches for n peers whose chunk j and output j lie on device
    index `devices[j]`: one `plan_gather` per launch group, in the order
    of its first peer, covering the group's chunks and writing all n
    outputs.  `groups[j]` names peer j's launch (default `devices`: one
    launch per device that holds sources); every peer of a group lies on
    one device.  `sms(device)` gives a device's SM count.  More than one
    launch makes fenced launches, and launches that share a device split
    its SMs evenly, so that all of them are resident at once; RuntimeError
    when a device has fewer SMs than launches."""
    n = len(devices)
    groups = list(devices) if groups is None else list(groups)
    keys = list(dict.fromkeys(groups))
    members = {k: [j for j in range(n) if groups[j] == k] for k in keys}
    home = {}
    for k in keys:
        on = {devices[j] for j in members[k]}
        if len(on) != 1:
            raise ValueError(f"launch group {k!r} spans devices {sorted(on)}")
        home[k] = on.pop()
    fenced = len(keys) > 1
    sharing = collections.Counter(home.values())
    plans = []
    for k in keys:
        dev, sources = home[k], members[k]
        share = sms(dev) // sharing[dev]
        if share < 1:
            raise RuntimeError(
                f"{sharing[dev]} fenced launches cannot all be resident on "
                f"device {dev} ({sms(dev)} SMs): the barrier would wait "
                "forever")
        plans.append(plan_gather(
            chunk_bytes, n, [src_addrs[j] for j in sources] + list(out_addrs),
            share, sources=sources, device=dev, fenced=fenced))
    return plans


def check_coresident(plans, sms, blocks_per_sm) -> None:
    """Raises RuntimeError unless the fenced launches that share a device
    fit on it at once: the SMs their grids take (`blocks_per_sm(device,
    width)` CTAs of a launch to an SM) add up to no more than
    `sms(device)`.  Launches alone on their device always fit (a CTA that
    waits for an SM holds up no other launch)."""
    taken = collections.Counter()
    count = collections.Counter(p.device for p in plans)
    for p in plans:
        if count[p.device] > 1:
            per = blocks_per_sm(p.device, p.width)
            if per < 1:
                raise RuntimeError(f"the fenced kernel of width {p.width} "
                                   f"does not fit an SM of device {p.device}")
            taken[p.device] += -(-p.grid // per)
    for dev, need in taken.items():
        if need > sms(dev):
            raise RuntimeError(
                f"{count[dev]} fenced launches need {need} SMs of device "
                f"{dev} at once, which has {sms(dev)}: the barrier would "
                "wait forever")


@functools.cache
def _lib():
    lib = _kernels.load(KERNEL)
    lib.brpc_ring_all_gather.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
        ctypes.c_void_p]
    lib.brpc_ring_all_gather.restype = ctypes.c_int
    lib.brpc_ring_all_gather_xcard.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_ulonglong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_ulonglong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_ulonglong]
    lib.brpc_ring_all_gather_xcard.restype = ctypes.c_int
    lib.brpc_ring_enable_peers.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.brpc_ring_enable_peers.restype = ctypes.c_int
    lib.brpc_ring_barrier_bytes.argtypes = []
    lib.brpc_ring_barrier_bytes.restype = ctypes.c_int
    lib.brpc_ring_xcard_blocks_per_sm.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.brpc_ring_xcard_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _blocks_per_sm(device_index: int, width: int) -> int:
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _lib().brpc_ring_xcard_blocks_per_sm(width, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy of the fenced ring kernel (width "
                           f"{width}) on cuda:{device_index}: cudaError {rc}")
    return blocks.value


def _zeroed_flags(device_index: int) -> torch.Tensor:
    """One participant's flag block on its device, zeroed and settled."""
    flags = torch.zeros(_lib().brpc_ring_barrier_bytes(), dtype=torch.uint8,
                        device=torch.device("cuda", device_index))
    torch.cuda.synchronize(device_index)
    return flags


@functools.cache
def barrier_flags(launches: tuple) -> tuple:
    """The flag blocks of fenced launches made, in launch order, on the
    (CUDA device index, stream handle) pairs `launches` (a device may
    repeat), one a launch, kept for the life of the process: every gather
    on these streams advances their epochs together, and a block is only
    ever used by launches on its one stream, which run one after another.
    Allocated zeroed once per set, with peer access enabled between its
    cards."""
    devices = [d for d, _ in launches]
    if len(set(devices)) > 1:
        enable_peers(tuple(sorted(set(devices))))
    return tuple(_zeroed_flags(d) for d in devices)


def fenced_turns(last: dict, launches: list) -> list:
    """The waits that make fenced gathers take turns on every card, so
    that no two compete for its SMs (a grid that spins on SMs another
    gather's launch needs would never be met).  `launches`: one gather's
    (device index, stream) a launch; `last`: the streams of the previous
    fenced gather's launches on each device.  A launch on a stream of
    `last` already runs after that gather's barrier (the launch before it
    on its stream ended only once every launch of its gather had landed
    its stores); any other launch waits for the first stream of `last` on
    its device.  Returns those (launch index, stream) pairs, for which the
    launch must wait for the work so far on the stream, so a gather
    repeated on its streams waits for nothing.  Sets `last` to this
    gather's launches."""
    mine = collections.defaultdict(list)
    for dev, stream in launches:
        mine[dev].append(stream)
    waits = [(k, last[dev][0]) for k, (dev, stream) in enumerate(launches)
             if last.get(dev) and stream not in last[dev]]
    last.update((dev, tuple(streams)) for dev, streams in mine.items())
    return waits


# The streams of the last fenced gather's launches on each device index
# (fenced_turns), and the lock that keeps each fenced gather's turn and
# launches together when threads gather at once.
_last_fenced: dict = {}
_fenced_lock = threading.Lock()


@functools.cache
def enable_peers(devices: tuple) -> None:
    """Enables peer access between every pair of the CUDA device indices
    `devices` (already enabled is fine).  Raises RuntimeError naming the
    first pair that cannot reach the other: there is no fallback through
    host copies."""
    bad = (ctypes.c_int * 2)()
    rc = _lib().brpc_ring_enable_peers(
        (ctypes.c_int * len(devices))(*devices), len(devices), bad)
    if rc == -1:
        raise RuntimeError(f"cuda:{bad[0]} cannot access cuda:{bad[1]} as a "
                           "peer (cudaDeviceCanAccessPeer is 0); the ring "
                           "kernel needs peer access between every pair")
    if rc != 0:
        raise RuntimeError(f"enabling peer access among {devices} failed: "
                           f"cudaError {rc}")


@functools.lru_cache(maxsize=256)
def _plans(chunk_bytes: int, devs: tuple, src_phases: tuple,
           out_phases: tuple, groups) -> tuple:
    return tuple(plan_launches(chunk_bytes, devs, src_phases, out_phases,
                               _sms, groups))


@functools.lru_cache(maxsize=256)
def _fenced_args(plans: tuple) -> tuple:
    """The per-launch arrays of brpc_ring_all_gather_xcard for `plans`:
    devices, the sources in launch order, their count per launch, widths,
    tiles and grids; RuntimeError (`check_coresident`) when the launches
    cannot all be resident at once."""
    check_coresident(plans, _sms, _blocks_per_sm)
    order = [j for p in plans for j in p.sources]

    def ints(values):
        return (ctypes.c_int * len(values))(*values)

    return (order, ints([p.device for p in plans]), ints(order),
            ints([len(p.sources) for p in plans]),
            ints([p.width for p in plans]),
            (ctypes.c_ulonglong * len(plans))(*(p.tile_bytes for p in plans)),
            ints([p.grid for p in plans]))


def _launch(chunks: list, streams: list, *, groups=None,
            timeout_s: float = BARRIER_TIMEOUT_S) -> list:
    """One launch per launch group (default: per source device), each on
    the stream of the group's first peer, behind an event on the group's
    other peers' streams (their chunks made, their outputs' memory free);
    those streams then wait for the launch.  One launch alone is also
    fenced so against every other peer's stream; several are fenced
    against each other inside the kernel (`barrier_flags`), made by one
    call, and no stream waits on another card's; a launch that does not
    follow the previous fenced gather on its card on its own stream waits
    for that gather there (`fenced_turns`; not inside a CUDA graph
    capture, where a graph that holds fenced gathers on several stream
    sets must order them itself).  Allocates only the outputs (and a
    contiguous copy of a chunk that is not contiguous), each on its
    peer's stream, and never waits for the card."""
    n = len(chunks)
    devs = [c.device.index for c in chunks]
    with span("trpc.k2.alloc"):
        outs, srcs = _on_streams(chunks, streams, _out_shape(chunks))
    chunk_bytes = srcs[0].numel() * srcs[0].element_size()
    with span("trpc.k2.plan"):
        # A plan reads addresses only modulo the bulk width (16): plans
        # are kept by that, so a repeated gather plans once.
        plans = _plans(chunk_bytes, tuple(devs),
                       tuple(t.data_ptr() % _BULK_WIDTH for t in srcs),
                       tuple(t.data_ptr() % _BULK_WIDTH for t in outs),
                       None if groups is None else tuple(groups))
        if plans[0].units == 0:  # empty chunks: nothing to copy
            return outs
        fenced = len(plans) > 1
        launch_streams = [streams[p.sources[0]] for p in plans]
        if fenced:
            flags = barrier_flags(tuple(
                (p.device, s.cuda_stream)
                for p, s in zip(plans, launch_streams)))
            order, *arrays = _fenced_args(plans)
            devices, slots, counts, widths, tiles, grids = arrays
    # Peers whose streams each launch orders with events: the group's
    # (several peers of one card), or every peer for a lone launch.
    others = [list(dict.fromkeys(streams[j]
                                 for j in (p.sources if fenced else range(n))
                                 if streams[j] != s))
              for p, s in zip(plans, launch_streams)]
    with span("trpc.k2.order"):
        for s, group in zip(launch_streams, others):
            for other in group:
                s.wait_event(other.record_event())
    out_ptrs = _ptrs(outs)
    if fenced:
        with _fenced_lock:
            with span("trpc.k2.order"):
                if not torch.cuda.is_current_stream_capturing():
                    ends = {}
                    for k, other in fenced_turns(
                            _last_fenced,
                            [(p.device, s)
                             for p, s in zip(plans, launch_streams)]):
                        if other not in ends:
                            ends[other] = other.record_event()
                        launch_streams[k].wait_event(ends[other])
            with span("trpc.k2.launch"):
                rc = _lib().brpc_ring_all_gather_xcard(
                    len(plans), devices,
                    (ctypes.c_uint64 * len(plans))(
                        *(s.cuda_stream for s in launch_streams)),
                    _ptrs([srcs[j] for j in order]), slots, counts, out_ptrs,
                    n, chunk_bytes, widths, tiles, grids, _ptrs(flags),
                    int(timeout_s * 1e9))
    else:
        (plan,) = plans
        with span("trpc.k2.launch"), torch.cuda.device(plan.device):
            rc = _lib().brpc_ring_all_gather(
                _ptrs(srcs), (ctypes.c_int * n)(*plan.sources), n, out_ptrs,
                n, chunk_bytes, plan.width, plan.tile_bytes, plan.grid,
                launch_streams[0].cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring kernel launch failed: cudaError {rc} "
                           f"({plans})")
    for _ in plans:
        _kernels.count_launch(FENCED_WRAPPER if fenced else WRAPPER)
    for s, group in zip(launch_streams, others):
        if group:
            done = s.record_event()
            for other in group:
                other.wait_event(done)
    return outs


def _on_streams(chunks: list, streams: list, shape: tuple) -> tuple:
    """Each peer's output, and its chunk made contiguous, allocated on its
    own stream (so the caching allocator orders the memory after that
    stream's work), switching a device's current stream only where it
    differs; every device's current stream and the current device are
    restored."""
    current = {d: torch.cuda.current_stream(d)
               for d in {c.device.index for c in chunks}}
    now = dict(current)
    device = torch.cuda.current_device()
    outs, srcs = [], []
    try:
        for c, stream in zip(chunks, streams):
            if now[c.device.index] != stream:
                torch.cuda.set_stream(stream)
                now[c.device.index] = stream
            outs.append(torch.empty(shape, dtype=c.dtype, device=c.device))
            srcs.append(c.contiguous())
    finally:
        if now != current:
            for d, stream in current.items():
                if now[d] != stream:
                    torch.cuda.set_stream(stream)
            torch.cuda.set_device(device)
    return outs, srcs


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_uint64 * len(tensors))(*(t.data_ptr() for t in tensors))
