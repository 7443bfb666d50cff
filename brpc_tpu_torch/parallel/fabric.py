"""Fabric — the peer set of a data-plane domain.  Port of
brpc_tpu/parallel/fabric.py.

The reference's Fabric is an XLA device mesh and `spmd` is shard_map: one
program body runs once per device, sees only its shard, and talks to the
other shards through `jax.lax` collectives.  The port keeps that meaning in
one process: a mesh of N peers, one thread per peer, peer `r` on its own
device `devices[r]` (the GPU unless the caller asks for the CPU).  Peers
may share a card (logical peers) or each hold one (the reference's mesh
over `jax.devices()`); they may not mix device types.  `spmd` splits
global tensors by their specs, places each peer's shard in that peer's
device memory, runs the body once per peer thread, and assembles the
outputs by theirs on the first peer's device.  Inside the body,
`brpc_tpu_torch.parallel.collectives` are the `lax` collectives: each is a
rendezvous of the peers, grouped by mesh axis.

Why threads and not one process per rank: it is the reference's single
controller (one program over the whole mesh); peers that share a card
cannot be NCCL ranks (NCCL refuses two on one GPU, gloo has no send/recv
for CUDA tensors, processes sharing a GPU time-slice rather than overlap);
and a single process reaches every card's memory directly, so no NCCL is
needed.  Why not a stacked "leading peer dim": a handler such as
`lambda i, req: torch.sum(req)` must sum its own shard, as under
shard_map.

Streams: on CUDA each peer enqueues on a stream of its own, which the
fabric keeps for its lifetime.  At entry every peer's stream waits on an
event recorded on the caller's current stream of each peer device; at
exit the caller's current streams wait on every peer's final event, before
the outputs are assembled.  Between, a collective orders the peers'
streams with events (`collectives._exchange`).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["Fabric", "P", "NamedSharding"]


class P:
    """The port's PartitionSpec: one entry per leading tensor dim, each None
    (not split), an axis name, or a tuple of axis names (split over their
    product, major to minor).  Dims past the entries are not split."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __eq__(self, other):
        return isinstance(other, P) and other.parts == self.parts

    def __hash__(self):
        return hash(("P", self.parts))

    def __repr__(self):
        return f"P{self.parts!r}"

    def axes(self, dim: int) -> tuple:
        """The axis names that split `dim` (empty when none)."""
        if dim >= len(self.parts) or self.parts[dim] is None:
            return ()
        part = self.parts[dim]
        return (part,) if isinstance(part, str) else tuple(part)


@dataclass(frozen=True)
class NamedSharding:
    """A fabric and a spec: where a global tensor's shards live."""

    fabric: "Fabric"
    spec: P


# -- pytrees (tuples and lists; tensors and None as leaves) ---------------

def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the same leaves of `rest`)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _map_prefix(spec, tree, fn):
    """fn(leaf, P) over `tree`, where `spec` is a P for the whole subtree or
    a tuple/list of specs matching the tree's structure."""
    if isinstance(spec, P):
        return tree_map(lambda leaf: fn(leaf, spec), tree)
    if len(spec) != len(tree):
        raise ValueError(f"spec {spec!r} does not match {len(tree)} values")
    return type(tree)(_map_prefix(s, t, fn) for s, t in zip(spec, tree))


# -- uint dtypes: torch moves them, but has few kernels for them ----------

_BITS = {torch.uint16: torch.int16, torch.uint32: torch.int32,
         torch.uint64: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    """`t` viewed as the signed integer type of its width when it is an
    unsigned type torch has few kernels for (same bytes, no copy)."""
    other = _BITS.get(t.dtype)
    return t if other is None else t.view(other)


# -- the mesh ---------------------------------------------------------------

class _Run:
    """The rendezvous state of one `spmd` call: a barrier over every peer
    and one slot per peer.  A collective is deposit, barrier, read,
    barrier; a peer that raises aborts the barrier, so the rest raise
    BrokenBarrierError instead of waiting."""

    def __init__(self, n: int, timeout_s: float):
        self.barrier = threading.Barrier(n, timeout=timeout_s)
        self.slots: list = [None] * n
        self.reads: list = [None] * n  # CUDA: an event after each read


_local = threading.local()


@dataclass(frozen=True)
class PeerContext:
    fabric: "Fabric"
    rank: int            # flat index in the mesh (row-major)
    coords: tuple        # one coordinate per axis
    run: _Run
    device: torch.device  # this peer's device
    stream: object        # this peer's torch.cuda.Stream (None off CUDA)
    events: tuple = ()    # this peer's (deposit, read) torch.cuda.Events


def current() -> PeerContext:
    """The calling peer's context; raises outside an spmd body."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("collectives run only inside Fabric.spmd bodies")
    return ctx


def _device(d) -> torch.device:
    """`d` as a torch.device; a CUDA device without an index is the
    current one (device 0 where torch sees no GPU, so a fabric can be
    described, not run, without one)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return d


class Fabric:
    """A mesh of peers, one device each (shared or not), plus helpers to
    place data and run SPMD bodies (the role brpc's NamingService+SocketMap
    pair plays)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices, timeout_s: float = 600.0):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not name "
                             f"every axis of {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        count = math.prod(self.shape.values())
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * count
        #: Peer r's device, by flat (row-major) rank.
        self.devices = tuple(_device(d) for d in devices)
        if len(self.devices) != count:
            raise ValueError(f"mesh shape {tuple(shape)} != device count "
                             f"{len(self.devices)}")
        kinds = sorted({d.type for d in self.devices})
        if len(kinds) > 1:
            raise ValueError(f"the peers of a fabric lie on devices of one "
                             f"type, got {kinds}")
        #: The first peer's device: `put` places global tensors there and
        #: `spmd` assembles its outputs there.
        self.device = self.devices[0]
        #: Seconds a peer waits at a rendezvous before the run fails.
        self.timeout_s = timeout_s
        self._streams: tuple = ()
        self._events: tuple = ()

    # -- construction -----------------------------------------------------
    @classmethod
    def auto(cls, shape: Sequence[int] | None = None,
             axis_names: Sequence[str] = ("link",), devices=None,
             timeout_s: float = 600.0) -> "Fabric":
        """A fabric over the given devices.  `devices` is one device (or
        name) shared by every peer of `shape`; or a sequence with one
        device per peer, row-major over the mesh, repeats allowed (peers
        that share a card); or None: with no shape, one peer on each
        visible CUDA device (the reference's `jax.devices()`), with a
        shape, every peer on the GPU.  None raises without a GPU.  With no
        shape, every peer lies along the last axis (one ring)."""
        from brpc_tpu_torch import resolve_device  # noqa: PLC0415 - cycle

        if devices is None:
            gpu = resolve_device(None)
            devices = (gpu if shape is not None else
                       [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())])
        if isinstance(devices, (str, torch.device)):
            if shape is None:
                raise ValueError("give a mesh shape or one device per peer")
            devices = [devices] * math.prod(shape)
        devices = list(devices)
        if shape is None:
            shape = [1] * (len(axis_names) - 1) + [len(devices)]
        if math.prod(shape) != len(devices):
            raise ValueError(
                f"mesh shape {tuple(shape)} != device count {len(devices)}")
        return cls(shape, axis_names, devices, timeout_s=timeout_s)

    @property
    def streams(self) -> tuple:
        """One CUDA stream per peer, made at first use and kept for the
        fabric's lifetime; empty off CUDA."""
        if not self._streams and self.device.type == "cuda":
            self._streams = tuple(torch.cuda.Stream(device=d)
                                  for d in self.devices)
            # Each peer's (deposit, read) events, recorded again by every
            # collective: a collective's barriers order each record after
            # the waits on the one before (collectives._exchange).
            self._events = tuple((torch.cuda.Event(), torch.cuda.Event())
                                 for _ in self.devices)
        return self._streams

    # -- topology ---------------------------------------------------------
    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def coords(self, rank: int) -> tuple:
        """Mesh coordinates of the peer at flat index `rank` (row-major)."""
        out = []
        for size in reversed(self.shape.values()):
            out.append(rank % size)
            rank //= size
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        rank = 0
        for c, size in zip(coords, self.shape.values()):
            rank = rank * size + c
        return rank

    def group(self, rank: int, axes: Sequence[str]) -> list[int]:
        """Flat ranks of the peers that share `rank`'s coordinates off
        `axes`, ordered by their (row-major) index along `axes`."""
        if isinstance(axes, str):
            axes = (axes,)
        names = self.axis_names
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no mesh axis {a!r} in {names}")
        base = list(self.coords(rank))
        ranks = []
        for flat in range(math.prod(self.shape[a] for a in axes)):
            c = list(base)
            for a in reversed(axes):
                c[names.index(a)] = flat % self.shape[a]
                flat //= self.shape[a]
            ranks.append(self.rank_of(c))
        return ranks

    def _shard_index(self, coords: tuple, axes: tuple) -> tuple[int, int]:
        """(index, count) of a peer's shard along a dim split over axes."""
        idx, count = 0, 1
        for a in axes:
            size = self.shape[a]
            idx = idx * size + coords[self.axis_names.index(a)]
            count *= size
        return idx, count

    # -- placement --------------------------------------------------------
    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self, P(*spec))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self, P())

    def put(self, x, *spec) -> torch.Tensor:
        """`x` as a global tensor on the fabric's device, checked to split
        evenly by P(*spec) (the shards themselves are views, cut by
        `spmd`)."""
        t = torch.as_tensor(x).to(self.device)
        self.shard(t, P(*spec), 0)  # raises when it does not split evenly
        return t

    def shard(self, x: torch.Tensor, spec: P, rank: int) -> torch.Tensor:
        """Peer `rank`'s shard of the global tensor `x`, in that peer's
        device memory: a view where `x` lies there, else a copy (on the
        caller's current streams, which the peers' streams wait on)."""
        if x is None:
            return None
        if len(spec) > x.dim():
            raise ValueError(f"spec {spec!r} has more entries than the "
                             f"{x.dim()}-dim tensor it splits")
        coords = self.coords(rank)
        for dim in range(len(spec)):
            axes = spec.axes(dim)
            if not axes:
                continue
            idx, count = self._shard_index(coords, axes)
            if x.shape[dim] % count:
                raise ValueError(
                    f"dim {dim} of size {x.shape[dim]} does not split "
                    f"evenly over {count} peers of {axes}")
            blk = x.shape[dim] // count
            x = x.narrow(dim, idx * blk, blk)
        if x.device != self.devices[rank]:
            x = bits(x).to(self.devices[rank], non_blocking=True).view(
                x.dtype)
        return x

    def assemble(self, parts: list, spec: P):
        """The global tensor whose shards are `parts` (one per peer) laid
        out by `spec`, on the first peer's device; for P() that is peer
        0's value."""
        first = parts[0]
        if first is None or not any(spec.axes(d) for d in range(len(spec))):
            return first
        if len(spec) > first.dim():
            raise ValueError(f"out spec {spec!r} has more entries than the "
                             f"{first.dim()}-dim output")
        mentioned = {a for d in range(len(spec)) for a in spec.axes(d)}
        shape = list(first.shape)
        for d in range(len(spec)):
            shape[d] *= math.prod(self.shape[a] for a in spec.axes(d))
        out = torch.empty(shape, dtype=first.dtype, device=first.device)
        for rank, part in enumerate(parts):
            coords = self.coords(rank)
            if any(coords[self.axis_names.index(a)] != 0
                   for a in self.axis_names if a not in mentioned):
                continue  # a replica: peer 0's row of those axes stands
            if tuple(part.shape) != tuple(first.shape):
                raise ValueError("peers returned outputs of other shapes")
            view = out
            for d in range(len(spec)):
                axes = spec.axes(d)
                if axes:
                    idx, _ = self._shard_index(coords, axes)
                    view = view.narrow(d, idx * part.shape[d], part.shape[d])
            bits(view).copy_(bits(part))
        return out

    def check_replicas(self, parts: list, spec: P) -> None:
        """Raises ValueError unless the peers' outputs that `spec` declares
        replicas of one another are bit-identical: every peer against the
        peer with its coordinates on the axes `spec` mentions and 0 on the
        others (for P(), every peer against peer 0)."""
        mentioned = {a for d in range(len(spec)) for a in spec.axes(d)}
        names = self.axis_names
        for rank, part in enumerate(parts):
            coords = list(self.coords(rank))
            for i, a in enumerate(names):
                if a not in mentioned:
                    coords[i] = 0
            ref = self.rank_of(coords)
            if ref == rank:
                continue
            want = parts[ref]
            same = (part is None and want is None) or (
                part is not None and want is not None
                and part.dtype == want.dtype
                and tuple(part.shape) == tuple(want.shape)
                and torch.equal(bits(part).to(want.device), bits(want)))
            if not same:
                raise ValueError(
                    f"check_vma: peer {rank}'s output under out spec "
                    f"{spec!r} differs from peer {ref}'s, which it "
                    "replicates")

    # -- SPMD -------------------------------------------------------------
    def spmd(self, fn, in_specs, out_specs, check_vma: bool = False):
        """shard_map over this fabric: returns f(*global_args) that runs
        `fn(*local_args)` once per peer, each in its own thread, and
        assembles the peers' outputs by `out_specs`.

        `in_specs` is a P for every argument or a tuple with one spec per
        argument; `out_specs` a P or a structure matching the outputs.  A
        peer that raises fails the whole call with its error; a rendezvous
        that waits longer than `timeout_s` fails it with TimeoutError.
        With `check_vma` (the reference's shard_map replication check),
        outputs declared replicated along an axis must be bit-identical
        across its peers, or the call raises ValueError."""

        def run(*args):
            if getattr(_local, "ctx", None) is not None:
                raise RuntimeError("Fabric.spmd does not nest")
            specs = (in_specs if isinstance(in_specs, (tuple, list))
                     else (in_specs,) * len(args))
            if len(specs) != len(args):
                raise ValueError(f"{len(specs)} in_specs for {len(args)} "
                                 "arguments")
            n = self.size
            local_args = [
                tuple(_map_prefix(s, a, lambda t, sp, r=rank: self.shard(
                    t, sp, r)) for s, a in zip(specs, args))
                for rank in range(n)]
            outs = self._run_peers(fn, local_args)
            if check_vma:
                _walk_tree(out_specs, outs, self.check_replicas)
            return _assemble_tree(self, out_specs, outs)

        return run

    def _run_peers(self, fn, local_args: list) -> list:
        n = self.size
        run = _Run(n, self.timeout_s)
        outs: list = [None] * n
        errors: list = [None] * n
        cuda = self.device.type == "cuda"
        streams = self.streams if cuda else (None,) * n
        # The caller's current stream of every peer device: the peers
        # start behind what the caller enqueued there (its inputs and the
        # shard copies), and the caller goes on behind every peer.
        callers = ([torch.cuda.current_stream(d)
                    for d in dict.fromkeys(self.devices)] if cuda else [])
        entry = [s.record_event() for s in callers]
        finals: list = [None] * n

        def body(rank):
            dev, stream = self.devices[rank], streams[rank]
            _local.ctx = PeerContext(self, rank, self.coords(rank), run,
                                     dev, stream,
                                     self._events[rank] if cuda else ())
            try:
                if stream is not None:
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        for ev in entry:
                            stream.wait_event(ev)
                        outs[rank] = fn(*local_args[rank])
                        finals[rank] = stream.record_event()
                else:
                    outs[rank] = fn(*local_args[rank])
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                errors[rank] = e
                run.barrier.abort()
            finally:
                _local.ctx = None

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"peer-{r}") for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            # Each rendezvous is bounded by the barrier's timeout; this
            # bounds a peer stuck outside one.
            t.join(self.timeout_s)
            if t.is_alive():
                run.barrier.abort()
                raise TimeoutError(
                    f"{t.name} still running after {self.timeout_s} s")
        for s in callers:
            for ev in finals:
                if ev is not None:
                    s.wait_event(ev)
        first = next((e for e in errors if e is not None and
                      not isinstance(e, threading.BrokenBarrierError)), None)
        if first is None:
            first = next((e for e in errors if e is not None), None)
        if isinstance(first, threading.BrokenBarrierError):
            raise TimeoutError(
                f"a rendezvous waited longer than {self.timeout_s} s") \
                from first
        if first is not None:
            raise first
        return outs


def _walk_tree(spec, outs: list, fn) -> None:
    """Calls fn(parts, leaf_spec) for every output leaf, `parts` holding
    that leaf of each peer's output."""
    if isinstance(spec, P):
        if isinstance(outs[0], (tuple, list)):
            for i in range(len(outs[0])):
                _walk_tree(spec, [o[i] for o in outs], fn)
        else:
            fn(outs, spec)
        return
    if len(spec) != len(outs[0]):
        raise ValueError(f"out_specs {spec!r} do not match "
                         f"{len(outs[0])} outputs")
    for i, s in enumerate(spec):
        _walk_tree(s, [o[i] for o in outs], fn)


def _assemble_tree(fabric: Fabric, spec, outs: list):
    if isinstance(spec, P):
        if isinstance(outs[0], (tuple, list)):
            return tree_map(lambda *leaves: fabric.assemble(list(leaves),
                                                            spec),
                            *outs)
        return fabric.assemble(outs, spec)
    if len(spec) != len(outs[0]):
        raise ValueError(f"out_specs {spec!r} do not match "
                         f"{len(outs[0])} outputs")
    return type(outs[0])(
        _assemble_tree(fabric, s, [o[i] for o in outs])
        for i, s in enumerate(spec))
