"""Fabric — the peer set of a data-plane domain.  Port of
brpc_tpu/parallel/fabric.py.

The reference's Fabric is an XLA device mesh and `spmd` is shard_map: one
program body runs once per device, sees only its shard, and talks to the
other shards through `jax.lax` collectives.  The port keeps that meaning on
one card: a mesh of N *logical peers* in one process, one thread per peer,
every peer's tensors on the same device (the GPU unless the caller asks for
the CPU).  `spmd` splits global tensors by their specs, runs the body once
per peer thread, and assembles the outputs by theirs.  Inside the body,
`brpc_tpu_torch.parallel.collectives` are the `lax` collectives: each is a
rendezvous of the peers, grouped by mesh axis.

Why threads and not one process per rank: the card is one GPU; NCCL
refuses two ranks on one GPU, gloo has no send/recv for CUDA tensors, and
processes sharing a GPU time-slice rather than overlap.  Why not a stacked
"leading peer dim": a handler such as `lambda i, req: torch.sum(req)` must
sum its own shard, as under shard_map.

All peers enqueue on the caller's current stream of the device, so work
stays stream-ordered across a rendezvous without extra synchronisation.
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


_local = threading.local()


@dataclass(frozen=True)
class PeerContext:
    fabric: "Fabric"
    rank: int            # flat index in the mesh (row-major)
    coords: tuple        # one coordinate per axis
    run: _Run


def current() -> PeerContext:
    """The calling peer's context; raises outside an spmd body."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("collectives run only inside Fabric.spmd bodies")
    return ctx


class Fabric:
    """A mesh of logical peers on one device, plus helpers to place data and
    run SPMD bodies (the role brpc's NamingService+SocketMap pair plays)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device, timeout_s: float = 600.0):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not name "
                             f"every axis of {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.device = torch.device(device)
        #: Seconds a peer waits at a rendezvous before the run fails.
        self.timeout_s = timeout_s

    # -- construction -----------------------------------------------------
    @classmethod
    def auto(cls, shape: Sequence[int] | None = None,
             axis_names: Sequence[str] = ("link",), devices=None,
             timeout_s: float = 600.0) -> "Fabric":
        """A fabric of logical peers.  `devices` is one device (or name)
        shared by every peer, or a sequence with one entry per peer, all
        the same device; None is the GPU (raises without one).  With no
        shape, every peer lies along the last axis (one ring)."""
        from brpc_tpu_torch import resolve_device  # noqa: PLC0415 - cycle

        if devices is None or isinstance(devices, (str, torch.device)):
            device = resolve_device(devices)
            if shape is None:
                raise ValueError("give a mesh shape or one device per peer")
            count = math.prod(shape)
        else:
            devices = [torch.device(d) for d in devices]
            if not devices or any(d != devices[0] for d in devices):
                raise ValueError(
                    f"every peer of a fabric lies on one device, got "
                    f"{sorted({str(d) for d in devices})}")
            device, count = devices[0], len(devices)
        if shape is None:
            shape = [1] * (len(axis_names) - 1) + [count]
        if math.prod(shape) != count:
            raise ValueError(
                f"mesh shape {tuple(shape)} != device count {count}")
        return cls(shape, axis_names, device, timeout_s=timeout_s)

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
        """Peer `rank`'s shard of the global tensor `x` (a view)."""
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
        return x

    def assemble(self, parts: list, spec: P):
        """The global tensor whose shards are `parts` (one per peer) laid
        out by `spec`; for P() that is peer 0's value."""
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
                and torch.equal(bits(part), bits(want)))
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

        # Every peer enqueues on the caller's current stream (a thread
        # starts on the default one), so work stays stream-ordered across
        # a rendezvous without extra synchronisation.
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def body(rank):
            _local.ctx = PeerContext(self, rank, self.coords(rank), run)
            try:
                if stream is not None:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(stream):
                        outs[rank] = fn(*local_args[rank])
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
