"""The `jax.lax` collectives the data plane uses, for `Fabric.spmd` bodies.

Each is a rendezvous of every peer of the mesh: a peer deposits its value,
waits at the barrier, reads what it needs from the peers of its group (the
peers that share its coordinates off the named axis), and waits again so no
slot is overwritten while another peer still reads it.  Every peer must call
the same collectives in the same order, as under shard_map.

Values are tensors or pytrees of them.  Results are new tensors on the
reading peer's device: a peer never shares storage with another peer's
value.  Reductions run in the group's peer order, so results are the same
on every run; integers wrap as in XLA (uint32 adds through its int32 bits).

On CUDA every peer runs on a stream of its own (`Fabric.spmd`), so a value
is deposited with an event recorded on its peer's stream, and a reader's
stream waits on that event before it reads.  A value on another device is
copied to the reader's device first (PyTorch orders that copy between the
two devices' current streams).  When the peers leave a collective, each
peer's stream waits on an event recorded after the reads on the stream
of every peer that read its value, so nothing the producer enqueues next
(its allocator handing the memory out again, or a write into it)
overtakes a read.  A peer waits only on the values it reads and the
readers of its own.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.parallel.fabric import bits, current, tree_map

__all__ = ["axis_index", "ppermute", "psum", "pmax", "pmin", "all_gather",
           "psum_scatter", "all_to_all", "group_call"]


def _exchange(value, axis, reads=None) -> tuple[int, list]:
    """Deposits `value`, waits for every peer, and returns (this peer's
    index along `axis`, the values of its group in axis order), with this
    peer's stream behind the values it will read: those at the group
    indices `reads` (default: all).  Read a value's tensors through
    `_local` or `_take`.  The caller must call `_release` once it has
    read them."""
    ctx = current()
    run = ctx.run
    ready = None  # an event on this peer's stream behind what made value
    if ctx.stream is not None:
        ready = ctx.events[0]
        ready.record(ctx.stream)
    run.slots[ctx.rank] = (value, ready)
    run.barrier.wait()
    group = ctx.fabric.group(ctx.rank, axis)
    vals = [run.slots[r][0] for r in group]
    if ctx.stream is not None:
        for i in range(len(group)) if reads is None else reads:
            if group[i] != ctx.rank:
                ctx.stream.wait_event(run.slots[group[i]][1])
    return group.index(ctx.rank), vals


def _release(axis, readers=None) -> None:
    """Waits until every peer has read its group's values, then puts this
    peer's stream behind the reads of its value by the peers at the group
    indices `readers` (default: all)."""
    ctx = current()
    run = ctx.run
    if ctx.stream is not None:
        run.reads[ctx.rank] = ctx.events[1]
        run.reads[ctx.rank].record(ctx.stream)
    run.barrier.wait()
    if ctx.stream is not None:
        group = ctx.fabric.group(ctx.rank, axis)
        for i in range(len(group)) if readers is None else readers:
            if group[i] != ctx.rank:
                ctx.stream.wait_event(run.reads[group[i]])


def _local(t: torch.Tensor) -> torch.Tensor:
    """Another peer's tensor `t`, readable on this peer's stream: `t`
    itself on this peer's device, else a copy on this device."""
    ctx = current()
    if ctx.stream is None or t.device == ctx.device:
        return t
    # The copy runs on this thread's current stream of t's device, and
    # PyTorch fences it with this peer's stream on both sides.
    return bits(t).to(ctx.device, non_blocking=True).view(t.dtype)


def _take(t: torch.Tensor) -> torch.Tensor:
    """A new tensor on this peer's device holding `t`'s bytes."""
    local = _local(t)
    if local is not t:
        return local
    return bits(t).clone().view(t.dtype)


def axis_index(axis) -> torch.Tensor:
    """This peer's index along `axis` (a name or a tuple of names), a 0-dim
    int32 tensor on this peer's device."""
    ctx = current()
    group = ctx.fabric.group(ctx.rank, axis)
    return torch.tensor(group.index(ctx.rank), dtype=torch.int32,
                        device=ctx.device)


def ppermute(x, axis, perm):
    """Each (src, dst) pair of `perm` moves src's value to dst; a peer that
    is no pair's destination gets zeros."""
    ctx = current()
    me = ctx.fabric.group(ctx.rank, axis).index(ctx.rank)
    src = [s for s, d in perm if d == me]
    if len(src) > 1:
        raise ValueError(f"peer {me} is the destination of {src}")
    _, vals = _exchange(x, axis, reads=src)
    if src:
        out = tree_map(_take, vals[src[0]])
    else:
        out = tree_map(lambda t: bits(torch.zeros_like(bits(t))).view(
            t.dtype), x)
    _release(axis, readers=[d for s, d in perm if s == me])
    return out


def _fold(vals: list, op):
    acc = bits(_take(vals[0]))
    for v in vals[1:]:
        acc = op(acc, bits(_local(v)))
    return acc.view(vals[0].dtype)


#: Types that `lax.psum` sums in a wider one on the reference's CPU mesh:
#: bools count as int32, and bf16 accumulates in float32 and rounds once
#: (f16 adds in f16, peer by peer).
_WIDE_SUM = {torch.bool: torch.int32, torch.bfloat16: torch.float32}


def _sum(leaves: list):
    """The group's sum of one leaf, in peer order, as `lax.psum` gives it."""
    wide = _WIDE_SUM.get(leaves[0].dtype)
    if wide is None:
        return _fold(leaves, torch.add)
    acc = _local(leaves[0]).to(wide)
    for t in leaves[1:]:
        acc += _local(t)
    return acc if leaves[0].dtype == torch.bool else acc.to(leaves[0].dtype)


def psum(x, axis):
    """Sum over the group, in peer order (integers wrap)."""
    _, vals = _exchange(x, axis)
    out = tree_map(lambda *leaves: _sum(list(leaves)), *vals)
    _release(axis)
    return out


def _extreme(x, axis, op, beyond, identity: float):
    _, vals = _exchange(x, axis)

    def fold(*leaves):
        leaves = [_local(t) for t in leaves]
        dtype = leaves[0].dtype
        if dtype.is_floating_point:
            # As the reference's all-reduce computes on its CPU mesh: from
            # the identity, a value replaces the running extreme only when
            # strictly beyond it, so a NaN never wins and the first of +0
            # and -0 stays.
            acc = torch.full_like(leaves[0], identity)
            for t in leaves:
                acc = torch.where(beyond(t, acc), t, acc)
            return acc
        if dtype in (torch.uint16, torch.uint32):
            # Compared as int64 values, then narrowed back to the bits.
            wide = [bits(t).to(torch.int64) & ((1 << (8 * t.element_size()))
                                                - 1) for t in leaves]
            acc = wide[0]
            for w in wide[1:]:
                acc = op(acc, w)
            return acc.to(bits(leaves[0]).dtype).view(dtype)
        acc = leaves[0].clone()
        for t in leaves[1:]:
            acc = op(acc, t)
        return acc

    out = tree_map(fold, *vals)
    _release(axis)
    return out


def pmax(x, axis):
    return _extreme(x, axis, torch.maximum, torch.gt, float("-inf"))


def pmin(x, axis):
    return _extreme(x, axis, torch.minimum, torch.lt, float("inf"))


def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    """Every peer's value, stacked along a new dim `axis` (tiled: joined
    along the existing dim `axis`)."""
    _, vals = _exchange(x, axis_name)

    def gather(*leaves):
        parts = [bits(_local(t)) for t in leaves]
        joined = (torch.cat(parts, dim=axis) if tiled
                  else torch.stack(parts, dim=axis))
        return joined.view(leaves[0].dtype)

    out = tree_map(gather, *vals)
    _release(axis_name)
    return out


def psum_scatter(x, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False):
    """The group's sum, of which this peer keeps block `index` along
    `scatter_dimension` (tiled) or the slice `index` of that dim, whose
    size must equal the group's (not tiled)."""
    me, vals = _exchange(x, axis_name)
    n = len(vals)

    def scatter(*leaves):
        total = _sum(list(leaves))
        size = total.shape[scatter_dimension]
        if tiled:
            if size % n:
                raise ValueError(f"dim {scatter_dimension} of size {size} "
                                 f"does not split over {n} peers")
            blk = size // n
            return bits(total).narrow(scatter_dimension, me * blk,
                                      blk).clone().view(total.dtype)
        if size != n:
            raise ValueError(f"dim {scatter_dimension} of size {size} != "
                             f"group size {n}")
        return bits(total).select(scatter_dimension, me).clone().view(
            total.dtype)

    out = tree_map(scatter, *vals)
    _release(axis_name)
    return out


def all_to_all(x, axis_name, split_axis: int, concat_axis: int, *,
               tiled: bool = False):
    """Block j of this peer's value along `split_axis` goes to peer j; each
    peer joins the blocks it receives, in sender order, along
    `concat_axis`.  Not tiled, `split_axis` must have the group's size: it
    is removed, and the blocks stack along a new dim `concat_axis`."""
    me, vals = _exchange(x, axis_name)
    n = len(vals)

    def exchange(*leaves):
        blocks = []
        for t in leaves:
            size = t.shape[split_axis]
            if size % n or (not tiled and size != n):
                raise ValueError(f"split dim {split_axis} of size {size} "
                                 f"does not split over {n} peers")
            blk = size // n
            part = _local(bits(t).narrow(split_axis, me * blk, blk))
            blocks.append(part if tiled else part.squeeze(split_axis))
        joined = (torch.cat(blocks, dim=concat_axis) if tiled
                  else torch.stack(blocks, dim=concat_axis))
        return joined.view(leaves[0].dtype)

    out = tree_map(exchange, *vals)
    _release(axis_name)
    return out


def group_call(x, axis, fn):
    """One call for the whole group: the group's first peer runs
    `fn([value of each peer], [stream of each peer])`, both in axis order
    (the streams None off CUDA), which returns one result per peer, and
    each peer gets its own.  `fn` may read a value on its peer's stream
    only after that stream's work so far (the peers wait at a barrier
    meanwhile) and must make each peer's stream wait for the work that
    reads that peer's value or writes its result; work on the first
    peer's own stream is waited for here.  How a kernel that serves every peer in one launch
    per device (the ring all-gather) enters an spmd body."""
    ctx = current()
    run = ctx.run
    me, vals = _exchange(x, axis, reads=())  # `fn` orders its own reads
    group = ctx.fabric.group(ctx.rank, axis)
    streams = [ctx.fabric.streams[r] if ctx.stream is not None else None
               for r in group]
    # Slots may be reused from here.  No read events: `fn` orders every
    # peer's stream after its reads, and the others read nothing.
    run.barrier.wait()
    if me == 0:  # a raise here aborts the run's barrier (Fabric.spmd)
        results = fn(vals, streams)
        if len(results) != len(group):
            raise ValueError(f"group_call returned {len(results)} results "
                             f"for {len(group)} peers")
        done = ctx.stream.record_event() if ctx.stream is not None else None
        for r, res in zip(group, results):
            run.slots[r] = (res, done)
    run.barrier.wait()
    out, done = run.slots[ctx.rank]
    if done is not None:
        ctx.stream.wait_event(done)
    run.barrier.wait()
    return out
