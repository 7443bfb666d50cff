"""The `jax.lax` collectives the data plane uses, for `Fabric.spmd` bodies.

Each is a rendezvous of every peer of the mesh: a peer deposits its value,
waits at the barrier, reads what it needs from the peers of its group (the
peers that share its coordinates off the named axis), and waits again so no
slot is overwritten while another peer still reads it.  Every peer must call
the same collectives in the same order, as under shard_map.

Values are tensors or pytrees of them.  Results are new tensors: a peer
never shares storage with another peer's value.  Reductions run in the
group's peer order, so results are the same on every run; integers wrap as
in XLA (uint32 adds through its int32 bits).
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.parallel.fabric import bits, current, tree_map

__all__ = ["axis_index", "ppermute", "psum", "pmax", "pmin", "all_gather",
           "psum_scatter", "all_to_all", "group_call"]


def _exchange(value, axis) -> tuple[int, list]:
    """Deposits `value`, waits for every peer, and returns (this peer's
    index along `axis`, the values of its group in axis order).  The caller
    must call `_release()` once it has read them."""
    ctx = current()
    run = ctx.run
    run.slots[ctx.rank] = value
    run.barrier.wait()
    group = ctx.fabric.group(ctx.rank, axis)
    return group.index(ctx.rank), [run.slots[r] for r in group]


def _release() -> None:
    current().run.barrier.wait()


def axis_index(axis) -> torch.Tensor:
    """This peer's index along `axis` (a name or a tuple of names), a 0-dim
    int32 tensor on the fabric's device."""
    ctx = current()
    group = ctx.fabric.group(ctx.rank, axis)
    return torch.tensor(group.index(ctx.rank), dtype=torch.int32,
                        device=ctx.fabric.device)


def ppermute(x, axis, perm):
    """Each (src, dst) pair of `perm` moves src's value to dst; a peer that
    is no pair's destination gets zeros."""
    me, vals = _exchange(x, axis)
    src = [s for s, d in perm if d == me]
    if len(src) > 1:
        raise ValueError(f"peer {me} is the destination of {src}")
    if src:
        out = tree_map(lambda t: bits(t).clone().view(t.dtype), vals[src[0]])
    else:
        out = tree_map(lambda t: bits(torch.zeros_like(bits(t))).view(
            t.dtype), x)
    _release()
    return out


def _fold(vals: list, op):
    acc = bits(vals[0]).clone()
    for v in vals[1:]:
        acc = op(acc, bits(v))
    return acc.view(vals[0].dtype)


def _reduce(x, axis, op):
    _, vals = _exchange(x, axis)
    out = tree_map(lambda *leaves: _fold(list(leaves), op), *vals)
    _release()
    return out


def psum(x, axis):
    """Sum over the group, in peer order (integers wrap)."""
    return _reduce(x, axis, torch.add)


def _extreme(x, axis, op):
    _, vals = _exchange(x, axis)

    def fold(*leaves):
        dtype = leaves[0].dtype
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
    _release()
    return out


def pmax(x, axis):
    return _extreme(x, axis, torch.maximum)


def pmin(x, axis):
    return _extreme(x, axis, torch.minimum)


def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    """Every peer's value, stacked along a new dim `axis` (tiled: joined
    along the existing dim `axis`)."""
    _, vals = _exchange(x, axis_name)

    def gather(*leaves):
        parts = [bits(t) for t in leaves]
        joined = (torch.cat(parts, dim=axis) if tiled
                  else torch.stack(parts, dim=axis))
        return joined.view(leaves[0].dtype)

    out = tree_map(gather, *vals)
    _release()
    return out


def psum_scatter(x, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False):
    """The group's sum, of which this peer keeps block `index` along
    `scatter_dimension` (tiled) or the slice `index` of that dim, whose
    size must equal the group's (not tiled)."""
    me, vals = _exchange(x, axis_name)
    n = len(vals)

    def scatter(*leaves):
        total = _fold(list(leaves), torch.add)
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
    _release()
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
            part = bits(t).narrow(split_axis, me * blk, blk)
            blocks.append(part if tiled else part.squeeze(split_axis))
        joined = (torch.cat(blocks, dim=concat_axis) if tiled
                  else torch.stack(blocks, dim=concat_axis))
        return joined.view(leaves[0].dtype)

    out = tree_map(exchange, *vals)
    _release()
    return out


def group_call(x, axis, fn):
    """One call for the whole group: the group's first peer runs
    `fn([value of each peer, in axis order])`, which returns one result
    per peer, and each peer gets its own.  How a kernel that serves every
    peer in one launch (the ring all-gather) enters an spmd body."""
    ctx = current()
    run = ctx.run
    me, vals = _exchange(x, axis)
    group = ctx.fabric.group(ctx.rank, axis)
    _release()  # every peer has read its group; slots may be reused
    if me == 0:  # a raise here aborts the run's barrier (Fabric.spmd)
        results = fn(vals)
        if len(results) != len(group):
            raise ValueError(f"group_call returned {len(results)} results "
                             f"for {len(group)} peers")
        for r, res in zip(group, results):
            run.slots[r] = res
    run.barrier.wait()
    out = run.slots[ctx.rank]
    _release()
    return out
