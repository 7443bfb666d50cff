"""Combo channels — declarative scatter/gather over fabric collectives.
Port of brpc_tpu/channels/combo.py.

- ``ParallelChannel`` (parallel_channel.h:202) fans one request out to every
  peer with a ``CallMapper`` and merges the replies with a
  ``ResponseMerger``, here a collective (all_gather / psum / pmax).
- ``PartitionChannel`` (partition_channel.h:75) shards the request; the
  partitioning IS the input spec.
- ``SelectiveChannel`` (selective_channel.h:52) routes to ONE peer chosen at
  call time; the reply is where-selected and psum'd back.
- ``DynamicPartitionChannel`` (partition_channel.h:136) splits traffic
  across coexisting partition schemes by capacity.

Handlers are SPMD functions ``handler(peer_index, request_shard) ->
response_shard``; each peer runs in its own thread of the fabric and sees
only its shard, as under shard_map, and `peer_index` is a 0-dim int32
tensor.
"""

from __future__ import annotations

from typing import Callable

import torch

from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import Fabric, P, bits, tree_map

__all__ = ["ParallelChannel", "PartitionChannel", "SelectiveChannel",
           "DynamicPartitionChannel"]

Handler = Callable  # handler(peer_index, request) -> response


class _MergerLib:
    """Named response mergers (ResponseMerger parity)."""

    @staticmethod
    def get(name_or_fn, axis):
        if callable(name_or_fn):
            return lambda r: name_or_fn(r, axis)
        table = {
            "gather": lambda r: coll.all_gather(r, axis, tiled=False),
            "concat": lambda r: coll.all_gather(r, axis, tiled=True),
            "sum": lambda r: coll.psum(r, axis),
            "max": lambda r: coll.pmax(r, axis),
            "min": lambda r: coll.pmin(r, axis),
            "none": lambda r: r,  # keep responses sharded
        }
        return table[name_or_fn]


class _BoundCache:
    """bind() results memoized per handler, so repeated call()s reuse one
    bound program and `bind(h) is bind(h)` (the reference's jit cache keys
    on function identity).  Bounded: the oldest half is dropped past `kMax`
    entries, so stale handlers (and what they close over) cannot pile up.
    """

    kMax = 64

    def __init__(self):
        self._cache: dict = {}

    def get_or_build(self, handler, make):
        fn = self._cache.get(handler)
        if fn is None:
            if len(self._cache) >= self.kMax:
                for key in list(self._cache)[: self.kMax // 2]:
                    del self._cache[key]
            fn = self._cache[handler] = make()
        return fn


class ParallelChannel:
    """Fan a replicated request out to every peer on `axis`; merge replies.

    `out_spec` describes the merged response's global layout; it defaults to
    replicated for the named mergers and MUST be given for a callable merger
    that keeps its result sharded (e.g. a psum_scatter merger).
    """

    def __init__(self, fabric: Fabric, axis: str = "link",
                 call_mapper: Callable | None = None,
                 response_merger="gather", out_spec=None):
        self.fabric = fabric
        self.axis = axis
        self.call_mapper = call_mapper
        self.response_merger = response_merger
        if out_spec is None:
            out_spec = P(axis) if response_merger == "none" else P()
        self.out_spec = out_spec
        self._bound = _BoundCache()

    def bind(self, handler: Handler):
        """`handler` behind this channel; returns request -> merged."""
        axis = self.axis
        merge = _MergerLib.get(self.response_merger, axis)
        mapper = self.call_mapper

        def build():
            def spmd(request):
                i = coll.axis_index(axis)
                sub = mapper(i, request) if mapper is not None else request
                return merge(handler(i, sub))

            return self.fabric.spmd(spmd, in_specs=P(),
                                    out_specs=self.out_spec)

        return self._bound.get_or_build(handler, build)

    def call(self, handler: Handler, request):
        return self.bind(handler)(request)


class PartitionChannel:
    """Shard the request along its leading dim across peers on `axis`."""

    def __init__(self, fabric: Fabric, axis: str = "link",
                 response_merger="concat", out_spec=None):
        self.fabric = fabric
        self.axis = axis
        self.response_merger = response_merger
        if out_spec is None:
            out_spec = P(axis) if response_merger == "none" else P()
        self.out_spec = out_spec
        self._bound = _BoundCache()

    def bind(self, handler: Handler):
        axis = self.axis
        merge = _MergerLib.get(self.response_merger, axis)

        def build():
            def spmd(request):
                i = coll.axis_index(axis)
                return merge(handler(i, request))

            return self.fabric.spmd(spmd, in_specs=P(axis),
                                    out_specs=self.out_spec)

        return self._bound.get_or_build(handler, build)

    def call(self, handler: Handler, request):
        return self.bind(handler)(request)


class SelectiveChannel:
    """Route each request to ONE peer chosen at call time.

    The host-side balancer (`brpc_tpu_torch.channels.balancer`) plays the
    role of the LB inside selective_channel.cpp.  Handlers may return
    pytrees; every leaf is where-selected and psum'd back.
    """

    def __init__(self, fabric: Fabric, axis: str = "link"):
        self.fabric = fabric
        self.axis = axis
        self._bound = _BoundCache()

    def bind(self, handler: Handler):
        axis = self.axis

        def build():
            def spmd(request, chosen):
                i = coll.axis_index(axis)
                resp = handler(i, request)
                # where-select, not mask-multiply: a non-chosen peer
                # emitting inf/nan must not poison the psum (0 * inf = nan).
                picked = tree_map(
                    lambda t: torch.where(i == chosen[0], bits(t),
                                          torch.zeros_like(bits(t))).view(
                                              t.dtype),
                    resp)
                return coll.psum(picked, axis)

            fn = self.fabric.spmd(spmd, in_specs=(P(), P()), out_specs=P())
            # Made where the fabric takes its inputs (the first peer's
            # device); spmd places each peer's copy on that peer's device.
            device = self.fabric.device
            return lambda request, chosen: fn(
                request, torch.tensor([chosen], dtype=torch.int32,
                                      device=device))

        return self._bound.get_or_build(handler, build)

    def call(self, handler: Handler, request, chosen: int):
        return self.bind(handler)(request, chosen)


class DynamicPartitionChannel:
    """Traffic split across COEXISTING partitioning schemes.

    During a resharding migration both the old N-way and the new M-way
    partition groups serve, each receiving traffic proportional to its
    capacity, so the fleet migrates without a flag day.  Each scheme is a
    PartitionChannel over its own fabric; calls are routed host-side by
    capacity weights (default: the scheme's partition count), which can be
    re-weighted live.
    """

    def __init__(self, schemes, weights=None, seed: int = 0):
        """schemes: list of PartitionChannel; weights: per-scheme capacity
        (defaults to each scheme's partition count)."""
        if not schemes:
            raise ValueError("need at least one partition scheme")
        self.schemes = list(schemes)
        if weights is None:
            weights = [s.fabric.axis_size(s.axis) for s in self.schemes]
        self.set_weights(weights)
        self._counts = [0] * len(self.schemes)
        self._seq = seed

    def set_weights(self, weights):
        """Live re-weighting (e.g. drain the old scheme to 0)."""
        if len(weights) != len(self.schemes) or any(w < 0 for w in weights):
            raise ValueError("one non-negative weight per scheme")
        if sum(weights) <= 0:
            raise ValueError("at least one scheme must have weight > 0")
        self.weights = list(weights)

    def _pick(self) -> int:
        # Deterministic low-discrepancy rotation (no RNG in the data path):
        # scheme i gets weight_i of every sum(weights) consecutive calls.
        total = sum(self.weights)
        tick = self._seq % total
        self._seq += 1
        for i, w in enumerate(self.weights):
            tick -= w
            if tick < 0:
                return i
        return len(self.weights) - 1

    def call(self, handler: Handler, request):
        """Routes one request to a scheme; returns (scheme_index, result).
        `request` must be shaped for ANY scheme (leading dim divisible by
        every scheme's partition count)."""
        i = self._pick()
        self._counts[i] += 1
        return i, self.schemes[i].call(handler, request)

    @property
    def counts(self):
        """Requests served per scheme (migration progress observability)."""
        return tuple(self._counts)
