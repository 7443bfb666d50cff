"""Paged KV-block registry client — block-addressed KV-cache transfer;
port of brpc_tpu/rpc/kv.py (the wire structs are this module's own copies).

Tensors at the boundary, where the reference takes Python buffers:

- `publish` serves bytes that lie in an `RmaBuffer` (the native store
  checks this).  A CUDA tensor enters only by being copied into the
  buffer's tensor view (`pages.tensor[a:b].copy_(t.view(torch.uint8))`)
  with the stream synchronised before `publish`; from then on the store
  serves those pages zero-copy.  A CUDA tensor passed to `publish` raises
  TypeError.
- `content_hash` and `prefix_publish` take bytes, buffers or tensors: a
  tensor's contiguous uint8 bytes, with one D2H copy for a CUDA tensor.
- A landing buffer (`fetch(..., resp_buf=)`) is an `RmaBuffer` (the
  one-sided path), a contiguous uint8 CPU tensor or a writable buffer —
  the rule of `batch._landing_bytes`, which the copy-path degradation
  writes through as well.

The Python surface of cpp/net/kvstore.h (fabric-lib's abstraction,
arXiv 2510.27656): KV blocks are addressed by BLOCK ID through a
registry record {node, rkey, offset, len, generation}, never by
connection.  A prefill node `publish()`es blocks out of an `RmaBuffer`
(the store serves their bytes zero-copy from the registered pages) and
registers them; a decode node's `KvClient` looks blocks up (cached,
generation-checked), fetches them from the owning node, and can land
them ONE-SIDED in its own `RmaBuffer` via the direct-landing path
(`fetch(..., resp_buf=...)`) — zero receiver-side copies over shm/ici,
transparent striped-copy degradation over TCP.

Cache-coherence contract: a cached lookup is used until a fetch proves
it stale — the owning node validates generation AND lease at serve time
and answers kv-stale (KvStaleError) on any mismatch, which invalidates
the cached record, re-resolves it through the registry once, and
retries.  A lease that expires while a fetch is in flight therefore
never admits stale bytes; a chunk fault fails the call whole (the
landing buffer is never partially complete).

Typical prefill side::

    srv = Server(); srv.enable_kv_store(); srv.enable_kv_registry()
    srv.start(0)
    pages = RmaBuffer(64 << 20)
    ...fill pages.view...
    meta = kv.publish(1001, pages, length=4 << 20,
                      node=f"127.0.0.1:{srv.port}")
    reg = kv.KvRegistryClient(Channel(f"127.0.0.1:{srv.port}"))
    reg.register(meta)

Typical decode side::

    cli = kv.KvClient(registry_addr, use_shm=True)
    land = RmaBuffer(4 << 20)
    n = cli.fetch(1001, resp_buf=land.view)   # one-sided landing
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np
import torch

from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.batch import _landing_bytes
from brpc_tpu_torch.rpc.client import Channel, RpcError

# Wire form shared by every Kv RPC — MUST mirror cpp/net/kvstore.h
# KvWire (kv-wire marker: fixed little-endian, 112 bytes).
_WIRE = struct.Struct("<QQQQQq64s")
assert _WIRE.size == 112

# Prefix-cache wire form — MUST mirror cpp/net/kvstore.h KvPrefixWire
# (kv-wire marker: fixed little-endian, 144 bytes): key hi/lo, hash
# hi/lo, generation, rkey, off, len, lease_ms, depth, flags, node.
_PREFIX_WIRE = struct.Struct("<QQQQQQQQqII64s")
assert _PREFIX_WIRE.size == 144

FETCH_METHOD = "Kv.Fetch"
REGISTER_METHOD = "KvReg.Register"
LOOKUP_METHOD = "KvReg.Lookup"
EVICT_METHOD = "KvReg.Evict"
RENEW_METHOD = "KvReg.Renew"
PREFIX_PUT_METHOD = "KvReg.PutPrefix"
PREFIX_MATCH_METHOD = "KvReg.Match"
PREFIX_FETCH_METHOD = "Kv.FetchPrefix"


class KvError(RpcError):
    """Base of the kv error family (codes 2101..2103)."""


class KvMissError(KvError):
    """Block unknown (never registered, or lease expired and pruned)."""


class KvStaleError(KvError):
    """The caller's record is outdated — generation bumped, lease
    lapsed, or block evicted.  Cached lookups must invalidate."""


class KvExistsError(KvError):
    """Double-register of a live block (ownership is exclusive while
    the lease holds)."""


def _codes() -> tuple[int, int, int]:
    lib = load_library()
    miss = ctypes.c_int()
    stale = ctypes.c_int()
    exists = ctypes.c_int()
    lib.trpc_kv_codes(ctypes.byref(miss), ctypes.byref(stale),
                      ctypes.byref(exists))
    return miss.value, stale.value, exists.value


def _kv_error(e: RpcError) -> RpcError:
    miss, stale, exists = _codes()
    cls = {miss: KvMissError, stale: KvStaleError,
           exists: KvExistsError}.get(e.code)
    return cls(e.code, e.text) if cls is not None else e


@dataclasses.dataclass
class KvBlockMeta:
    """One registry record: where block_id's bytes live right now."""

    block_id: int
    generation: int
    rkey: int
    off: int
    length: int
    node: str = ""
    lease_left_ms: int = 0

    def pack(self, lease_ms: int = 0) -> bytes:
        return _WIRE.pack(self.block_id, self.generation, self.rkey,
                          self.off, self.length, lease_ms,
                          self.node.encode()[:63])

    @classmethod
    def unpack(cls, data: bytes) -> "KvBlockMeta":
        bid, gen, rkey, off, length, lease, node = _WIRE.unpack_from(data)
        return cls(bid, gen, rkey, off, length,
                   node.split(b"\0", 1)[0].decode(errors="replace"), lease)


def _req(block_id: int, generation: int = 0, lease_ms: int = 0) -> bytes:
    return _WIRE.pack(block_id, generation, 0, 0, 0, lease_ms, b"")


def _region(buffer) -> tuple[int, int]:
    """(address, nbytes) of the bytes a block is published from: an
    RmaBuffer, a contiguous CPU tensor (a view of one) or a writable
    buffer.  A CUDA tensor raises: its pages cannot be served."""
    if hasattr(buffer, "address"):
        return buffer.address, buffer.nbytes
    if isinstance(buffer, torch.Tensor):
        if buffer.device.type != "cpu":
            raise TypeError(
                f"cannot publish a {buffer.device} tensor: copy it into an "
                "RmaBuffer's tensor view, synchronise, and publish the "
                "RmaBuffer")
        if not buffer.is_contiguous():
            raise ValueError("publish needs a contiguous tensor")
        return buffer.data_ptr(), buffer.numel() * buffer.element_size()
    view = (ctypes.c_char * 0).from_buffer(buffer)
    return ctypes.addressof(view), len(memoryview(buffer).cast("B"))


def _byte_span(data) -> tuple[int, int, object]:
    """(address, nbytes, owner) of the bytes to hash or copy: a tensor's
    contiguous uint8 bytes (one D2H copy for a CUDA tensor, none for a
    contiguous CPU one), else `bytes(data)`.  Keep `owner` alive while the
    address is used."""
    if isinstance(data, torch.Tensor):
        t = data.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous().reshape(-1).view(torch.uint8)
        return t.data_ptr(), t.numel(), t
    buf = bytes(data)
    return (ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value,
            len(buf), buf)


def publish(block_id: int, buffer, offset: int = 0, length: int | None = None,
            lease_ms: int = 0, node: str = "",
            min_generation: int = 0) -> KvBlockMeta:
    """Publishes `length` bytes at `offset` of an RmaBuffer into this
    process's block store (native, zero-copy serving) and returns the
    registry-ready record.  lease_ms <= 0 uses the trpc_kv_lease_ms
    default.  Raises KvExistsError while the block is live.
    min_generation floors the minted generation — a hot-restart
    successor (fresh pid) passes the predecessor's last registry
    generation + 1 so its takeover re-publish outranks every cached
    record (drain flow, cpp/net/naming.h)."""
    base, size = _region(buffer)
    if length is None:
        length = size - offset
    if offset < 0 or length <= 0 or offset + length > size:
        raise ValueError(f"bad block range: off={offset} len={length} "
                         f"of {size}")
    lib = load_library()
    gen = ctypes.c_uint64()
    rkey = ctypes.c_uint64()
    off = ctypes.c_uint64()
    rc = lib.trpc_kv_publish_ex(
        ctypes.c_void_p(base + offset), ctypes.c_size_t(length),
        ctypes.c_uint64(block_id), ctypes.c_int64(lease_ms),
        ctypes.c_uint64(min_generation),
        ctypes.byref(gen), ctypes.byref(rkey), ctypes.byref(off))
    if rc != 0:
        miss, stale, exists = _codes()
        if rc == exists:
            raise KvExistsError(rc, f"block {block_id} is live")
        raise MemoryError(
            f"kv publish failed (rc={rc}): the bytes must lie inside an "
            "RmaBuffer and fit trpc_kv_store_bytes")
    return KvBlockMeta(block_id, gen.value, rkey.value, off.value, length,
                       node)


def withdraw(block_id: int) -> None:
    """Evicts a local block (its generation tombstones, so stale fetches
    stay detectable).  Raises KvMissError if unknown."""
    rc = load_library().trpc_kv_withdraw(ctypes.c_uint64(block_id))
    if rc != 0:
        raise KvMissError(rc, f"block {block_id} not in the local store")


def renew(block_id: int, lease_ms: int = 0) -> None:
    """Extends a local block's lease."""
    rc = load_library().trpc_kv_renew(ctypes.c_uint64(block_id),
                                      ctypes.c_int64(lease_ms))
    if rc != 0:
        raise KvMissError(rc, f"block {block_id} not in the local store")


def store_count() -> int:
    return int(load_library().trpc_kv_store_count())


def store_bytes_used() -> int:
    return int(load_library().trpc_kv_store_bytes_used())


def registry_count() -> int:
    return int(load_library().trpc_kv_registry_count())


def reset() -> None:
    """Test support: drops every local block and registry record."""
    load_library().trpc_kv_reset()


# ---- content-addressed prefix cache --------------------------------------


@dataclasses.dataclass
class KvPrefixMeta:
    """One prefix-block replica record: chain key (where in the trie),
    content hash (what bytes), and where this replica lives."""

    key_hi: int
    key_lo: int
    hash_hi: int
    hash_lo: int
    generation: int
    rkey: int = 0
    off: int = 0
    length: int = 0
    depth: int = 0
    node: str = ""
    lease_left_ms: int = 0
    flags: int = 0  # bit 0: replica currently cold (tier telemetry)

    @property
    def key(self) -> tuple[int, int]:
        return self.key_hi, self.key_lo

    @property
    def hash(self) -> tuple[int, int]:
        return self.hash_hi, self.hash_lo

    def pack(self, lease_ms: int = 0) -> bytes:
        return _PREFIX_WIRE.pack(self.key_hi, self.key_lo, self.hash_hi,
                                 self.hash_lo, self.generation, self.rkey,
                                 self.off, self.length, lease_ms,
                                 self.depth, self.flags,
                                 self.node.encode()[:63])

    @classmethod
    def unpack(cls, data: bytes, offset: int = 0) -> "KvPrefixMeta":
        (khi, klo, hhi, hlo, gen, rkey, off, length, lease, depth, flags,
         node) = _PREFIX_WIRE.unpack_from(data, offset)
        return cls(khi, klo, hhi, hlo, gen, rkey, off, length, depth,
                   node.split(b"\0", 1)[0].decode(errors="replace"),
                   lease, flags)


def _token_array(tokens):
    toks = list(tokens)
    return (ctypes.c_uint64 * max(len(toks), 1))(*toks), len(toks)


def content_hash(data, tokens=()) -> tuple[int, int]:
    """128-bit content hash of (block bytes, token-id span) — identical
    inputs hash identically in every process (the fleet dedup key)."""
    lib = load_library()
    addr, nbytes, _owner = _byte_span(data)
    tok_arr, ntok = _token_array(tokens)
    hi = ctypes.c_uint64()
    lo = ctypes.c_uint64()
    lib.trpc_kv_content_hash(
        ctypes.c_void_p(addr), ctypes.c_size_t(nbytes), tok_arr,
        ctypes.c_size_t(ntok), ctypes.byref(hi), ctypes.byref(lo))
    return hi.value, lo.value


def prefix_chain(tokens, block_tokens: int = 0) -> list[tuple[int, int]]:
    """Chain keys for a token-id sequence: key_i names the WHOLE prefix
    through block i, so longest-prefix match is a walk until first miss.
    Only FULL block_tokens-sized blocks produce keys (the partial tail is
    never cacheable).  block_tokens <= 0 uses trpc_kv_prefix_block_tokens
    — every node must agree on it for keys to dedup."""
    lib = load_library()
    tok_arr, ntok = _token_array(tokens)
    if ntok == 0:
        return []
    keys = (ctypes.c_uint64 * (2 * ntok))()
    wrote = lib.trpc_kv_prefix_chain(tok_arr, ctypes.c_size_t(ntok),
                                     ctypes.c_int64(block_tokens), keys,
                                     ctypes.c_size_t(ntok))
    return [(keys[2 * i], keys[2 * i + 1]) for i in range(int(wrote))]


def prefix_publish(key: tuple[int, int], depth: int, data, tokens,
                   lease_ms: int = 0, node: str = "",
                   min_generation: int = 0) -> tuple[KvPrefixMeta, bool]:
    """Publishes one prefix block into the local two-tier store under its
    content hash (bytes are COPIED into store-owned registered pages —
    any buffer works, no RmaBuffer needed).  Returns (meta, fresh):
    fresh=False is the cache-hit path — identical content was already
    live, the lease renewed, and NO bytes were admitted (the caller's
    bytes-not-recomputed accounting)."""
    lib = load_library()
    addr, nbytes, _owner = _byte_span(data)
    if not nbytes:
        raise ValueError("empty prefix block")
    tok_arr, ntok = _token_array(tokens)
    hash_hi = ctypes.c_uint64()
    hash_lo = ctypes.c_uint64()
    gen = ctypes.c_uint64()
    rkey = ctypes.c_uint64()
    off = ctypes.c_uint64()
    rc = lib.trpc_kv_prefix_publish(
        ctypes.c_uint64(key[0]), ctypes.c_uint64(key[1]),
        ctypes.c_uint32(depth),
        ctypes.c_void_p(addr), ctypes.c_size_t(nbytes), tok_arr,
        ctypes.c_size_t(ntok), ctypes.c_int64(lease_ms),
        ctypes.c_uint64(min_generation),
        ctypes.byref(hash_hi), ctypes.byref(hash_lo), ctypes.byref(gen),
        ctypes.byref(rkey), ctypes.byref(off))
    _miss, _stale, exists = _codes()
    if rc != 0 and rc != exists:
        raise MemoryError(
            f"kv prefix publish failed (rc={rc}): the block must fit "
            "trpc_kv_store_bytes")
    meta = KvPrefixMeta(key[0], key[1], hash_hi.value, hash_lo.value,
                        gen.value, rkey.value, off.value, nbytes, depth,
                        node)
    return meta, rc == 0


def prefix_withdraw(hash_key: tuple[int, int]) -> None:
    """Evicts a local prefix block by content hash (tombstoned)."""
    rc = load_library().trpc_kv_prefix_withdraw(
        ctypes.c_uint64(hash_key[0]), ctypes.c_uint64(hash_key[1]))
    if rc != 0:
        raise KvMissError(rc, "prefix block not in the local store")


def prefix_store_count() -> int:
    return int(load_library().trpc_kv_prefix_store_count())


def prefix_hot_bytes() -> int:
    return int(load_library().trpc_kv_prefix_hot_bytes())


def prefix_cold_bytes() -> int:
    return int(load_library().trpc_kv_prefix_cold_bytes())


def prefix_registry_count() -> int:
    return int(load_library().trpc_kv_prefix_registry_count())


def prefix_registry_replicas() -> int:
    return int(load_library().trpc_kv_prefix_registry_replicas())


def prefix_counters() -> dict[str, int]:
    """Prefix-tier outcome counters since process start (promote,
    demote, hot_hits, cold_hits, dedup)."""
    lib = load_library()
    vals = [ctypes.c_uint64() for _ in range(5)]
    lib.trpc_kv_prefix_counters(*[ctypes.byref(v) for v in vals])
    return dict(zip(("promote", "demote", "hot_hits", "cold_hits",
                     "dedup"), (v.value for v in vals)))


class KvRegistryClient:
    """Thin RPC client for the registry methods over one channel."""

    def __init__(self, channel: Channel, owns_channel: bool = False):
        self._ch = channel
        self._owns = owns_channel

    def register(self, meta: KvBlockMeta, lease_ms: int = 0) -> int:
        """Records meta under a lease; returns the accepted generation.
        Raises KvExistsError while a live record holds the block."""
        try:
            resp = self._ch.call(REGISTER_METHOD, meta.pack(lease_ms))
        except RpcError as e:
            raise _kv_error(e) from None
        return struct.unpack("<Q", resp)[0]

    def lookup(self, block_id: int) -> KvBlockMeta:
        try:
            resp = self._ch.call(LOOKUP_METHOD, _req(block_id))
        except RpcError as e:
            raise _kv_error(e) from None
        return KvBlockMeta.unpack(resp)

    def evict(self, block_id: int) -> int:
        """Removes the record; returns the evicted generation."""
        try:
            resp = self._ch.call(EVICT_METHOD, _req(block_id))
        except RpcError as e:
            raise _kv_error(e) from None
        return struct.unpack("<Q", resp)[0]

    def renew(self, block_id: int, lease_ms: int = 0) -> int:
        """Extends a live record's lease; returns its generation."""
        try:
            resp = self._ch.call(RENEW_METHOD,
                                 _req(block_id, lease_ms=lease_ms))
        except RpcError as e:
            raise _kv_error(e) from None
        return struct.unpack("<Q", resp)[0]

    def put_prefix(self, meta: KvPrefixMeta,
                   lease_ms: int = 0) -> tuple[int, bool]:
        """Records one prefix-block replica; N publishers of the same
        chain key + content hash fold into ONE record with a replica
        set.  Returns (generation, fresh): fresh=False means the
        registry already held this exact replica and only renewed its
        lease (the idempotent re-offer every cache hit makes)."""
        try:
            resp = self._ch.call(PREFIX_PUT_METHOD, meta.pack(lease_ms))
        except RpcError as e:
            e = _kv_error(e)
            if isinstance(e, KvExistsError):
                return meta.generation, False
            raise e from None
        return struct.unpack("<Q", resp)[0], True

    def match(self, keys) -> list[KvPrefixMeta]:
        """Longest cached prefix: one replica record per live replica of
        every matched chain key, grouped in chain order (the walk stops
        at the first key with no live replica).  Empty list = nothing
        cached."""
        keys = list(keys)
        if not keys:
            return []
        req = struct.pack("<Q", len(keys)) + b"".join(
            struct.pack("<QQ", hi, lo) for hi, lo in keys)
        try:
            resp = self._ch.call(PREFIX_MATCH_METHOD, req)
        except RpcError as e:
            raise _kv_error(e) from None
        (count,) = struct.unpack_from("<Q", resp)
        return [KvPrefixMeta.unpack(resp, 8 + i * _PREFIX_WIRE.size)
                for i in range(count)]

    def close(self) -> None:
        if self._owns:
            self._ch.close()


class KvClient:
    """Decode-side client: registry lookups cached with generation-
    checked invalidation, per-node channel pool, one-sided landings.

    `fetch(block_id)` returns the bytes; `fetch(block_id, resp_buf=v)`
    lands them natively in `v` (an RmaBuffer view for the one-sided
    path) and returns the landed length.  A kv-stale answer invalidates
    the cached record, re-resolves, and retries once."""

    def __init__(self, registry_addr: str, use_shm: bool = True,
                 timeout_ms: int = 30000, qos_tenant: str = "",
                 qos_priority: int = 0, naming_addr: str | None = None,
                 naming_service: str = "kv"):
        self._use_shm = use_shm
        self._timeout_ms = timeout_ms
        self._qos = (qos_tenant, qos_priority)
        self._reg_ch = Channel(registry_addr, timeout_ms=timeout_ms,
                               qos_tenant=qos_tenant,
                               qos_priority=qos_priority)
        self.registry = KvRegistryClient(self._reg_ch)
        self._node_chs: dict[str, Channel] = {}
        self._cache: dict[int, KvBlockMeta] = {}
        # Optional cluster-membership view (cpp/net/naming.h registry at
        # naming_addr, service naming_service): when a fetch fails at the
        # TRANSPORT level and the cached node has left the fleet (drained
        # or died), the dead channel is dropped and the record re-resolves
        # through the registry instead of retrying a dead pid.
        self._naming = None
        self._naming_args = (naming_addr, naming_service)
        #: Lookup-cache telemetry (reads served without a registry RPC /
        #: registry round-trips / stale-triggered invalidations).
        self.cache_hits = 0
        self.cache_misses = 0
        self.invalidations = 0
        #: Fetches re-routed because the naming view said the cached
        #: node is gone (drain/crash re-resolution telemetry).
        self.node_reresolves = 0
        #: Pooled node channels dropped because their node left the
        #: naming view (the pool must not grow with membership churn).
        self.channels_evicted = 0

    #: Pool size at which creating a NEW node channel first prunes
    #: channels whose nodes left the naming view — bounds the pool to
    #: (live members + a little churn slack) instead of every node that
    #: ever served a block.
    _POOL_PRUNE_AT = 4

    def _prune_gone_channels(self) -> None:
        """Evicts pooled channels for nodes absent from the naming view
        (one resolve for the whole sweep; no view configured or registry
        unreachable = no verdict, keep everything)."""
        naming_addr, service = self._naming_args
        if naming_addr is None:
            return
        if self._naming is None:
            from brpc_tpu_torch.rpc import naming as _naming

            self._naming = _naming.NamingClient(naming_addr,
                                                timeout_ms=self._timeout_ms)
        try:
            _version, members = self._naming.resolve(service)
        except RpcError:
            return
        live = {m.addr for m in members}
        for node in [n for n in self._node_chs if n not in live]:
            self._node_chs.pop(node).close()
            self.channels_evicted += 1

    def _node_channel(self, node: str) -> Channel:
        ch = self._node_chs.get(node)
        if ch is None:
            if len(self._node_chs) >= self._POOL_PRUNE_AT:
                # The pool is about to grow past the prune threshold:
                # drop channels for departed nodes first so membership
                # churn can't grow it unboundedly.
                self._prune_gone_channels()
            tenant, prio = self._qos
            # shm rings are single-connection by construction; TCP block
            # pulls spread over pooled sockets (stripe rails).
            ch = Channel(node, timeout_ms=self._timeout_ms,
                         use_shm=self._use_shm,
                         connection_type="single" if self._use_shm
                         else "pooled",
                         qos_tenant=tenant, qos_priority=prio)
            self._node_chs[node] = ch
        return ch

    def lookup(self, block_id: int, refresh: bool = False) -> KvBlockMeta:
        if not refresh:
            meta = self._cache.get(block_id)
            if meta is not None:
                self.cache_hits += 1
                return meta
        self.cache_misses += 1
        meta = self.registry.lookup(block_id)
        self._cache[block_id] = meta
        return meta

    def invalidate(self, block_id: int) -> None:
        if self._cache.pop(block_id, None) is not None:
            self.invalidations += 1

    def _node_gone(self, node: str) -> bool:
        """True when the naming view is configured AND `node` is not a
        member of it (the owner drained or died — its withdrawn/expired
        announcement is the authoritative 'do not retry this pid')."""
        naming_addr, service = self._naming_args
        if naming_addr is None:
            return False
        if self._naming is None:
            from brpc_tpu_torch.rpc import naming as _naming

            self._naming = _naming.NamingClient(naming_addr,
                                                timeout_ms=self._timeout_ms)
        try:
            _version, members = self._naming.resolve(service)
        except RpcError:
            return False  # registry unreachable: no verdict, keep the node
        return all(m.addr != node for m in members)

    def fetch(self, block_id: int, resp_buf=None):
        """Bytes of block_id (or the landed length with resp_buf)."""
        last: RpcError | None = None
        # With a naming view a third attempt is budgeted: transport-dead
        # node -> drop channel + re-resolve -> fetch the re-published
        # block from its new owner.
        attempts = 3 if self._naming_args[0] is not None else 2
        for attempt in range(attempts):
            meta = self.lookup(block_id, refresh=attempt > 0)
            req = _req(block_id, generation=meta.generation)
            ch = self._node_channel(meta.node)
            try:
                if resp_buf is None:
                    return ch.call(FETCH_METHOD, req,
                                   timeout_ms=self._timeout_ms)
                return self._fetch_into(ch, req, resp_buf)
            except RpcError as e:
                e = _kv_error(e)
                if isinstance(e, (KvStaleError, KvMissError)):
                    last = e
                    self.invalidate(block_id)  # generation-checked
                    continue
                # Transport/chaos failure: the record MAY be fine — but
                # if the naming view says the owner left the fleet, the
                # dead channel must not be retried (it would only time
                # out again): drop it and re-resolve through the
                # registry, which the new owner re-publishes into.
                if attempt + 1 < attempts and self._node_gone(meta.node):
                    dead = self._node_chs.pop(meta.node, None)
                    if dead is not None:
                        dead.close()
                    self.invalidate(block_id)
                    self.node_reresolves += 1
                    last = e
                    continue
                raise
        raise last

    def _fetch_into(self, ch: Channel, req: bytes, resp_buf) -> int:
        """One fetch whose response lands natively in resp_buf (the
        one-sided direct path when resp_buf is RmaBuffer-backed and the
        node connection is shm/ici)."""
        pipe = ch.pipeline()
        try:
            pipe.submit(FETCH_METHOD, [req], resp_bufs=[resp_buf],
                        timeout_ms=self._timeout_ms)
            cs = pipe.poll(max_n=1, timeout_ms=self._timeout_ms)
            if not cs:
                raise RpcError(-1, "kv fetch timed out in poll")
            c = cs[0]
            if not c.ok:
                raise _kv_error(RpcError(c.status, c.error))
            if not c.in_caller_buffer and c.data is not None:
                # Copy-path degradation where the runtime returned a
                # view instead of landing in place (tiny responses).
                _landing_bytes(resp_buf)[:c.resp_len] = np.frombuffer(
                    c.data.view(), dtype=np.uint8, count=c.resp_len)
                c.data.release()
            return c.resp_len
        finally:
            pipe.close()

    # ---- content-addressed prefix cache ----

    def match_prefix(self, tokens,
                     block_tokens: int = 0) -> list[list[KvPrefixMeta]]:
        """Longest cached prefix for `tokens`: replica groups in chain
        order (groups[i] = every live replica of prefix block i).  An
        empty list means nothing is cached — full recompute."""
        keys = prefix_chain(tokens, block_tokens)
        if not keys:
            return []
        records = self.registry.match(keys)
        groups: list[list[KvPrefixMeta]] = []
        cur = None
        for r in records:
            if r.key != cur:
                groups.append([])
                cur = r.key
            groups[-1].append(r)
        return groups

    @staticmethod
    def prefix_hint(groups: list[list[KvPrefixMeta]]) -> str:
        """The routing hint for this prompt: the node holding the
        DEEPEST matched block ("host:port", "" when nothing matched).
        Pass it to ClusterChannel.call(..., hint=...) so decode/prefill
        traffic lands where the cache already is — unless bounded load
        vetoes."""
        return groups[-1][0].node if groups else ""

    def fetch_prefix(self, tokens, block_tokens: int = 0) -> list[bytes]:
        """Fetches every cached prefix block for `tokens` in chain
        order, failing over across replicas: a replica that answers
        stale/faulted serves nothing (whole-or-nothing per block) and
        the next replica is tried.  The returned list may be shorter
        than the match when every replica of a block fails — the
        cacheable prefix simply ends there (callers recompute the
        rest)."""
        blocks: list[bytes] = []
        for group in self.match_prefix(tokens, block_tokens):
            data = None
            for rep in group:
                ch = self._node_channel(rep.node)
                try:
                    data = ch.call(PREFIX_FETCH_METHOD, rep.pack(),
                                   timeout_ms=self._timeout_ms)
                    break
                except RpcError:
                    # Stale, chunk-faulted, or dead replica: the block
                    # is never admitted partially — try the next one.
                    continue
            if data is None:
                break
            blocks.append(data)
        return blocks

    def close(self) -> None:
        for ch in self._node_chs.values():
            ch.close()
        self._node_chs.clear()
        if self._naming is not None:
            self._naming.close()
            self._naming = None
        self._reg_ch.close()
