"""Cluster naming-service client — push-based membership from Python; port
of brpc_tpu/rpc/naming.py, host code over the native registry, carried
across as it stands (the wire struct is this module's own copy).

The Python surface of cpp/net/naming.h: any Server can host the registry
(``Server.enable_naming_registry()``); nodes announce ``{addr, zone,
weight, epoch}`` under the same lease semantics as the KV registry
(expired = gone, epoch-checked re-announce — an OLDER epoch is a zombie
and is rejected), and clients either poll ``resolve`` or park a
``watch`` long-poll that answers the moment membership changes.

A ``ClusterChannel("naming://registry_host:port/service", ...)`` wires
all of this in natively: the C++ watch fiber turns registry version
bumps into immediate refreshes, so adds/removals/weight changes apply
without reconnect storms, and a draining node's withdrawal re-balances
traffic before its listener handoff even starts.

Typical node side::

    srv = Server(); srv.register_native_echo()
    srv.start(0)
    srv.announce(f"127.0.0.1:{registry_port}", "echo", zone="z1")

Typical client side::

    ch = ClusterChannel(f"naming://127.0.0.1:{registry_port}/echo",
                        lb="zone_la")

This module is the thin RPC client for tests/tools that need the raw
registry view (the orchestrator's drain assertions, membership dumps).
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import time

from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.client import Channel, RpcError

# Wire form shared by every Naming RPC — MUST mirror cpp/net/naming.h
# NamingWire (naming-wire marker: fixed little-endian, 176 bytes).
_WIRE = struct.Struct("<64s64s16siIQqQ")
assert _WIRE.size == 176

ANNOUNCE_METHOD = "Naming.Announce"
WITHDRAW_METHOD = "Naming.Withdraw"
RESOLVE_METHOD = "Naming.Resolve"
WATCH_METHOD = "Naming.Watch"
PUBLISH_METHOD = "Naming.Publish"
STATS_METHOD = "Naming.Stats"


class NamingError(RpcError):
    """Base of the naming error family (codes 2111..2112)."""


class NamingStaleEpochError(NamingError):
    """The announce/withdraw carried an epoch OLDER than the recorded
    member's — the caller is a zombie predecessor of a restarted node."""


class NamingMissError(NamingError):
    """Unknown service (never announced and nobody watching)."""


def _codes() -> tuple[int, int]:
    lib = load_library()
    stale = ctypes.c_int()
    miss = ctypes.c_int()
    lib.trpc_naming_codes(ctypes.byref(stale), ctypes.byref(miss))
    return stale.value, miss.value


def _naming_error(e: RpcError) -> RpcError:
    stale, miss = _codes()
    cls = {stale: NamingStaleEpochError, miss: NamingMissError}.get(e.code)
    return cls(e.code, e.text) if cls is not None else e


@dataclasses.dataclass
class Member:
    """One member of a named service, as the registry sees it."""

    addr: str
    zone: str = ""
    weight: int = 1
    epoch: int = 0
    lease_left_ms: int = 0


@dataclasses.dataclass
class StatsRecord:
    """One member's stats row (Naming.Stats): membership identity plus
    the opaque publication payload it last attached — for the fleet
    observability plane, a digest-wire 2 blob (observe.fleet_blob_decode
    reads it).  age_ms is how stale the payload is (-1 = never
    published)."""

    member: Member
    age_ms: int = -1
    payload: bytes = b""


def _pack(service: str, addr: str = "", zone: str = "", weight: int = 0,
          epoch: int = 0, lease_ms: int = 0, version: int = 0) -> bytes:
    return _WIRE.pack(service.encode()[:63], addr.encode()[:63],
                      zone.encode()[:15], weight, 0, epoch, lease_ms,
                      version)


def _unpack_view(data: bytes) -> tuple[int, list[Member]]:
    (_svc, _addr, _zone, count, _res, _epoch, _lease,
     version) = _WIRE.unpack_from(data)
    members = []
    for i in range(1, count + 1):
        (_s, addr, zone, weight, _r, epoch, lease,
         _v) = _WIRE.unpack_from(data, i * _WIRE.size)
        members.append(Member(
            addr.split(b"\0", 1)[0].decode(errors="replace"),
            zone.split(b"\0", 1)[0].decode(errors="replace"),
            weight, epoch, lease))
    return version, members


def mint_epoch() -> int:
    """A fresh announce epoch: realtime µs, strictly newer across
    restarts of the same endpoint (what the native Announcer mints)."""
    return time.time_ns() // 1000


class NamingClient:
    """Thin RPC client for the registry methods over one channel."""

    def __init__(self, registry_addr: str, timeout_ms: int = 2000):
        self._ch = Channel(registry_addr, timeout_ms=timeout_ms)
        self._timeout_ms = timeout_ms

    def announce(self, service: str, addr: str, zone: str = "",
                 weight: int = 1, epoch: int = 0, lease_ms: int = 0) -> int:
        """Announces (or renews: same epoch) a member.  Returns the epoch
        used (minted when 0).  Raises NamingStaleEpochError when a newer
        epoch holds the addr (this caller is the zombie)."""
        epoch = epoch or mint_epoch()
        try:
            self._ch.call(ANNOUNCE_METHOD,
                          _pack(service, addr, zone, weight, epoch,
                                lease_ms))
        except RpcError as e:
            raise _naming_error(e) from None
        return epoch

    def withdraw(self, service: str, addr: str, epoch: int) -> None:
        """Removes the member (idempotent — an already-gone member is the
        goal state).  Raises NamingStaleEpochError when a LIVE record
        holds a newer epoch."""
        try:
            self._ch.call(WITHDRAW_METHOD, _pack(service, addr, epoch=epoch))
        except RpcError as e:
            raise _naming_error(e) from None

    def resolve(self, service: str) -> tuple[int, list[Member]]:
        """(version, members) — the poll fallback."""
        try:
            resp = self._ch.call(RESOLVE_METHOD, _pack(service))
        except RpcError as e:
            raise _naming_error(e) from None
        return _unpack_view(resp)

    def watch(self, service: str, version: int = 0,
              park_ms: int = 1000) -> tuple[int, list[Member]]:
        """Long-poll: parks server-side until the membership version
        differs from `version` (or park_ms passes), then answers the
        full view — the push path.  Loop it: ``version, members =
        nc.watch(svc, version)``."""
        try:
            resp = self._ch.call(
                WATCH_METHOD,
                _pack(service, lease_ms=park_ms, version=version),
                timeout_ms=park_ms + self._timeout_ms)
        except RpcError as e:
            raise _naming_error(e) from None
        return _unpack_view(resp)

    def publish(self, service: str, addr: str, epoch: int,
                payload: bytes) -> None:
        """Attaches an opaque stats payload to a LIVE member record —
        the fleet observability publication path (the native Announcer
        does this every renew round under trpc_fleet_publish).  Same
        fencing as announce: the member must exist (lease un-expired,
        NamingMissError otherwise) and `epoch` must be no older than the
        recorded one (NamingStaleEpochError — a zombie predecessor can't
        overwrite its successor's stats).  Payloads die with the member
        and do NOT bump the membership version (watchers stay parked)."""
        try:
            self._ch.call(PUBLISH_METHOD,
                          _pack(service, addr, epoch=epoch) + payload)
        except RpcError as e:
            raise _naming_error(e) from None

    def stats(self, service: str) -> tuple[int, list[StatsRecord]]:
        """(version, records): every live member with its last published
        payload, sorted by addr — what /fleet and tools/fleet_top.py
        merge.  Raises NamingMissError for an unknown service."""
        try:
            resp = self._ch.call(STATS_METHOD, _pack(service))
        except RpcError as e:
            raise _naming_error(e) from None
        (_svc, _addr, _zone, count, _res, _epoch, _lease,
         version) = _WIRE.unpack_from(resp)
        records = []
        pos = _WIRE.size
        for _ in range(max(count, 0)):
            (_s, addr, zone, weight, _r, epoch, age_ms,
             _v) = _WIRE.unpack_from(resp, pos)
            pos += _WIRE.size
            (plen,) = struct.unpack_from("<Q", resp, pos)
            pos += 8
            payload = bytes(resp[pos:pos + plen])
            pos += plen
            records.append(StatsRecord(
                member=Member(
                    addr.split(b"\0", 1)[0].decode(errors="replace"),
                    zone.split(b"\0", 1)[0].decode(errors="replace"),
                    weight, epoch),
                age_ms=age_ms, payload=payload))
        return version, records

    def close(self) -> None:
        self._ch.close()


def local_member_count(service: str) -> int:
    """Members of `service` in THIS process's registry (test support)."""
    return int(load_library().trpc_naming_member_count(service.encode()))


def reset() -> None:
    """Test support: drops every service from the local registry."""
    load_library().trpc_naming_reset()
