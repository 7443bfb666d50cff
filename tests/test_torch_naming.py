"""Port parity: brpc_tpu_torch.rpc.naming against brpc_tpu.rpc.naming.

Both packages load the same libtpurpc.so, so one native registry serves
both packages' NamingClients; the registry is process-wide and every test
starts and ends with it empty (`naming.reset()`)."""

import time

import pytest

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import naming as ref_naming
from brpc_tpu_torch.rpc import naming as port_naming

PKGS = {"reference": ref_naming, "port": port_naming}


@pytest.fixture()
def registry():
    port_naming.reset()
    srv = port.Server()
    srv.enable_naming_registry()
    srv.start(0)
    clients = {name: mod.NamingClient(f"127.0.0.1:{srv.port}")
               for name, mod in PKGS.items()}
    yield clients
    for c in clients.values():
        c.close()
    srv.close()
    port_naming.reset()


@pytest.mark.parametrize("args", [
    ("svc", "127.0.0.1:7001", "z1", 2, 17, 3000, 5),
    ("s" * 80, "a" * 80, "zone-name-longer-than-15", 0, 1 << 60, -1, 0),
    ("", "", "", 1, 0, 0, 1 << 63),
])
def test_wire_pack_bytes_equal(args):
    assert port_naming._WIRE.format == ref_naming._WIRE.format
    assert port_naming._WIRE.size == ref_naming._WIRE.size == 176
    assert port_naming._pack(*args) == ref_naming._pack(*args)


def test_unpack_view_equal():
    head = ref_naming._WIRE.pack(b"svc", b"", b"", 2, 0, 0, 0, 9)
    rows = [ref_naming._WIRE.pack(b"svc", b"10.0.0.%d:80" % i, b"z%d" % i,
                                  i + 1, 0, 100 + i, 500 * i, 0)
            for i in range(2)]
    blob = head + b"".join(rows)
    v_ref, m_ref = ref_naming._unpack_view(blob)
    v_port, m_port = port_naming._unpack_view(blob)
    assert v_port == v_ref == 9
    assert [vars(m) for m in m_port] == [vars(m) for m in m_ref]


@pytest.mark.parametrize("announcer", sorted(PKGS))
def test_announce_resolve_watch_withdraw_alike(registry, announcer):
    """One package announces and withdraws; both resolve and watch the
    same view."""
    other = "port" if announcer == "reference" else "reference"
    a, b = registry[announcer], registry[other]
    epoch = a.announce("svc", "127.0.0.1:7001", zone="z1", weight=2)
    views = {name: c.resolve("svc") for name, c in registry.items()}
    version = views["port"][0]
    assert views["reference"][0] == version
    assert ([vars(m) | {"lease_left_ms": 0} for m in views["port"][1]]
            == [vars(m) | {"lease_left_ms": 0}
                for m in views["reference"][1]]
            == [{"addr": "127.0.0.1:7001", "zone": "z1", "weight": 2,
                 "epoch": epoch, "lease_left_ms": 0}])
    # A parked watch on an unchanged version answers the same view late.
    t0 = time.monotonic()
    v2, _ = b.watch("svc", version, park_ms=150)
    assert time.monotonic() - t0 >= 0.1 and v2 == version
    a.announce("svc", "127.0.0.1:7002", epoch=epoch)
    v3, members = b.watch("svc", version, park_ms=5000)
    assert v3 > version and len(members) == 2
    a.withdraw("svc", "127.0.0.1:7002", epoch)
    b.withdraw("svc", "127.0.0.1:7002", epoch)  # idempotent
    assert [m.addr for m in a.resolve("svc")[1]] == \
        [m.addr for m in b.resolve("svc")[1]] == ["127.0.0.1:7001"]
    assert port_naming.local_member_count("svc") == \
        ref_naming.local_member_count("svc") == 1


def test_typed_errors_same_family_and_code(registry):
    epoch = registry["port"].announce("svc", "127.0.0.1:7001")
    got = {}
    for name, c in registry.items():
        mod = PKGS[name]
        with pytest.raises(mod.NamingStaleEpochError) as stale:
            c.announce("svc", "127.0.0.1:7001", epoch=epoch - 1)
        with pytest.raises(mod.NamingMissError) as miss:
            c.resolve("never-announced")
        with pytest.raises(mod.NamingMissError):
            c.stats("never-announced")
        got[name] = (stale.value.code, miss.value.code)
        assert isinstance(stale.value, mod.NamingError)
    assert isinstance(stale.value, port.RpcError)
    assert not isinstance(stale.value, ref.RpcError)
    assert got["port"] == got["reference"] == (2111, 2112)
    assert port_naming._codes() == ref_naming._codes()


def test_publish_and_stats_alike(registry):
    nc = registry["port"]
    epoch = nc.announce("fleet", "127.0.0.1:7101", zone="z9", weight=3)
    nc.announce("fleet", "127.0.0.1:7100", epoch=epoch)
    registry["reference"].publish("fleet", "127.0.0.1:7101", epoch,
                                  b"digest-bytes\x00\xff")
    with pytest.raises(port_naming.NamingMissError):
        nc.publish("fleet", "127.0.0.1:9999", epoch, b"x")
    (v_port, r_port), (v_ref, r_ref) = (
        registry["port"].stats("fleet"), registry["reference"].stats("fleet"))
    assert v_port == v_ref
    strip = [(r.member.addr, r.member.zone, r.member.weight,
              r.member.epoch, r.payload) for r in r_port]
    assert strip == [(r.member.addr, r.member.zone, r.member.weight,
                      r.member.epoch, r.payload) for r in r_ref]
    assert strip[1] == ("127.0.0.1:7101", "z9", 3, epoch,
                        b"digest-bytes\x00\xff")
    assert r_port[0].age_ms == -1 and r_port[1].age_ms >= 0


def test_mint_epoch_and_reset(registry):
    e1 = port_naming.mint_epoch()
    e2 = ref_naming.mint_epoch()
    assert 0 < e1 <= e2 <= port_naming.mint_epoch()
    registry["reference"].announce("gone", "127.0.0.1:1")
    assert port_naming.local_member_count("gone") == 1
    port_naming.reset()
    assert ref_naming.local_member_count("gone") == 0
