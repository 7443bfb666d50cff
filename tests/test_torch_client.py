"""Port parity: the clients of brpc_tpu_torch.rpc (Channel, ClusterChannel,
the typed errors, deadline_scope, QoS tags) and the completed Server against
brpc_tpu.rpc's, both talking to the same native servers.  Mirrors
tests/test_rpc_python.py, test_qos_python.py and test_deadline_python.py.

Both packages load the same libtpurpc.so (each through its own CDLL
object), so flags and the ambient deadline are process-wide: every test
that sets one restores it."""

import ast
import pathlib
import threading
import time

import pytest

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import _lib as ref_lib
from brpc_tpu_torch.rpc import _lib as port_lib
from brpc_tpu_torch.rpc import client as port_client

PKGS = {"reference": ref, "port": port}


def _wait(cond, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.fixture(scope="module")
def server():
    srv = port.Server()
    srv.register("Echo.Echo", lambda call, req: call.respond(req))
    srv.register("Echo.Fail", lambda call, req: call.respond(
        error_code=42, error_text="nope"))
    srv.register("Who.Am", lambda call, req: call.respond(
        f"{call.tenant}:{call.priority}".encode()))
    srv.register_native_echo("Echo.Native")
    srv.start(0)
    yield srv
    srv.close()


class Boom(BaseException):
    """Not an Exception: what a handler raising SystemExit-like errors
    throws at the server thunk."""


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_base_exception_handler_answers_code_13(pkg):
    """A handler raising a BaseException still answers the call with code
    13 (the reference's thunk catches BaseException); before, the port's
    thunk caught only Exception and left the caller waiting out its whole
    timeout."""
    mod = PKGS[pkg]
    srv = mod.Server()

    def boom(call, req):
        raise Boom("handler raised a BaseException")

    srv.register("Boom.Boom", boom)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=10000)
    try:
        t0 = time.monotonic()
        with pytest.raises(port.RpcError) as ei:
            ch.call("Boom.Boom", b"x")
        assert time.monotonic() - t0 < 2.0
        assert ei.value.code == 13 and "Boom" in ei.value.text
    finally:
        ch.close()
        srv.close()


@pytest.mark.parametrize("method", ["Echo.Echo", "Echo.Native"])
@pytest.mark.parametrize("conn", ["single", "pooled", "short"])
def test_sync_call_bytes_equal_reference(server, method, conn):
    addr = f"127.0.0.1:{server.port}"
    payload = bytes(range(256)) * 257
    got = {}
    for name, mod in PKGS.items():
        ch = mod.Channel(addr, timeout_ms=5000, connection_type=conn)
        try:
            got[name] = ch.call(method, payload)
        finally:
            ch.close()
    assert got["port"] == got["reference"] == payload


def test_error_codes_and_classes_match_reference(server):
    addr = f"127.0.0.1:{server.port}"
    errs = {}
    for name, mod in PKGS.items():
        ch = mod.Channel(addr, timeout_ms=5000)
        try:
            with pytest.raises(mod.RpcError) as ei:
                ch.call("Echo.Fail", b"x")
            errs[name] = (type(ei.value).__name__, ei.value.code,
                          ei.value.text)
        finally:
            ch.close()
    assert errs["port"] == errs["reference"] == ("RpcError", 42, "nope")
    assert port_lib.ERROR_CODES == ref_lib.ERROR_CODES
    lib = port.load_library()
    assert port_lib.ERROR_CODES["kEDeadlineExpired"] == \
        lib.trpc_deadline_expired_code()
    assert port_lib.ERROR_CODES["kEOverloaded"] == \
        lib.trpc_qos_overloaded_code()
    assert port_lib.ERROR_CODES["kEDraining"] == lib.trpc_draining_code()


@pytest.mark.parametrize("code,cls", [
    (2005, "OverloadedError"), (2006, "DrainingError"),
    (2007, "DeadlineExpiredError"), (42, "RpcError")])
def test_make_rpc_error_types_like_reference(code, cls):
    from brpc_tpu.rpc.client import make_rpc_error as ref_make

    got = port_client.make_rpc_error(port.load_library(), code, "t")
    want = ref_make(ref.load_library(), code, "t")
    assert type(got).__name__ == type(want).__name__ == cls
    assert isinstance(got, port.RpcError)
    assert (got.code, got.text, str(got)) == (want.code, want.text, str(want))


def test_tenant_tag_roundtrip(server):
    addr = f"127.0.0.1:{server.port}"
    for mod in PKGS.values():
        ch = mod.Channel(addr, timeout_ms=5000, qos_tenant="alice",
                         qos_priority=2)
        try:
            assert ch.call("Who.Am", b"") == b"alice:2"
            ch.set_qos("bob", 1)
            assert ch.call("Who.Am", b"") == b"bob:1"
        finally:
            ch.close()
    untagged = port.Channel(addr, timeout_ms=5000)
    try:
        assert untagged.call("Who.Am", b"") == b":0"
    finally:
        untagged.close()


def _parked(release: threading.Event, holding: list):
    def handler(call, req):
        holding.append(call)
        threading.Thread(target=lambda: (release.wait(10),
                                         call.respond(b"done")),
                         daemon=True).start()
    return handler


def test_overloaded_shed_is_typed_like_reference():
    """A tenant over its limit sheds with OverloadedError (2005) on both
    packages' channels."""
    srv = port.Server()
    release, holding = threading.Event(), []
    srv.register("Hold.Until", _parked(release, holding))
    srv.set_qos("cap:limit=1")
    with pytest.raises(ValueError):
        srv.set_qos("cap:limit=banana")
    srv.start(0)
    addr = f"127.0.0.1:{srv.port}"
    parker = port.Channel(addr, timeout_ms=8000, qos_tenant="cap")
    t = threading.Thread(target=lambda: parker.call("Hold.Until", b""))
    try:
        t.start()
        assert _wait(lambda: len(holding) == 1), "holder never parked"
        shed = {}
        for name, mod in PKGS.items():
            ch = mod.Channel(addr, timeout_ms=3000, qos_tenant="cap")
            try:
                with pytest.raises(mod.OverloadedError) as ei:
                    ch.call("Hold.Until", b"")
                shed[name] = (type(ei.value).__name__, ei.value.code)
            finally:
                ch.close()
        assert shed["port"] == shed["reference"] == ("OverloadedError", 2005)
    finally:
        release.set()
        t.join(timeout=10)
        assert not t.is_alive()
        parker.close()
        srv.close()


def test_draining_error_is_typed_like_reference():
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    addr = f"127.0.0.1:{srv.port}"
    chans = {name: mod.Channel(addr, timeout_ms=1500)
             for name, mod in PKGS.items()}
    try:
        for ch in chans.values():
            assert ch.call("Echo.Echo", b"x") == b"x"  # conn established
        assert not srv.draining
        assert srv.drain(deadline_ms=2000)
        assert srv.draining
        got = {}
        for name, ch in chans.items():
            with pytest.raises(PKGS[name].DrainingError) as ei:
                ch.call("Echo.Echo", b"x")
            got[name] = (type(ei.value).__name__, ei.value.code)
        assert got["port"] == got["reference"] == ("DrainingError", 2006)
    finally:
        for ch in chans.values():
            ch.close()
        srv.close()


def test_deadline_scope_expired_is_typed_like_reference():
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    srv.set_faults("seed=1;svr_delay=1:150")
    addr = f"127.0.0.1:{srv.port}"
    try:
        got = {}
        for name, mod in PKGS.items():
            ch = mod.Channel(addr, timeout_ms=10000)
            try:
                t0 = time.monotonic()
                with mod.deadline_scope(50):
                    with pytest.raises(mod.DeadlineExpiredError) as ei:
                        ch.call("Echo.Echo", b"doomed")
                assert (time.monotonic() - t0) * 1000 < 150
                got[name] = (type(ei.value).__name__, ei.value.code)
            finally:
                ch.close()
        assert got["port"] == got["reference"] == \
            ("DeadlineExpiredError", 2007)
        # An exhausted scope fails fast locally, typed, on the port too.
        ch = port.Channel(addr, timeout_ms=10000)
        try:
            with port.deadline_scope(0.001):
                time.sleep(0.005)
                with pytest.raises(port.DeadlineExpiredError):
                    ch.call("Echo.Echo", b"x")
        finally:
            ch.close()
    finally:
        srv.set_faults("")
        srv.close()
    assert port.load_library().trpc_deadline_ambient_remaining() < 0


def test_nested_deadline_scopes_only_tighten():
    with port.deadline_scope(500) as outer:
        with port.deadline_scope(10_000) as inner:
            assert inner.remaining_us <= 500_000
        assert outer.remaining_us <= 500_000
    assert port.load_library().trpc_deadline_ambient_remaining() < 0


def test_python_handler_reads_remaining_and_cancelled():
    seen = {}
    srv = port.Server()

    def handler(call, data):
        seen["remaining"] = call.remaining_us
        seen["cancelled"] = call.cancelled
        call.respond(data)

    srv.register("Echo.Budget", handler)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=400)
    try:
        assert ch.call("Echo.Budget", b"x") == b"x"
        assert 0 < seen["remaining"] <= 400_000
        assert seen["cancelled"] is False
    finally:
        ch.close()
        srv.close()


def test_cluster_channel_call_and_batch(server):
    url = f"list://127.0.0.1:{server.port}"
    reqs = [f"cluster-{i}".encode() for i in range(12)]
    got = {}
    for name, mod in PKGS.items():
        cc = mod.ClusterChannel(url, "rr", timeout_ms=10000)
        try:
            assert cc.call("Echo.Echo", b"via cluster") == b"via cluster"
            got[name] = cc.call_batch("Echo.Echo", reqs)
        finally:
            cc.close()
    assert got["port"] == got["reference"] == reqs
    with pytest.raises(ValueError):
        port.ClusterChannel("bogus://nowhere", "rr")
    hit, veto, miss = port_client.lb_hint_counters()
    assert all(isinstance(v, int) and v >= 0 for v in (hit, veto, miss))


def test_cluster_hinted_call_counts_like_reference(server):
    """A hint naming the only member is honoured by c_hash_bl; both
    packages read the same process-wide hit counter."""
    from brpc_tpu.rpc.client import lb_hint_counters as ref_counters

    addr = f"127.0.0.1:{server.port}"
    cc = port.ClusterChannel(f"list://{addr}", "c_hash_bl", timeout_ms=5000)
    try:
        before = port_client.lb_hint_counters()
        assert cc.call("Echo.Echo", b"h", hash_key=7, hint=addr) == b"h"
        after = port_client.lb_hint_counters()
        assert sum(after) == sum(before) + 1
        assert after == ref_counters()
    finally:
        cc.close()


def test_channel_latency_recorders_do_not_shadow(server):
    """A reference and a port channel to one address register separate
    rpc_client_<addr> recorders (unique_var_name), counted apart."""
    addr = f"127.0.0.1:{server.port}"
    ref_ch = ref.Channel(addr, timeout_ms=5000)
    port_ch = port.Channel(addr, timeout_ms=5000)
    try:
        assert port_ch.latency.name != ref_ch.latency.name
        for _ in range(3):
            port_ch.call("Echo.Echo", b"1")
        ref_ch.call("Echo.Echo", b"2")
        assert port.observe.Latency.read(port_ch.latency.name).count == 3
        assert ref.observe.Latency.read(ref_ch.latency.name).count == 1
    finally:
        port_ch.close()
        ref_ch.close()


def test_transport_and_bad_options(server):
    addr = f"127.0.0.1:{server.port}"
    ch = port.Channel(addr, timeout_ms=5000, use_shm=True)
    try:
        assert ch.transport == ""
        assert ch.call("Echo.Echo", b"x") == b"x"
        assert ch.transport == "shm_ring"
    finally:
        ch.close()
    with pytest.raises(ValueError):
        port.Channel(addr, connection_type="bogus")


@pytest.mark.parametrize("addr", ["127.0.0.1:80", "localhost:8000",
                                  "127.0.0.1:9/3"])
def test_parse_endpoint_matches_reference(addr):
    assert port.parse_endpoint(addr) == ref.parse_endpoint(addr)


def test_parse_endpoint_rejects_like_reference():
    for mod in PKGS.values():
        with pytest.raises(ValueError):
            mod.parse_endpoint("not an endpoint")


def test_server_switches_and_dumps():
    """The native attachments answer on the port's Server as on the
    reference's: enable_* before start, the SLO/fleet dumps, reuseport
    shards and accept counts, server fault schedules."""
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.enable_kv_store()
    srv.enable_kv_registry()
    srv.enable_collective()
    srv.enable_naming_registry()
    srv.set_slo("tenantA:p99_us=2000,avail=99.9;*:p99_us=10000")
    with pytest.raises(ValueError):
        srv.set_slo("tenantA:p99_us=banana")
    srv.set_reuseport_shards(2)
    with pytest.raises(ValueError):
        srv.set_faults("drop=0.5")  # transport fields are not a server's
    srv.start(0)
    try:
        ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        try:
            assert ch.call("Echo.Echo", b"x") == b"x"
        finally:
            ch.close()
        counts = srv.accept_counts()
        assert len(counts) == 2 and sum(counts) >= 1
        dump = srv.slo_dump()
        assert "tenants" in dump and "enabled" in dump
        blob = srv.fleet_blob()
        assert blob[:8] == b"TRPCFL01"
        decoded = port.observe.fleet_blob_decode(blob)
        want = ref.observe.fleet_blob_decode(blob)
        assert len(decoded["tenants"]) == len(want["tenants"]) == 2
        for got_t, want_t in zip(decoded["tenants"], want["tenants"]):
            assert vars(got_t.pop("digest")) == vars(want_t.pop("digest"))
        assert decoded == want
        with pytest.raises(RuntimeError):
            srv.infer_dump()  # enable_infer() was not called
        assert srv.infer_streams_live() == 0
        srv.set_faults("seed=1;svr_error=1:1234")
        ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        try:
            with pytest.raises(port.RpcError) as ei:
                ch.call("Echo.Echo", b"x")
            assert ei.value.code == 1234
        finally:
            srv.set_faults("")
            ch.close()
    finally:
        srv.close()


def test_announce_without_registry_raises():
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    try:
        with pytest.raises(RuntimeError):
            srv.announce("127.0.0.1:1", "svc")
    finally:
        srv.close()


NOT_PORTED_YET = {"capture", "collective", "kv", "naming"}


def test_export_surface_matches_reference():
    """brpc_tpu_torch.rpc exports every name brpc_tpu/rpc/__init__.py
    imports (but the modules not ported yet), each defined by the port,
    and the observe, fault, tuner, stream, infer and rma modules."""
    tree = ast.parse(pathlib.Path(ref.__file__).read_text())
    names = {a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert "Batch" in names and "capture" in names
    for name in sorted(names - NOT_PORTED_YET) + [
            "observe", "fault", "tuner", "stream", "infer", "rma"]:
        obj = getattr(port, name)
        mod = getattr(obj, "__module__", None) or obj.__name__
        assert mod.startswith("brpc_tpu_torch."), (name, mod)
    for name in NOT_PORTED_YET:
        assert not hasattr(port, name), name


def test_ensure_built_is_idempotent():
    port_lib.ensure_built()
    assert port_lib._LIB_PATH.exists()
    assert port_lib._LIB_PATH.stat().st_mtime >= \
        port_lib._newest_source_mtime()
