"""Port parity: brpc_tpu_torch.rpc.capture against brpc_tpu.rpc.capture.

The record layout and the capture-file format must round-trip between the
packages in both directions and with the checked-in golden capture.  The
capture flag is process-wide: a test that turns it on turns it off and
resets the reservoir before it ends."""

import dataclasses
import pathlib

import pytest

import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import capture as ref_cap
from brpc_tpu_torch.rpc import capture as port_cap

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "golden_mixed.cap"
PKGS = {"reference": ref_cap, "port": port_cap}


def _records(mod, n=24):
    return [mod.CaptureRecord(
        arrival_mono_us=1000 * (n - i), arrival_wall_us=1_700_000_000 + i,
        trace_id=(1 << 63) + i, parent_span_id=i * 7,
        request_bytes=512 * i, response_bytes=3 * i, status=-i % 5,
        queue_us=i, handler_us=2 * i, deadline_budget_us=250_000,
        priority=i % 4, method="Echo.Echo" if i % 3 else "Kv.Fetch",
        tenant=("t%d" % (i % 3)) * (1 + i)) for i in range(n)]


def _as_dicts(records):
    return [dataclasses.asdict(r) for r in records]


def test_constants_equal():
    assert port_cap.FILE_MAGIC == ref_cap.FILE_MAGIC
    assert port_cap.RECORDIO_MAGIC == ref_cap.RECORDIO_MAGIC
    assert port_cap.RECORD_STRUCT.format == ref_cap.RECORD_STRUCT.format
    assert port_cap.RECORD_VERSION == ref_cap.RECORD_VERSION


@pytest.mark.parametrize("i", [0, 1, 5, 23])
def test_pack_and_unpack_bytes_equal(i):
    a, b = _records(port_cap)[i], _records(ref_cap)[i]
    raw = port_cap.pack_record(a)
    assert raw == ref_cap.pack_record(b)
    assert dataclasses.asdict(port_cap.unpack_record(raw)) == \
        dataclasses.asdict(ref_cap.unpack_record(raw))
    # Strings cut at 64 bytes, identically.
    long = dataclasses.replace(a, method="m" * 100, tenant="é" * 40)
    assert port_cap.pack_record(long) == ref_cap.pack_record(
        dataclasses.replace(b, method="m" * 100, tenant="é" * 40))


@pytest.mark.parametrize("bad", [b"", b"\x01" * 10, b"\x02" + b"\x00" * 60])
def test_unpack_errors_alike(bad):
    msgs = {}
    for name, mod in PKGS.items():
        with pytest.raises(ValueError) as ei:
            mod.unpack_record(bad)
        msgs[name] = str(ei.value)
    assert msgs["port"] == msgs["reference"]


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_files_read_by_the_other_package(tmp_path, writer, reader):
    header = {"counters": {"window_sampled": 24}, "note": "x"}
    path = tmp_path / f"{writer}.cap"
    PKGS[writer].save_capture(str(path), header, _records(PKGS[writer]))
    got_h, got = PKGS[reader].load_capture(str(path))
    want_h, want = PKGS[writer].load_capture(str(path))
    assert got_h == want_h == header
    assert _as_dicts(got) == _as_dicts(want)
    assert [r.arrival_mono_us for r in got] == sorted(
        r.arrival_mono_us for r in got)
    bad = tmp_path / "bodies.rec"
    bad.write_bytes(b"TREC\x04\x00\x00\x00ABCD")
    with pytest.raises(ValueError, match="not a capture file"):
        PKGS[reader].load_capture(str(bad))


def test_golden_capture_loads_alike():
    (hp, rp), (hr, rr) = (port_cap.load_capture(str(GOLDEN)),
                          ref_cap.load_capture(str(GOLDEN)))
    assert hp == hr and hp
    assert len(rp) == len(rr) > 0
    assert _as_dicts(rp) == _as_dicts(rr)


def test_native_dump_read_by_both(tmp_path):
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000,
                      qos_tenant="fg", qos_priority=1)
    try:
        port_cap.enable_capture(True)
        port_cap.reset_capture()
        assert port_cap.capture_enabled() and ref_cap.capture_enabled()
        for _ in range(20):
            assert ch.call("Echo.Echo", b"x" * 1024) == b"x" * 1024
        counters = port_cap.counters()
        assert counters == ref_cap.counters()
        assert counters["records"] >= 20
        summary = port_cap.summary(records=5)
        assert summary["enabled"] is True and len(summary["records"]) == 5
        path = tmp_path / "native.cap"
        n = port_cap.dump(str(path))
        (hp, rp), (hr, rr) = (port_cap.load_capture(str(path)),
                              ref_cap.load_capture(str(path)))
        assert n == len(rp) >= 20
        assert hp == hr and _as_dicts(rp) == _as_dicts(rr)
        assert {r.tenant for r in rp} == {"fg"}
        assert all(r.method == "Echo.Echo" and r.request_bytes == 1024
                   for r in rp)
        with pytest.raises(OSError):
            port_cap.dump(str(tmp_path / "missing-dir" / "x.cap"))
    finally:
        port_cap.enable_capture(False)
        port_cap.reset_capture()
        ch.close()
        srv.close()
    assert not ref_cap.capture_enabled()
    assert port.get_flag("trpc_capture") == "false"
