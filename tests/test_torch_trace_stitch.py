"""Port parity: brpc_tpu_torch.tools.trace_stitch against tools/trace_stitch.py.

The same dumps — a striped call between this process and a node process
(the reference's `tests/_timeline_node.py`, or the same node over the
port), and a synthetic dump holding every flight-recorder event kind —
go through both stitchers, which must give equal Chrome traces.
"""

import importlib.util
import json
import os
import pathlib
import select
import subprocess
import sys
import time

import pytest

from brpc_tpu_torch.rpc import Channel, observe
from brpc_tpu_torch.tools import trace_stitch

REPO = pathlib.Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location(
    "ref_trace_stitch", REPO / "tools" / "trace_stitch.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

# The reference's node helper, and the same node over the port.
NODES = {
    "reference": [str(REPO / "tests" / "_timeline_node.py")],
    "port": ["-c", (
        "import json, sys\n"
        "from brpc_tpu_torch.rpc import Server, observe\n"
        "observe.enable_rpcz(True)\n"
        "observe.enable_timeline(True)\n"
        "srv = Server()\n"
        "srv.register_native_echo('Echo.Echo')\n"
        "srv.start(0)\n"
        "print(json.dumps({'port': srv.port}), flush=True)\n"
        "sys.stdin.read()\n"
        "srv.stop()\n")],
}


def _spawn_node(kind: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.Popen([sys.executable, *NODES[kind]], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    deadline = time.time() + 60
    buf = b""
    while b"\n" not in buf:
        left = deadline - time.time()
        if left <= 0:
            proc.kill()
            raise AssertionError("node produced no port line")
        ready, _, _ = select.select([proc.stdout], [], [], min(left, 1.0))
        if not ready:
            continue
        chunk = os.read(proc.stdout.fileno(), 4096)
        if not chunk:
            raise AssertionError("node exited early: " + proc.communicate(
                timeout=10)[1].decode(errors="replace"))
        buf += chunk
    return proc, json.loads(buf.split(b"\n")[0])["port"]


def _stop(proc) -> None:
    try:
        proc.stdin.close()
        proc.wait(timeout=10)
    except Exception:  # noqa: BLE001
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture
def recorder():
    observe.enable_rpcz(True)
    observe.enable_timeline(True)
    yield
    observe.enable_timeline(False)
    observe.reset_timeline()
    observe.enable_rpcz(False)


@pytest.mark.parametrize("node_kind", sorted(NODES))
def test_stitch_equal_in_both_packages_on_a_two_process_run(recorder,
                                                             node_kind):
    node, port = _spawn_node(node_kind)
    try:
        ep = f"127.0.0.1:{port}"
        ch = Channel(ep, timeout_ms=60000, connection_type="pooled")
        with observe.trace("stitch-parity") as t:
            assert ch.call("Echo.Echo", b"k" * 1024) == b"k" * 1024
            big = b"s" * (8 << 20)  # above the stripe threshold
            assert ch.call("Echo.Echo", big) == big
        ch.close()
        hexid = f"{t.trace_id:016x}"
        deadline = time.time() + 5
        while True:  # a server submits its span after it responds
            dump_n = trace_stitch.fetch_rpcz(ep, hexid)
            if len(dump_n["spans"]) >= 2 or time.time() > deadline:
                break
            time.sleep(0.02)
        assert len(dump_n["spans"]) >= 2
        # Both packages fetch the same node dump format.
        assert set(ref.fetch_rpcz(ep, hexid)) == set(dump_n)
        dumps = {"client": trace_stitch.local_rpcz(hexid),
                 f"node:{port}": dump_n}
        timelines = {"client": trace_stitch.local_timeline(),
                     f"node:{port}": trace_stitch.fetch_timeline(ep)}
        assert set(ref.local_timeline()) == set(timelines["client"])
    finally:
        _stop(node)

    got = trace_stitch.stitch(dumps, hexid, timelines)
    want = ref.stitch(json.loads(json.dumps(dumps)), hexid,
                      json.loads(json.dumps(timelines)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    xs = [e for e in got["traceEvents"] if e.get("ph") == "X"]
    assert len([e for e in xs if e.get("cat") in ("server", "client")]) >= 3
    assert any(e.get("cat") == "fiber" for e in xs)
    assert got["stitch"]["parent_linked"] >= 2
    assert got["stitch"]["timeline_events"] > 0


def _synthetic():
    """Two nodes' dumps by hand: a cross-node parent/child pair, and a
    timeline holding every event kind the stitcher routes."""
    z = "0" * 16

    def span(sid, parent, side, start, end, node_fid="00000000000000aa"):
        return {"trace_id": "00000000000000t1", "span_id": sid,
                "parent_span_id": parent, "side": side, "method": "M.m",
                "start_us": start, "end_us": end, "fid": node_fid,
                "error_code": 0, "request_bytes": 10, "response_bytes": 20,
                "annotations": [{"ts_us": start + 1, "text": "note"}]}

    a = {"pid": 1, "now_mono_us": 1000, "now_wall_us": 50000,
         "spans": [span("s1", z, "client", 100, 400),
                   span("s3", "nolink", "client", 150, 160)]}
    b = {"pid": 2, "now_mono_us": 7000, "now_wall_us": 57100,
         "spans": [span("s2", "s1", "server", 6180, 6300,
                        "00000000000000bb")]}

    def ev(name, ts, a_="0000000000000001", b_="0000000000000000"):
        return {"name": name, "ts_us": ts, "a": a_, "b": b_,
                "trace_id": "00000000000000t1", "span_id": "s2",
                "fid": "00000000000000bb"}

    kinds = [
        ev("fiber_run", 6190, "f1", "0000000000000003"),
        ev("fiber_park", 6210, "f1"),
        ev("sweep_start", 6200, "k1"), ev("sweep_end", 6205, "k1", "0002"),
        ev("inline_begin", 6206, "k2"), ev("inline_end", 6207, "k2"),
        ev("kv_block", 6220, "0000000000000005",
           f"{(2 << 56) | 4096:016x}"),
        ev("coll_step", 6221, "0000000000000003",
           f"{(1 << 56) | 512:016x}"),
        ev("coll_ready", 6222, "0000000000000001",
           f"{(7 << 32) | 256:016x}"),
        ev("slo_breach", 6223, "00000000deadbeef",
           f"{(1 << 56) | 1500:016x}"),
        ev("token_step", 6224, "0000000000000009",
           f"{(3 << 56) | 4:016x}"),
        ev("tuner_decision", 6225, "00000000cafe0000",
           f"{(8 << 32) | 16:016x}"),
        ev("stripe_send", 6226, "0000000000000001", f"{0xFFFF << 48:016x}"),
        ev("stripe_send", 6227, "0000000000000001",
           f"{(0x8000 | 2) << 48:016x}"),
        ev("stripe_send", 6228, "0000000000000001", f"{3 << 48:016x}"),
        ev("stripe_cut", 6229), ev("stripe_land", 6230),
        ev("stripe_done", 6231),
        ev("qos_drain", 6232, "0000000000000102"),
        ev("fiber_create", 6233),
    ]
    tl = {"pid": 2, "now_mono_us": 7000, "now_wall_us": 57100,
          "threads": [{"tid": 77, "name": "worker", "events": kinds}]}
    only = {"pid": 3, "now_mono_us": 0, "now_wall_us": 0,
            "threads": [{"tid": 5, "events": [ev("fiber_create", 3)]}]}
    return {"A": a, "B": b}, {"B": tl, "C": only}


@pytest.mark.parametrize("trace_id", [None, "00000000000000t1", "other"])
@pytest.mark.parametrize("with_timeline", [False, True])
def test_stitch_equal_in_both_packages_on_synthetic_dumps(trace_id,
                                                          with_timeline):
    dumps, tls = _synthetic()
    tls = tls if with_timeline else None
    got = trace_stitch.stitch(dumps, trace_id, tls)
    want = ref.stitch(*_synthetic()[:1], trace_id,
                      _synthetic()[1] if with_timeline else None)
    assert got == want
    if trace_id is None and with_timeline:
        names = {e["name"] for e in got["traceEvents"]}
        assert {"kv_serve", "coll_all_gather", "coll_ready", "slo_breach",
                "infer_token", "tuner_decision", "sweep",
                "inline-response"} <= names
        assert got["stitch"]["node_offsets_us"]["B"] != 0.0


def test_main_writes_a_stitched_file_of_this_process(tmp_path, recorder):
    out = tmp_path / "trace.json"
    assert trace_stitch.main(["--local", "me", "--timeline",
                              "--out", str(out)]) == 0
    trace = json.loads(out.read_text())
    assert trace["stitch"]["nodes"] == ["me"]
    assert trace["stitch"]["timeline_nodes"] == ["me"]
    with pytest.raises(SystemExit):
        trace_stitch.main([])  # no endpoints and no --local


def test_a_profiler_trace_joins_the_rpcz_spans_on_the_wall_clock(tmp_path):
    """A torch.profiler Chrome trace of this process lands on the clock
    the node's rpcz spans are mapped onto: a host span opened inside an
    rpcz span lies inside it in the stitched file, through `stitch` and
    through `main --profile`."""
    import torch.profiler as tp

    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        with observe.trace("stitch-profile") as t:
            time.sleep(0.02)
            with observe.span("trpc.test.inner"):
                time.sleep(0.005)
            time.sleep(0.02)
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    hexid = f"{t.trace_id:016x}"
    dumps = {"me": trace_stitch.local_rpcz(hexid)}
    profile = json.loads(path.read_text())
    out = tmp_path / "trace.json"
    assert trace_stitch.main(["--local", "me", "--trace-id", hexid,
                              "--profile", str(path),
                              "--out", str(out)]) == 0
    for got in (trace_stitch.stitch(dumps, hexid, profiles={"me": profile}),
                json.loads(out.read_text())):
        (outer,) = [e for e in got["traceEvents"]
                    if e["name"] == "stitch-profile" and e["ph"] == "X"]
        (inner,) = [e for e in got["traceEvents"]
                    if e["name"] == "trpc.test.inner" and e["ph"] == "X"]
        assert outer["ts"] + 10_000 < inner["ts"]
        assert inner["ts"] + inner["dur"] + 10_000 < outer["ts"] + outer["dur"]
        assert inner["pid"] != outer["pid"]  # the profiler's own track
        assert got["stitch"]["profile_events"] > 0
    # Without profiles the summary is the reference's.
    assert "profile_events" not in trace_stitch.stitch(dumps, hexid)["stitch"]
