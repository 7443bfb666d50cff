"""Port parity: brpc_tpu_torch.tools.{traffic_replay,make_golden_capture}
against tools/{traffic_replay,make_golden_capture}.py, on the CPU.

- The reference's golden capture (tests/data/golden_mixed.cap) is
  replayed through both packages' replay tools against one native server:
  every record is re-sent, tenant by tenant, by both.
- A capture recorded by the port's make_golden_capture (a cut window, to
  a temporary path) loads in the reference's `load_capture`.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from brpc_tpu.rpc import capture as ref_capture
from brpc_tpu_torch.rpc import Server
from brpc_tpu_torch.rpc import capture as cap
from brpc_tpu_torch.tools import make_golden_capture, traffic_replay

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "golden_mixed.cap"
TOOLS = {"reference": [str(REPO / "tools" / "traffic_replay.py")],
         "port": ["-m", "brpc_tpu_torch.tools.traffic_replay"]}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def server():
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    yield f"127.0.0.1:{srv.port}"
    srv.stop()


def _replay_all(addr: str) -> dict:
    """Both tools' replays, at once (one wall clock), to their reports."""
    procs = {k: subprocess.Popen(
        [sys.executable, *tool, "--addr", addr, "--capture", str(GOLDEN),
         "--workers", "2", "--time-scale", "2.0"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for k, tool in TOOLS.items()}
    got = {}
    for kind, p in procs.items():
        try:
            out, err = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        assert p.returncode == 0, (kind, err[-3000:])
        got[kind] = json.loads(out.strip().splitlines()[-1])
    return got


def test_golden_capture_replays_record_for_record_in_both(server):
    header, records = cap.load_capture(str(GOLDEN))
    per_tenant: dict = {}
    for r in records:
        per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) + 1
    got = _replay_all(server)
    for kind, res in got.items():
        assert res["mode"] == "exact" and res["worker_failures"] == 0, kind
        assert res["capture"]["records"] == len(records), kind
        assert {t: v["sent"] for t, v in res["tenants"].items()} == \
            per_tenant, kind
    ref, port = got["reference"], got["port"]
    assert set(port) == set(ref)
    for tenant in per_tenant:
        assert set(port["tenants"][tenant]) == set(ref["tenants"][tenant])
        for key in ("recorded_rate_rps", "recorded_p99_us",
                    "target_rate_rps"):
            assert port["tenants"][tenant][key] == \
                ref["tenants"][tenant][key], (tenant, key)


def test_schedules_equal_the_reference_tool(server):
    """The exact and fitted schedules are the reference's, record for
    record, for each worker of two."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_traffic_replay", REPO / "tools" / "traffic_replay.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    header, records = cap.load_capture(str(GOLDEN))
    _, ref_records = ref.load_capture(str(GOLDEN))
    for index in range(2):
        got = traffic_replay.exact_schedule(records, index, 2, 1.5)
        want = ref.exact_schedule(ref_records, index, 2, 1.5)
        assert [(o, r.trace_id) for o, r in got] == \
            [(o, r.trace_id) for o, r in want]
        got = traffic_replay.stat_schedule(header, records, index, 2, 2.0,
                                           1.0, 7)
        want = ref.stat_schedule(header, ref_records, index, 2, 2.0, 1.0, 7)
        assert [(o, r.tenant, r.request_bytes) for o, r in got] == \
            [(o, r.tenant, r.request_bytes) for o, r in want]


def test_port_capture_loads_in_the_reference(tmp_path):
    out = tmp_path / "golden_cut.cap"
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.tools.make_golden_capture",
         "--out", str(out), "--seconds", "1.0"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout[proc.stdout.index("{"):])
    header, records = ref_capture.load_capture(str(out))
    assert len(records) == summary["records"] >= 125
    assert {r.tenant for r in records} == {"fg", "bulk"}
    assert set(summary["tenants"]) == {"fg", "bulk"}
    assert "summary" in header
    # The port reads its own file the same way.
    _, mine = cap.load_capture(str(out))
    assert [r.trace_id for r in mine] == [r.trace_id for r in records]


def test_make_golden_capture_never_writes_the_reference_file():
    before = GOLDEN.read_bytes()
    with pytest.raises(SystemExit):
        make_golden_capture.main(["--out", str(GOLDEN)])
    assert GOLDEN.read_bytes() == before
    assert make_golden_capture.DEFAULT_OUT == REPO / "build" / \
        "golden_mixed.cap"
