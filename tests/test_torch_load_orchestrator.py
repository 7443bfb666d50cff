"""brpc_tpu_torch.tools.load_orchestrator (port of
tools/load_orchestrator.py) on the CPU.

The bounded smoke run, at a cut connection count (300, where the
reference's smoke opens up to 2000), meets the reference's smoke
assertions (tests/test_perf_smoke.py::test_load_orchestrator_smoke); the
wire format, the capture-shape reader and the rolling-restart content
recipes equal the reference's.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from brpc_tpu_torch.tools import load_orchestrator as lo

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "ref_load_orchestrator", REPO / "tools" / "load_orchestrator.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
CONNS = 300


def test_smoke_meets_the_reference_smoke_assertions():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.tools.load_orchestrator",
         "--smoke", "--json", "--conns", str(CONNS)],
        cwd=REPO, capture_output=True, text=True, timeout=180, env=env)
    line = next((ln for ln in out.stdout.splitlines()[::-1]
                 if ln.startswith("{")), None)
    assert line, f"no report:\n{out.stdout}\n{out.stderr[-2000:]}"
    report = json.loads(line)
    assert out.returncode == 0, f"orchestrator failed: {report}"
    assert report["wedged"] == 0, report
    assert report["echoed"] == report["connected"] == CONNS, report
    peak = report["server_peak"]
    assert peak["live_sockets"] >= report["connected"], report
    assert peak["rss_kb"] > 0, "socket-map memory must be reported"
    assert sum(peak["accept_counts"]) >= report["connected"], report


@pytest.mark.parametrize("tenant,priority", [(b"", 0), (b"fg", 1),
                                             (b"bulk", 3)])
@pytest.mark.parametrize("size", [0, 1024, 4 << 20])
def test_wire_frames_equal_the_reference(tenant, priority, size):
    payload = b"x" * size
    frame = lo.pack_request(7, "Echo.Echo", payload, tenant, priority)
    assert frame == ref.pack_request(7, "Echo.Echo", payload, tenant,
                                     priority)
    buf = bytearray(frame)
    assert lo.parse_response(buf) == ref.parse_response(buf)
    assert lo.parse_response(bytearray(frame[:10])) is None


def test_capture_shape_equals_the_reference():
    golden = str(REPO / "tests" / "data" / "golden_mixed.cap")
    assert lo.load_shape(golden) == ref.load_shape(golden)


@pytest.mark.parametrize("bid,gen", [(100, 1), (205, 3)])
def test_rolling_restart_recipes_equal_the_reference(bid, gen):
    assert lo._block_bytes(bid, gen, 4096) == ref._block_bytes(bid, gen, 4096)
    assert lo._prefix_tokens(2) == ref._prefix_tokens(2)
    key = (0x1234, 0xDEADBEEF)
    assert lo._prefix_content(key, 1000) == ref._prefix_content(key, 1000)


def test_every_role_spawns_the_port_module():
    src = (REPO / "brpc_tpu_torch" / "tools" /
           "load_orchestrator.py").read_text()
    assert "__file__, " not in src
    assert "Path(__file__).resolve())" not in src
    assert src.count('"-m", MODULE') >= 4
    assert lo.MODULE == "brpc_tpu_torch.tools.load_orchestrator"
