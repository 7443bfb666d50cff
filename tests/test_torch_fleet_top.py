"""Port parity: brpc_tpu_torch.tools.fleet_top against tools/fleet_top.py
on one naming-backed fleet (three node processes: two of the reference's
`tests/_fleet_node.py`, one the same node over the port).

The merged view is a function of the registry's Naming.Stats records, so
both tools are first held equal on the same records, bit for bit, and
then run as users run them (`--json`) against the live registry.
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

from brpc_tpu_torch.rpc import Channel, Server, get_flag, observe, set_flag
from brpc_tpu_torch.rpc.naming import NamingClient
from brpc_tpu_torch.tools import fleet_top

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "ref_fleet_top", REPO / "tools" / "fleet_top.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

PORT_NODE = (
    "import json, os, sys\n"
    "from brpc_tpu_torch.rpc import Server, observe, set_flag\n"
    "set_flag('trpc_slo_fast_window_ms', os.environ['FLEET_FAST_MS'])\n"
    "set_flag('trpc_slo_slow_window_ms', os.environ['FLEET_SLOW_MS'])\n"
    "set_flag('trpc_naming_lease_ms', os.environ['FLEET_LEASE_MS'])\n"
    "observe.enable_slo(True)\n"
    "observe.enable_fleet_publish(True)\n"
    "srv = Server()\n"
    "srv.register_native_echo('Echo.Echo')\n"
    "srv.set_slo('tenantA:p99_us=2000,avail=99.0;*:p99_us=10000')\n"
    "srv.start(0)\n"
    "srv.announce(os.environ['FLEET_REGISTRY'], 'fleet',\n"
    "             zone=os.environ['FLEET_ZONE'])\n"
    "print(json.dumps({'port': srv.port}), flush=True)\n"
    "sys.stdin.read()\n"
    "srv.stop()\n")
NODES = [("reference", "z0"), ("reference", "z1"), ("port", "z2")]
PER_NODE = (30, 20, 10)


def _env(reg_addr: str, zone: str) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(FLEET_REGISTRY=reg_addr, FLEET_ZONE=zone,
               FLEET_LEASE_MS="400", FLEET_FAST_MS="4000",
               FLEET_SLOW_MS="16000")
    return env


def _spawn(kind: str, reg_addr: str, zone: str):
    argv = ([str(REPO / "tests" / "_fleet_node.py")] if kind == "reference"
            else ["-c", PORT_NODE])
    return subprocess.Popen([sys.executable, *argv],
                            env=_env(reg_addr, zone), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _port_of(proc) -> int:
    deadline = time.time() + 120
    buf = b""
    while b"\n" not in buf:
        left = deadline - time.time()
        if left <= 0 or proc.poll() is not None:
            proc.kill()
            raise AssertionError("fleet node gave no port: " + proc.communicate(
                timeout=10)[1].decode(errors="replace")[-2000:])
        ready, _, _ = select.select([proc.stdout], [], [], min(left, 1.0))
        if ready:
            chunk = os.read(proc.stdout.fileno(), 4096)
            if not chunk:
                continue
            buf += chunk
    return json.loads(buf.split(b"\n")[0])["port"]


@pytest.fixture(scope="module")
def fleet():
    saved = {f: get_flag(f) for f in ("trpc_naming_lease_ms",)}
    set_flag("trpc_naming_lease_ms", "400")
    registry = Server()
    registry.enable_naming_registry()
    registry.start(0)
    reg_addr = f"127.0.0.1:{registry.port}"
    procs = [_spawn(kind, reg_addr, zone) for kind, zone in NODES]
    try:
        ports = [_port_of(p) for p in procs]
        for port, n in zip(ports, PER_NODE):
            ch = Channel(f"127.0.0.1:{port}", timeout_ms=5000,
                         qos_tenant="tenantA")
            for k in range(n):
                assert ch.call("Echo.Echo", b"f" * (64 + k)) == \
                    b"f" * (64 + k)
            ch.close()
        nc = NamingClient(reg_addr)
        deadline = time.time() + 60
        while True:  # until every node's blob covers its traffic
            _, recs = nc.stats("fleet")
            rows = [t for r in recs if r.payload
                    for t in observe.fleet_blob_decode(r.payload)["tenants"]
                    if t["tenant"] == "tenantA"]
            if len(rows) == 3 and sum(r["slow_total"] for r in rows) >= \
                    sum(PER_NODE):
                break
            assert time.time() < deadline, "blobs never covered the traffic"
            time.sleep(0.2)
        nc.close()
        yield reg_addr
    finally:
        for p in procs:
            try:
                p.stdin.close()
                p.wait(timeout=30)
            except Exception:  # noqa: BLE001
                p.kill()
                p.wait(timeout=10)
        registry.stop()
        for f, v in saved.items():
            set_flag(f, v)


class _Frozen:
    """A NamingClient stand-in answering stats() with recorded records."""

    def __init__(self, answer):
        self.answer = answer

    def __call__(self, *_a, **_k):
        return self

    def stats(self, _service):
        return self.answer

    def close(self):
        pass


def test_views_equal_on_the_same_records(fleet, monkeypatch):
    nc = NamingClient(fleet)
    answer = nc.stats("fleet")
    nc.close()
    monkeypatch.setattr(fleet_top, "NamingClient", _Frozen(answer))
    monkeypatch.setattr(ref, "NamingClient", _Frozen(answer))
    got = fleet_top.fleet_view(fleet, "fleet")
    want = ref.fleet_view(fleet, "fleet")
    assert got == want
    assert fleet_top.render(got) == ref.render(want)
    assert len(got["nodes"]) == 3 and all(n["published"]
                                          for n in got["nodes"])
    row = [t for t in got["tenants"] if t["tenant"] == "tenantA"][0]
    assert row["nodes"] == 3 and row["count"] >= sum(PER_NODE)
    assert row["p99_target_us"] == 2000 and row["breached_nodes"] == 0


def test_json_cli_agrees_with_the_reference(fleet):
    outs = {}
    for kind, argv in (("reference", [str(REPO / "tools" / "fleet_top.py")]),
                       ("port", ["-m", "brpc_tpu_torch.tools.fleet_top"])):
        proc = subprocess.run([sys.executable, *argv, fleet, "--service",
                               "fleet", "--json"], cwd=REPO,
                              env=_env(fleet, ""), capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[kind] = json.loads(proc.stdout)
    ref_v, port_v = outs["reference"], outs["port"]
    assert set(port_v) == set(ref_v) == {"service", "version", "nodes",
                                         "tenants"}
    key = lambda n: (n["addr"], n["zone"], n["epoch"], n["published"])
    assert sorted(map(key, port_v["nodes"])) == \
        sorted(map(key, ref_v["nodes"]))
    for a, b in zip(port_v["tenants"], ref_v["tenants"]):
        assert set(a) == set(b)
        for k in ("tenant", "nodes", "breached_nodes", "p99_target_us",
                  "avail_target"):
            assert a[k] == b[k], k
        ratio = max(a["p99_us"], b["p99_us"]) / max(
            min(a["p99_us"], b["p99_us"]), 1)
        assert ratio <= 2.0  # one octave: the digests' own bound


def test_missing_service_is_a_naming_miss(fleet):
    view = fleet_top.fleet_view(fleet, "no-such-service")
    assert view == ref.fleet_view(fleet, "no-such-service")
    assert view["error"] == "naming-miss"
    assert fleet_top.main([fleet, "--service", "no-such-service",
                           "--json"]) == 1
