"""Port parity: brpc_tpu_torch.rpc.flags, .fault and .tuner against
brpc_tpu.rpc's.  Flags, the fault schedule and the tuner are process-wide
in the one native runtime both packages load, so each reading is taken
through both, and every test restores what it sets.  Mirrors
tests/test_tuner_python.py, the fault-binding cases of
tests/test_chaos_python.py and the flag cases of tests/test_rpc_python.py."""

import dataclasses
import json
import urllib.request

import pytest

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import fault as ref_fault
from brpc_tpu.rpc import tuner as ref_tuner
from brpc_tpu_torch.rpc import fault, tuner


@pytest.fixture(scope="module")
def server():
    srv = port.Server()
    srv.register("Echo.Echo", lambda call, req: call.respond(req))
    srv.start(0)
    yield srv
    srv.close()


def test_flags_read_and_write_through_both_packages():
    for name in ("rpcz_enabled", "trpc_rpcz_ring_size", "trpc_qos_lanes",
                 "trpc_deadline_wire"):
        assert port.get_flag(name) == ref.get_flag(name), name
    original = port.get_flag("trpc_rpcz_ring_size")
    try:
        port.set_flag("trpc_rpcz_ring_size", "64")
        assert ref.get_flag("trpc_rpcz_ring_size") == "64"
        ref.set_flag("trpc_rpcz_ring_size", "128")
        assert port.get_flag("trpc_rpcz_ring_size") == "128"
    finally:
        port.set_flag("trpc_rpcz_ring_size", original)


@pytest.mark.parametrize("name,bad", [
    ("rpcz_enabled", "not-a-bool"), ("trpc_rpcz_ring_size", "4"),
    ("trpc_qos_lanes", "1"), ("trpc_qos_lane_weights", "0,1"),
    ("trpc_tuner", "bogus"), ("trpc_tuner_interval_ms", "5"),
    ("trpc_tuner_eval_ticks", "0"), ("trpc_tuner_hysteresis_pct", "95"),
    ("trpc_cluster_retry_budget_pct", "101"),
    ("trpc_infer_batch_max", "0")])
def test_bad_flag_values_rejected_like_reference(name, bad):
    before = port.get_flag(name)
    msgs = []
    for mod in (ref, port):
        with pytest.raises(ValueError) as ei:
            mod.set_flag(name, bad)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert port.get_flag(name) == before


def test_unknown_flag_raises_key_error():
    for mod in (ref, port):
        with pytest.raises(KeyError):
            mod.get_flag("no_such_flag_xyz")
        with pytest.raises(ValueError):
            mod.set_flag("no_such_flag_xyz", "1")


def test_fault_schedule_roundtrip_and_reject(server):
    try:
        fault.set_schedule("seed=21;drop=0.25;peer=127.0.0.1:1")
        assert fault.get_schedule() == ref_fault.get_schedule()
        assert fault.get_schedule().startswith("seed=21")
        for bad in ("dorp=0.5", "svr_error=1:13"):
            with pytest.raises(ValueError):
                fault.set_schedule(bad)
            with pytest.raises(ValueError):
                ref_fault.set_schedule(bad)
    finally:
        fault.set_schedule("")
    assert fault.get_schedule() == ref_fault.get_schedule()


def test_fault_seed_replay_matches_reference(server):
    """One seeded schedule, replayed once through each package's bindings:
    the same injected-fault log and the same call outcomes."""
    port_no = server.port
    spec = f"seed=21;drop=0.25;peer=127.0.0.1:{port_no}"
    logs, outcomes, injected = [], [], []
    try:
        for mod, fmod in ((ref, ref_fault), (port, fault)):
            fmod.set_schedule(spec)  # installing restarts the sequence
            ch = mod.Channel(f"127.0.0.1:{port_no}", timeout_ms=200)
            run = []
            for i in range(12):
                payload = b"replay-%d" % i
                try:
                    assert ch.call("Echo.Echo", payload) == payload
                    run.append("ok")
                except mod.RpcError as e:
                    assert e.code != 0
                    run.append("err")
            ch.close()
            logs.append(fmod.log())
            injected.append(fmod.injected())
            outcomes.append(run)
            fmod.set_schedule("")
    finally:
        fault.set_schedule("")
    assert logs[0], "expected the dice to fire at least once"
    assert logs[0] == logs[1] and outcomes[0] == outcomes[1]
    assert injected[0] == injected[1] == len(logs[0])
    fault.reset()
    assert fault.injected() == ref_fault.injected() == 0


def test_server_fault_points(server):
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=2000)
    try:
        server.set_faults("seed=1;svr_error=1:1234")
        with pytest.raises(port.RpcError) as ei:
            ch.call("Echo.Echo", b"x")
        assert ei.value.code == 1234
        with pytest.raises(ValueError):
            server.set_faults("drop=0.5")
    finally:
        server.set_faults("")
    assert ch.call("Echo.Echo", b"healed") == b"healed"
    ch.close()


@pytest.fixture
def parked_tuner():
    """Tuner attachable with the control loop parked (max interval) so
    nothing ticks behind the test's back; always disabled after."""
    old_interval = port.get_flag("trpc_tuner_interval_ms")
    port.set_flag("trpc_tuner_interval_ms", "3600000")
    try:
        yield
    finally:
        tuner.enable_tuner(False)
        port.set_flag("trpc_tuner_interval_ms", old_interval)


def test_tuner_defaults_off():
    assert port.get_flag("trpc_tuner") == "false"
    assert tuner.tuner_enabled() == ref_tuner.tuner_enabled() is False


def test_tuner_status_counters_and_decisions_match_reference(parked_tuner):
    st = tuner.status()
    assert set(st) >= {"enabled", "interval_ms", "ticks_total",
                       "decisions_total", "reverts_total",
                       "freezes_total", "rules", "inputs", "decisions"}
    assert tuner.counters() == ref_tuner.counters()
    assert set(tuner.counters()) == {"ticks", "decisions", "reverts",
                                     "freezes"}
    assert [dataclasses.asdict(d) for d in tuner.decisions()] == \
        [dataclasses.asdict(d) for d in ref_tuner.decisions()]
    for d in tuner.decisions():
        assert d.action in ("apply", "revert", "freeze")


def test_server_enable_tuner_and_http(server, parked_tuner):
    """The Server attach point flips the controller on for both packages'
    readers; /tuner serves the same body as tuner.status()."""
    server.enable_tuner()
    assert tuner.tuner_enabled() and ref_tuner.tuner_enabled()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/tuner?limit=16",
            timeout=10) as r:
        on = json.loads(r.read().decode())
    assert on["enabled"] is True
    knobs = {rule["knob"] for rule in on["rules"]}
    assert knobs == {rule["knob"] for rule in tuner.status(16)["rules"]}
    assert "trpc_stripe_chunk_bytes" in knobs
    tuner.enable_tuner(False)
    assert not ref_tuner.tuner_enabled()
