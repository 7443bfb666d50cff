"""Port parity: brpc_tpu_torch.tools.bench against bench.py, on the CPU at
small sizes.

- The sweep, device-RPC and zero-copy children of both programs run side
  by side as subprocesses (the reference's under BENCH_FORCE_CPU, the
  port's with `--device cpu`): the same row keys, apart from the relabelled
  timing methods and the device-RPC leg's one staging hop; both round trips
  verified with equal path stamps.
- The echo step the port picks at a size is bit-equal to the one the
  reference picks on its chip (K1's plain version against the Pallas
  kernel in interpret mode from 1 MiB, the roll step below).
- The spawning children run the port's tools with the reference's exact
  arguments (plus `--device` where the port's tool has it).
- The parent, with stubbed children: the reference's keys renamed, a
  missing or failed device row listed under `failed` with exit 1 and the
  line still printed, no child on another device, no run off the GPU
  without `--device cpu`.

The host-only children are held in test_torch_bench_host.py.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models.echo import single_chip_echo_step as jax_echo_step
from brpc_tpu.ops.echo_kernel import echo_fused as jax_echo_fused
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.rpc import Channel, Server, observe
from brpc_tpu_torch.tools import bench as port

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_PATH = REPO / "bench.py"
_spec = importlib.util.spec_from_file_location("bench_reference", REF_PATH)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SMALL_SIZES = "1024,1048576"
CHILD_TIMEOUT_S = 150
# Children of both programs, run at once: name -> (argv, env flags).
CHILDREN = {
    "ref_sweep": ([str(REF_PATH)], {"BENCH_CHILD": "1",
                                    "BENCH_SIZES": SMALL_SIZES,
                                    "BENCH_FORCE_CPU": "1"}),
    "port_sweep": (["-m", port.MODULE, "--device", "cpu"],
                   {"BENCH_CHILD": "1", "BENCH_SIZES": SMALL_SIZES}),
    "ref_rpc": ([str(REF_PATH)], {"BENCH_TPU_RPC": "1",
                                  "BENCH_FORCE_CPU": "1"}),
    "port_rpc": (["-m", port.MODULE, "--device", "cpu"],
                 {"BENCH_DEVICE_RPC": "1"}),
    "ref_zc": ([str(REF_PATH)], {"BENCH_ZC": "1"}),
    "port_zc": (["-m", port.MODULE, "--device", "cpu"], {"BENCH_ZC": "1"}),
}


def _env(flags: dict) -> dict:
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("BENCH_"):
            del env[k]
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(flags)
    return env


@pytest.fixture(scope="module")
def child_rows():
    """Every child of CHILDREN run at once; name -> its JSON rows."""
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=REPO,
                                    env=_env(flags), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, (argv, flags) in CHILDREN.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=CHILD_TIMEOUT_S)
            assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
            out[name] = [json.loads(ln) for ln in stdout.splitlines()
                         if ln.startswith("{")]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    return out


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


# ---------------------------------------------------------- device rows ----

def test_sweep_rows_have_the_reference_keys(child_rows):
    ref_rows = {r["size"]: r for r in child_rows["ref_sweep"]}
    port_rows = {r["size"]: r for r in child_rows["port_sweep"]}
    assert sorted(ref_rows) == sorted(port_rows) == [1024, 1048576]
    for size in ref_rows:
        r, p = ref_rows[size], port_rows[size]
        # sync_fallback: both programs add it only when jitter swamps the
        # two chains' difference.
        assert set(p) - {"sync_fallback"} == set(r) - {"sync_fallback"}, \
            (size, set(p) ^ set(r))
        assert p["platform"] == r["platform"] == "cpu"
        # The timing methods are relabelled: host clock here, CUDA events
        # on the card, where the reference timed tunnel fetches.
        assert p["latency_method"].startswith("host_clock_per_sync_step")
        assert r["latency_method"].startswith("marginal_chain")
        assert p["goodput_gbps"] > 0 and p["p99_us"] >= p["p50_us"] > 0
    # 1 KiB rides the batch pipeline in both, at the same depth.
    assert port_rows[1024]["goodput_method"] == "rpc_call_batch" \
        == ref_rows[1024]["goodput_method"]
    assert port_rows[1024]["pipeline_depth"] == 256 \
        == ref_rows[1024]["pipeline_depth"]
    assert port_rows[1048576]["goodput_method"] == "host_clock_chain"
    assert ref_rows[1048576]["goodput_method"] == "device_chain"


@pytest.mark.parametrize("size", [1 << 10, 1 << 16, 1 << 20])
def test_sweep_step_is_bit_equal_to_the_reference(size):
    """The port's step at `size` (K1 from 1 MiB: its plain version on the
    CPU) against the reference's pick on its chip (the Pallas kernel in
    interpret mode from 1 MiB, the roll step below)."""
    arr = np.random.default_rng(size).integers(
        0, 1 << 32, size=size // 4, dtype=np.uint32)
    if size >= ref.FUSED_MIN_BYTES:
        want_resp, want_sum = jax_echo_fused(jnp.asarray(arr),
                                             interpret=True)
    else:
        want_resp, want_sum = jax_echo_step(jnp.asarray(arr))
    resp, csum = port.pick_step(size)(payload_from_numpy(arr, "cpu"))
    np.testing.assert_array_equal(
        resp.view(torch.int32).numpy().view(np.uint32),
        np.asarray(want_resp))
    assert int(csum.view(torch.int32)) & 0xFFFFFFFF == int(want_sum)


def test_sweep_step_choice_follows_the_reference():
    from brpc_tpu_torch.models.echo import single_chip_echo_step
    from brpc_tpu_torch.ops.echo_kernel import echo_fused

    assert port.FUSED_MIN_BYTES == ref.FUSED_MIN_BYTES
    assert port.SIZES == ref.SIZES
    for size in port.SIZES:
        want = echo_fused if size >= ref.FUSED_MIN_BYTES \
            else single_chip_echo_step
        assert port.pick_step(size) is want, size


def test_device_rpc_row_matches_the_reference(child_rows):
    (r,), (p,) = child_rows["ref_rpc"], child_rows["port_rpc"]
    # One staging hop (D2H straight into the registered slab) in place of
    # the reference's two; every other key as the reference's.
    assert set(p) - {"staging_d2h_gbps"} == \
        set(r) - {"staging_dma_gbps", "staging_land_gbps"}
    assert "staging_dma_gbps" not in p and "staging_land_gbps" not in p
    assert (r["kind"], p["kind"]) == ("tpu_rpc_64MB", "device_rpc_64MB")
    assert r["roundtrip_verified"] is True
    assert p["roundtrip_verified"] is True
    assert p["rpc_path"] == r["rpc_path"]
    assert p["rpc_16mb_path"] == r["rpc_16mb_path"]
    assert set(p["rpc"]) == set(r["rpc"]) == {"ici_ring", "shm_ring", "tcp"}
    assert p["ici_zero_copy"]["payload_covered"] is True
    assert p["ici_zero_copy"]["payload_covered"] == \
        r["ici_zero_copy"]["payload_covered"]
    assert p["rma_rails"] == r["rma_rails"]
    assert port.device_rpc_failures(p) == []


def test_zerocopy_row_has_the_reference_keys(child_rows):
    (r,), (p,) = child_rows["ref_zc"], child_rows["port_zc"]
    assert set(p) == set(r)
    assert p["pipeline_depth"] == r["pipeline_depth"] == 8
    assert p["zerocopy_gbps"] > 0 and p["percall_zerocopy_gbps"] > 0


def test_device_rpc_failures_name_each_failed_check():
    good = {"rpc": {"ici_ring": 1.0, "shm_ring": 1.0, "tcp": 1.0},
            "rpc_16mb": {"ici_ring": 1.0, "shm_ring": 1.0},
            "roundtrip_verified": True,
            "ici_zero_copy": {"payload_covered": True}}
    assert port.device_rpc_failures(good) == []
    assert port.device_rpc_failures(None) == ["device_rpc"]
    bad = dict(good, roundtrip_verified=False,
               ici_zero_copy={"payload_covered": False},
               rpc={"ici_ring": 1.0, "shm": "failed: refused", "tcp": 1.0})
    assert port.device_rpc_failures(bad) == [
        "device_rpc:rpc:shm", "device_rpc:roundtrip_verified",
        "device_rpc:payload_covered"]


def test_observe_snapshot_reads_vars_by_name(monkeypatch):
    """The snapshot reads each var by name and never calls the dump."""
    def no_dump():
        raise AssertionError("Vars.dump called")

    monkeypatch.setattr(observe.Vars, "dump", staticmethod(no_dump))
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    try:
        ch = Channel(f"127.0.0.1:{srv.port}", timeout_ms=10000)
        try:
            for _ in range(20):
                ch.call("Echo.Echo", b"x" * 1024)
        finally:
            ch.close()
    finally:
        srv.stop()
    snap = port._observe_snapshot()
    assert snap and "server_echo_p99_us" in snap
    assert set(snap) <= {"inline_write_ratio", "dispatch_batch_p50",
                         "server_echo_p99_us", "client_batch_p99_us",
                         "batch_depth", "batch_inflight"}


# ------------------------------------------------------ spawned tools ----

SPAWNING = [
    # (child, reference tool, port module, passes --device)
    ("_child_kv_disagg", "kv_disagg", "kv_disagg", True),
    ("_child_infer_serving", "load_orchestrator", "load_orchestrator",
     False),
    ("_child_pipeline_overlap", "pipeline_step", "pipeline_step", True),
    ("_child_rolling_restart", "load_orchestrator", "load_orchestrator",
     False),
]


def _fake_run(calls, stdout='{"row": 1}\n', rc=0):
    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=stdout, stderr="boom",
                                     returncode=rc)
    return run


@pytest.mark.parametrize("child,ref_tool,module,with_device", SPAWNING,
                         ids=[s[0] for s in SPAWNING])
def test_spawned_tool_argv_is_the_references(monkeypatch, capsys, child,
                                             ref_tool, module, with_device):
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_run(calls))
    monkeypatch.delenv("BENCH_INFER_STREAMS", raising=False)
    getattr(ref, child)()
    fn = getattr(port, child)
    fn(torch.device("cpu")) if with_device else fn()
    ref_cmd, port_cmd = calls
    assert ref_cmd[1] == str(REPO / "tools" / f"{ref_tool}.py")
    want = [sys.executable, "-m", f"brpc_tpu_torch.tools.{module}",
            *ref_cmd[2:]]
    if with_device:
        want += ["--device", "cpu"]
    assert port_cmd == want
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"row": 1}
    assert json.loads(lines[1]) == {"row": 1, "tool_rc": 0}


def test_spawned_tool_row_keeps_its_exit_code(monkeypatch, capsys):
    """A tool that crashes at teardown after its row: the row is kept and
    the crash stays visible beside it."""
    monkeypatch.setattr(subprocess, "run", _fake_run([], rc=-11))
    port._child_rolling_restart()
    assert _last_json(capsys.readouterr().out)["tool_rc"] == -11


def test_spawned_tool_without_a_row_raises(monkeypatch):
    monkeypatch.setattr(subprocess, "run", _fake_run([], stdout="", rc=1))
    with pytest.raises(RuntimeError, match="no row"):
        port._child_rolling_restart()


# ------------------------------------------------------------- parent ----

def _good_sweep(platform="cpu"):
    return {s: {"size": s, "goodput_gbps": 1.0, "platform": platform}
            for s in port.SIZES}


GOOD_RPC = {"rpc": {"ici_ring": 1.0}, "rpc_16mb": {"ici_ring": 1.0},
            "roundtrip_verified": True,
            "ici_zero_copy": {"payload_covered": True}}


def _stub_parent(monkeypatch, sweep=None, rows=None):
    """Stubs every child of the port's parent; returns the calls made,
    (what, device type, env flags) each."""
    calls = []
    rows = dict({"BENCH_DEVICE_RPC": GOOD_RPC,
                 "BENCH_KV": {"verified": True, "device_verified": True,
                              "kv_goodput_gbps": 1.0, "ratio_p99": 1.0,
                              "prefix_recompute_drop": 0.5},
                 "BENCH_OVERLAP": {"byte_exact": True}}, **(rows or {}))

    def harvest(sizes, dev, budget_end, first_row_s, row_s):
        calls.append(("sweep", dev.type, {}))
        return _good_sweep("gpu" if dev.type == "cuda" else "cpu") \
            if sweep is None else sweep

    def run_json_child(env_flags, dev, timeout):
        calls.append(("child", dev.type, dict(env_flags)))
        (flag,) = env_flags
        return rows.get(flag, {"workload": flag})

    monkeypatch.setattr(port, "_harvest", harvest)
    monkeypatch.setattr(port, "_run_json_child", run_json_child)
    monkeypatch.setattr(port, "_cpp_rows", lambda failed: [])
    monkeypatch.setattr(port, "card_info", lambda dev: {
        "name": "stub", "power_limit_w": 700.0})
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    return calls


def _reference_line(monkeypatch, tmp_path) -> dict:
    """The reference parent's line, its children stubbed."""
    monkeypatch.setattr(ref, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(ref, "_harvest", lambda *a, **k: {
        s: {"size": s, "goodput_gbps": 1.0, "platform": "tpu"}
        for s in ref.SIZES})
    monkeypatch.setattr(ref, "_run_json_child", lambda flags, t: {})
    monkeypatch.setattr(ref, "_cpp_rows", lambda: [])
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    return _last_json(buf.getvalue())


def test_parent_line_has_the_reference_keys_renamed(monkeypatch, capsys,
                                                    tmp_path):
    want = set(_reference_line(monkeypatch, tmp_path))
    _stub_parent(monkeypatch)
    assert port.main(["--device", "cpu"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == (want - {"tpu_rpc", "tpu_attempts"}) | {
        "device_rpc", "device", "failed"}
    assert line["failed"] == []
    assert line["device"] == {"name": "stub", "power_limit_w": 700.0}
    assert line["device_rpc"] == GOOD_RPC
    assert line["vs_baseline"] == round(1.0 / ref.BASELINE_GBPS, 3)
    assert line["prefix_cache"]["prefix_recompute_drop"] == 0.5


def test_missing_device_rows_exit_1_and_still_print(monkeypatch, capsys):
    sweep = _good_sweep()
    del sweep[1 << 26]
    _stub_parent(monkeypatch, sweep=sweep,
                 rows={"BENCH_DEVICE_RPC": None, "BENCH_QOS": None})
    assert port.main(["--device", "cpu"]) == 1
    line = _last_json(capsys.readouterr().out)
    assert line["failed"] == ["sweep:67108864", "device_rpc", "qos_mixed"]
    assert line["device_rpc"] is None and line["qos_mixed"] is None
    assert [r["size"] for r in line["sweep"]] == port.SIZES[:-1]
    assert line["value"] == 1.0  # the largest size that landed


def test_failed_checks_are_listed(monkeypatch, capsys):
    sweep = _good_sweep()
    sweep[1024]["platform"] = "other"
    _stub_parent(monkeypatch, sweep=sweep, rows={
        "BENCH_DEVICE_RPC": dict(GOOD_RPC, roundtrip_verified=False),
        "BENCH_KV": {"verified": True, "device_verified": False},
        "BENCH_OVERLAP": {"byte_exact": False}})
    assert port.main(["--device", "cpu"]) == 1
    assert _last_json(capsys.readouterr().out)["failed"] == [
        "sweep:1024:platform", "device_rpc:roundtrip_verified",
        "kv_disagg:device_verified", "pipeline_overlap:byte_exact"]


def test_no_child_runs_on_another_device(monkeypatch, capsys):
    """On the card every child, the sweep included, runs on the card: no
    CPU child, no forced-CPU flag, and the rows must say gpu."""
    calls = _stub_parent(monkeypatch)
    monkeypatch.setattr(port, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    assert port.main([]) == 0
    assert len(calls) == 12
    assert all(dev == "cuda" for _, dev, _ in calls)
    assert not any(k.endswith("FORCE_CPU") for _, _, f in calls for k in f)
    line = _last_json(capsys.readouterr().out)
    assert line["platform"] == "gpu" and line["failed"] == []
    assert port._self_cmd(torch.device("cuda"))[-2:] == ["--device", "cuda"]


def test_children_are_spawned_on_the_parents_device(monkeypatch):
    seen = []

    class Spawned(Exception):
        pass

    def popen(cmd, **kw):
        seen.append((cmd, kw["env"]))
        raise Spawned

    monkeypatch.setattr(subprocess, "Popen", popen)
    cuda = torch.device("cuda")
    with pytest.raises(Spawned):
        port._run_json_child({"BENCH_ZC": "1"}, cuda, 10)
    with pytest.raises(Spawned):
        port._RowReader([1024], cuda)
    for cmd, env in seen:
        assert cmd == [sys.executable, "-m", port.MODULE, "--device",
                       "cuda"]
        assert "BENCH_FORCE_CPU" not in env


def test_off_gpu_without_device_cpu_raises(monkeypatch):
    calls = _stub_parent(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([])
    assert calls == []
