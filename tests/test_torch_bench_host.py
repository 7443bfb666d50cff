"""Port parity: the host-only children of brpc_tpu_torch.tools.bench
(qos_mixed, collective, slo_fleet, self_tune, replay) on the CPU at
shortened durations and sizes, each row against the keys of the
reference's row in bench.py's source.  Their payloads stay on the host,
as the reference's do."""

import ast
import json
import pathlib

import pytest

from brpc_tpu_torch.rpc import get_flag, set_flag
from brpc_tpu_torch.tools import bench as port

REF_PATH = pathlib.Path(__file__).resolve().parent.parent / "bench.py"


def _ref_dict_keys(func: str, target: str | None = None) -> set:
    """Keys of the dict literal assigned to `target` in the reference's
    `func`, or of the one it prints (target None)."""
    tree = ast.parse(REF_PATH.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (target and isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == target
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
        if (target is None and isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no dict {target!r} in {func}")


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def _flags(*names):
    return {n: get_flag(n) for n in names}


def _restore(saved: dict) -> None:
    for n, v in saved.items():
        set_flag(n, v)


def test_qos_mixed_row_at_a_short_window(capsys):
    saved = _flags("trpc_qos_lanes", "trpc_qos_lane_weights")
    try:
        port._child_qos_mixed(unloaded_s=0.3, load_secs=2, settle_s=0.5,
                              loaded_s=0.8, bulk_bytes=1 << 20)
    finally:
        _restore(saved)
    row = _last_json(capsys.readouterr().out)
    assert set(row) == _ref_dict_keys("_child_qos_mixed", "row")
    assert row["samples_loaded"] > 0 and row["p99_loaded_us"] > 0
    assert row["bulk_bytes"] == 1 << 20


def test_collective_row_at_small_shards(capsys):
    port._child_collective(shard=1 << 20, shift=256 << 10, ag_iters=2,
                           rs_iters=2)
    row = _last_json(capsys.readouterr().out)
    assert set(row) == _ref_dict_keys("_child_collective", "row")
    assert set(row["all_gather"]) == _ref_dict_keys("_child_collective",
                                                    "ag_row")
    assert set(row["reshard"]) == _ref_dict_keys("_child_collective",
                                                 "reshard_row")
    assert row["all_gather"]["verified"] is True
    assert row["all_gather"]["rpc_path"] in ("rma", "copy")
    assert row["reshard"]["minimal"] is True
    assert row["reshard"]["bytes_moved"] < row["reshard"]["naive_bytes"]


def test_slo_fleet_row_at_a_short_window(capsys):
    port._child_slo_fleet(qps_s=0.2)
    row = _last_json(capsys.readouterr().out)
    assert set(row) == _ref_dict_keys("_child_slo_fleet", "row")
    assert row["calls_driven"] == 600 and row["tenants"]


@pytest.mark.slow
def test_replay_row_at_a_short_window(capsys):
    saved = _flags("trpc_qos_lanes")
    try:
        port._child_replay(bulk_bytes=1 << 20, record_secs=1.0,
                           stat_duration=1)
    finally:
        _restore(saved)
    row = _last_json(capsys.readouterr().out)
    assert set(row) == _ref_dict_keys("_child_replay")
    assert row["captured_records"] > 0


def test_self_tune_row_at_short_legs(capsys):
    """Each leg restores the knobs it moved (the tuner off at the end)."""
    from brpc_tpu_torch.rpc import observe

    defaults = {f["name"]: f["default"] for f in observe.flags()}
    port._child_self_tune(size=4 << 20, hand_s=1.2, tuned_s=1.2,
                          qps_hand_s=1.2, qps_tuned_s=1.2, load_secs=4,
                          settle_s=0.5, p99_s=0.5, converge_s=0.5)
    row = _last_json(capsys.readouterr().out)
    assert set(row) == _ref_dict_keys("_child_self_tune", "row")
    assert set(row["legs"]) == {"striped_64mb", "one_kb", "qos_mixed"}
    for name in ("trpc_stripe_chunk_bytes", "trpc_stripe_rails",
                 "trpc_messenger_cut_budget", "trpc_qos_lanes"):
        assert get_flag(name) == defaults[name], name
