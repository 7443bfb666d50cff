"""The command's exits, and the result line's keys."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from rpcbench import harness

ARGS = ["--workload", "echo_1k_d64", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    import os

    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "rpcbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_without_a_card_it_fails_and_prints_no_result(root):
    proc = _run(root, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_with_only_the_benchmark_files_it_fails(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "rpcbench", tmp_path / "rpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(root, trace):
    lines = []
    result = harness.run_cell(
        root, "echo_1k_d64", 11, 0.6, trace, t_start=time.perf_counter(),
        device="cpu", overrides={"trace_slice_s": 0.2},
        log=lines.append)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert result["metrics"] == {}  # a CPU run writes no metric
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["device"]["platform"] == "cpu"
    assert result["correct"] is True and result["failed"] == 0
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit", "compared"}
        assert any(line.startswith(f"check {name}:") for line in lines)
    assert lines[-1].startswith("check ")
    json.dumps(result)
