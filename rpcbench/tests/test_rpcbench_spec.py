"""BENCHMARK.json against the rules of its format, and cells found by
name."""

import copy
import json
import shutil
import time

import pytest

from rpcbench import harness, spec


@pytest.fixture
def bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_rules(bench):
    spec.validate(bench)


def test_every_file_it_names_is_there(root, bench):
    s = spec.Spec.load(root)
    for w in bench["workloads"]:
        assert s.config(w)["name"] == w["config"]
        s.generator(s.mix(w))
        for m in s.end_to_end(w["name"]) + s.per_layer(w["name"]):
            assert callable(s.reader(m["name"]).read)


def test_every_cell_reports_setup_another_metric_and_a_layer(root, bench):
    s = spec.Spec.load(root)
    for w in bench["workloads"]:
        e2e = {m["name"] for m in s.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = s.per_layer(w["name"])
        assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("name, ok", [
    ("k1_roofline.bulk", True), ("echo_64m_d8", True), ("_x-1.2", True),
    ("9lives", True), ("a" * 64, True), ("a" * 65, False),
    (".hidden", False), ("-dash", False), ("with space", False),
    ("comma,name", False), ("slash/name", False), ("µs", False), ("", False),
])
def test_names(name, ok):
    assert bool(spec.NAME_RE.match(name)) == ok


@pytest.mark.parametrize("unit, ok", [
    ("GB/s", True), ("calls/s", True), ("%", True), ("us", True),
    ("ms", True), ("tokens/s", True), ("µs", False), ("per second", False),
    ("", False), ("x" * 17, False),
])
def test_units(unit, ok):
    assert bool(spec.UNIT_RE.match(unit)) == ok


@pytest.mark.parametrize("edit", [
    lambda b: b["workloads"][0].update(name="bad name"),
    lambda b: b["end_to_end"][1].update(unit="µs"),
    lambda b: b["end_to_end"][1].update(bound=0.3),
    lambda b: b["end_to_end"][1].update(bound=0.005),
    lambda b: b["per_layer"][0].update(moves="nothing"),
    lambda b: b["per_layer"][0].update(why="extra key"),
    lambda b: b["workloads"][0].update(chips=2),
    lambda b: b["workloads"].append(dict(b["workloads"][0], name="twin")),
    lambda b: b.update(run_seconds=52),
    lambda b: b["command"].append("/abs/path"),
    lambda b: b["workloads"][0].update(why="x" * 201),
    lambda b: b["end_to_end"].pop(0),
], ids=["cell-name", "unit", "bound-high", "bound-low", "moves", "extra-key",
        "chips", "pair-twice", "run-seconds", "abs-path", "why-long",
        "no-setup"])
def test_refused(bench, edit):
    broken = copy.deepcopy(bench)
    edit(broken)
    with pytest.raises(spec.SpecError):
        spec.validate(broken)


def test_a_new_cell_is_added_with_files_alone(root, bench, tmp_path):
    """A cell dropped into a copy as a new traffic file and a new entry is
    found and run (CPU rehearsal), with no existing file of the harness
    changed."""
    shutil.copytree(root / "rpcbench", tmp_path / "rpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "rpcbench").rglob("*") if p.is_file()}
    (tmp_path / "rpcbench" / "traffic" / "small_4k_d16.json").write_text(
        json.dumps({"generator": "echo_closed_loop", "payload_bytes": 4096,
                    "inflight": 16, "calls_per_payload": 512,
                    "check_sum_every": 1,
                    "check_bytes_every": 4}))
    grown = copy.deepcopy(bench)
    grown["workloads"].append({
        "name": "echo_4k_d16", "config": "echo_loopback",
        "traffic": "small_4k_d16", "chips": 1,
        "why": "4 KiB payloads, 16 in flight on one connection"})
    for m in grown["end_to_end"]:
        if m["name"] == "calls_per_s":
            m["workloads"].append("echo_4k_d16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(grown))
    result = harness.run_cell(tmp_path, "echo_4k_d16", 7, 0.3, False,
                              t_start=time.perf_counter(), device="cpu",
                              log=lambda line: None)
    assert result["correct"] and result["attempted"] > 0
    assert set(result["rehearsal"]) == {"setup_s", "calls_per_s"}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "rpcbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
