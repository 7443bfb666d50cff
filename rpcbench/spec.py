"""BENCHMARK.json: its rules, and the files it names, found by name.

`Spec.load(root)` reads `<root>/BENCHMARK.json`; `validate` holds it to the
rules of its format (names, units, keys, lengths, paths, bounds), so that a
malformed file is refused before any run.  A cell's configuration,
traffic mix, generator and metric readers are found by name:

    configs: the `file` of its configuration entry
    traffic: rpcbench/traffic/<traffic>.json (its "generator" key names
             rpcbench/generators/<generator>.py)
    readers: rpcbench/metrics/<metric name>.py, each with read(run)

so a later cell, mix or metric is added with new files and entries only.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib
import re

PACKAGE = pathlib.Path(__file__).resolve().parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
PATH_RE = re.compile(r"[A-Za-z0-9_.\-/]{1,200}\Z")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class SpecError(ValueError):
    """BENCHMARK.json breaks a rule of its format, or names a file that
    is not there."""


def _text(value, what: str) -> None:
    if (not isinstance(value, str) or not 1 <= len(value) <= 200
            or "\n" in value or "\t" in value):
        raise SpecError(f"{what}: 1 to 200 characters on one line, no tab")


def _name(value, what: str) -> None:
    if not isinstance(value, str) or not NAME_RE.match(value):
        raise SpecError(f"{what}: {value!r} is not a name (at most 64 of "
                        "A-Z a-z 0-9 _ . -, not starting with . or -)")


def _keys(entry: dict, allowed: set, what: str, optional=()) -> None:
    keys = set(entry)
    if not allowed <= keys or keys - allowed - set(optional):
        raise SpecError(f"{what}: keys {sorted(keys)}, want {sorted(allowed)}"
                        + (f" and optionally {list(optional)}"
                           if optional else ""))


def _metric(m: dict, cells: set, e2e: bool) -> None:
    what = f"metric {m.get('name')!r}"
    _keys(m, E2E_KEYS if e2e else LAYER_KEYS, what, optional=("workloads",))
    _name(m["name"], what)
    if not isinstance(m["unit"], str) or not UNIT_RE.match(m["unit"]):
        raise SpecError(f"{what}: unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        raise SpecError(f"{what}: better is lower or higher")
    if m["source"] not in SOURCES or (
            e2e and m["source"] not in ("host_clock", "device_trace")):
        raise SpecError(f"{what}: source {m['source']!r}")
    if e2e:
        bound = m["bound"]
        if not isinstance(bound, (int, float)) or not 0.01 <= bound <= 0.25:
            raise SpecError(f"{what}: bound {bound!r} outside [0.01, 0.25]")
    else:
        _text(m["layer"], f"{what} layer")
        _name(m["moves"], f"{what} moves")
    for w in m.get("workloads", []):
        if w not in cells:
            raise SpecError(f"{what}: unknown cell {w!r}")


def validate(bench: dict) -> None:
    """Raises SpecError where `bench` breaks a rule of the format;
    returns None when it keeps them all."""
    if set(bench) != set(TOP_KEYS):
        raise SpecError(f"top-level keys {sorted(bench)}, want "
                        f"{sorted(TOP_KEYS)}")
    cmd = bench["command"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        raise SpecError("command: a list of 1 to 32 strings")
    for word in cmd:
        _text(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            raise SpecError(f"command word {word!r} leads out of the repo")
    paths = bench["paths"]
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise SpecError("paths: 1 to 16 directories")
    for p in paths:
        if (not isinstance(p, str) or not PATH_RE.match(p)
                or p.startswith("/") or ".." in p.split("/")):
            raise SpecError(f"path {p!r}")
    rs = bench["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        raise SpecError("run_seconds: a whole number from 1 to 51")
    configs, cells = bench["configs"], bench["workloads"]
    if not 1 <= len(configs) <= 24 or not 1 <= len(cells) <= 24:
        raise SpecError("1 to 24 configs and 1 to 24 workloads")
    config_names, files = set(), set()
    for c in configs:
        what = f"config {c.get('name')!r}"
        _keys(c, CONFIG_KEYS, what)
        _name(c["name"], what)
        _text(c["source"], f"{what} source")
        _text(c["why"], f"{what} why")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise SpecError(f"{what}: reduced lists at most 16 keys")
        for k in c["reduced"]:
            _name(k, f"{what} reduced key")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            raise SpecError(f"{what}: file {c['file']!r} outside paths")
        config_names.add(c["name"])
        files.add(c["file"])
    if len(config_names) != len(configs) or len(files) != len(configs):
        raise SpecError("two configurations share a name or a file")
    pairs, names = set(), set()
    for w in cells:
        what = f"cell {w.get('name')!r}"
        _keys(w, CELL_KEYS, what)
        for key in ("name", "config", "traffic"):
            _name(w[key], f"{what} {key}")
        _text(w["why"], f"{what} why")
        if w["config"] not in config_names:
            raise SpecError(f"{what}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"{what}: chips is 1 or 4")
        pairs.add((w["config"], w["traffic"]))
        names.add(w["name"])
    if len(names) != len(cells) or len(pairs) != len(cells):
        raise SpecError("two cells share a name or a (config, traffic) pair")
    if {c["config"] for c in cells} != config_names:
        raise SpecError("a configuration that no cell uses")
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    if not 1 <= len(e2e) <= 16 or not 1 <= len(layer) <= 128:
        raise SpecError("1 to 16 end-to-end and 1 to 128 per-layer metrics")
    for m in e2e:
        _metric(m, names, e2e=True)
    for m in layer:
        _metric(m, names, e2e=False)
    metric_names = [m["name"] for m in e2e + layer]
    if len(set(metric_names)) != len(metric_names):
        raise SpecError("two metrics share a name")
    if "setup_s" not in metric_names[:len(e2e)]:
        raise SpecError("setup_s is an end-to-end metric")
    e2e_names = {m["name"] for m in e2e}
    for m in layer:
        if m["moves"] not in e2e_names:
            raise SpecError(f"metric {m['name']!r} moves {m['moves']!r}, "
                            "no end-to-end metric")
    quads = sum(1 for w in cells if w["chips"] == 4)
    if quads > max(1, len(cells) // 4):
        raise SpecError(f"{quads} four-chip cells of {len(cells)}")
    if len(json.dumps(bench).encode()) > 64 * 1024:
        raise SpecError("BENCHMARK.json over 64 KiB")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Spec:
    root: pathlib.Path
    bench: dict

    @classmethod
    def load(cls, root) -> "Spec":
        root = pathlib.Path(root)
        path = root / "BENCHMARK.json"
        if not path.is_file():
            raise SpecError(f"no BENCHMARK.json under {root}")
        bench = json.loads(path.read_text())
        validate(bench)
        return cls(root, bench)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SpecError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise SpecError(f"no configuration {cell['config']!r}")

    def package(self) -> pathlib.Path:
        """The folder of this harness inside the checkout at `root`."""
        return self.root / PACKAGE.name

    def mix(self, cell: dict) -> dict:
        path = self.package() / "traffic" / f"{cell['traffic']}.json"
        if not path.is_file():
            raise SpecError(f"no traffic mix {path}")
        mix = json.loads(path.read_text())
        _name(mix.get("generator"), f"{path.name} generator")
        return mix

    def generator(self, mix: dict):
        """The generator module the mix names (imported as part of this
        package, so a copy of the harness finds its own)."""
        path = self.package() / "generators" / f"{mix['generator']}.py"
        return _load(path, f"rpcbench_generator_{mix['generator']}")

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if _applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        """Per-layer metrics for `cell`: those that list it, and those with
        no list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in reported)]

    def reader(self, metric: str):
        path = self.package() / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise SpecError(f"no reader for metric {metric!r} ({path})")
        return _load(path, "rpcbench_metric_" + metric.replace(".", "_")
                     .replace("-", "_"))


@functools.cache
def _load(path: pathlib.Path, module_name: str):
    """Imports the file at `path` as a module of its own (names with dots
    are not importable as packages), once per path."""
    if not path.is_file():
        raise SpecError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"{module_name}_{abs(hash(str(path)))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
