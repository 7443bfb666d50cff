"""The port stands alone: brpc_tpu_torch and chip_smoke.py import neither
jax nor anything of brpc_tpu (importing any brpc_tpu module runs
brpc_tpu/__init__.py, which imports jax)."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "brpc_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|brpc_tpu)\b", re.MULTILINE)


def _modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib')\n"
        "             or m.startswith(('jax.', 'jaxlib.'))\n"
        "             or m == 'brpc_tpu' or m.startswith('brpc_tpu.'))\n"
        "assert not bad, bad\n"
        "print('OK', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_has_no_jax_or_reference_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(REPO)} imports {hits}"


def test_forbidden_pattern_tells_port_from_reference():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from brpc_tpu.rpc import zerocopy")
    assert _FORBIDDEN.search("    import brpc_tpu")
    assert not _FORBIDDEN.search("from brpc_tpu_torch.rpc import zerocopy")
    assert not _FORBIDDEN.search("import brpc_tpu_torch")


@pytest.mark.parametrize("module", [
    "brpc_tpu_torch.rpc.capture", "brpc_tpu_torch.rpc.collective",
    "brpc_tpu_torch.rpc.kv", "brpc_tpu_torch.rpc.naming",
    "brpc_tpu_torch.ops.lcg", "brpc_tpu_torch.tools",
    "brpc_tpu_torch.tools.pipeline_step"])
def test_slice_c2_modules_are_covered(module):
    """The modules of slice C2 are among those imported without jax above,
    and their sources among those scanned."""
    _assert_covered(module)


TOOLS = ["trace_stitch", "kv_disagg", "tune_echo", "cuda_probe",
         "make_golden_capture", "traffic_replay", "fleet_top",
         "load_orchestrator"]


@pytest.mark.parametrize("name", TOOLS)
def test_slice_d_tools_are_covered(name):
    """Every tool of slice D is a module of the port, imported without jax
    above and scanned; no line of it, code strings included, imports the
    reference, and no spawn runs a file in place of the port's module."""
    module = f"brpc_tpu_torch.tools.{name}"
    _assert_covered(module)
    src = (PORT / "tools" / f"{name}.py").read_text()
    assert not re.search(r"(?:from|import)\s+brpc_tpu[.\s]", src), name
    assert not re.search(r"Popen\(\s*\[\s*sys\.executable,\s*(?:os|__file__)",
                         src), name


def _assert_covered(module):
    assert module in _modules()
    path = REPO.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in SOURCES


def test_package_exports_fabric_without_jax():
    """`from brpc_tpu_torch import Fabric` works, as `from brpc_tpu import
    Fabric` does, and imports no jax."""
    code = (
        "import sys\n"
        "from brpc_tpu_torch import Fabric\n"
        "from brpc_tpu_torch.parallel import Fabric as F2\n"
        "assert Fabric is F2\n"
        "f = Fabric.auto((2,), ('link',), devices='cpu')\n"
        "assert f.size == 2\n"
        "assert 'jax' not in sys.modules and 'brpc_tpu' not in sys.modules\n"
        "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "OK"


BENCH = PORT / "tools" / "bench.py"
BENCH_CODE = ["bulk_code", "flood_code", "replay_bulk_code",
              "replay_fg_code"]
BENCH_ARGV = ["_self_cmd", "kv_disagg_cmd", "infer_serving_cmd",
              "pipeline_overlap_cmd", "rolling_restart_cmd",
              "traffic_replay_cmd"]


def test_bench_module_is_covered():
    """The port's bench is a module of the port, imported without jax
    above and scanned; no line of it imports the reference or its tools."""
    _assert_covered("brpc_tpu_torch.tools.bench")
    src = BENCH.read_text()
    assert not re.search(r"(?:from|import)\s+(?:brpc_tpu|tools)[.\s]", src)
    assert not re.search(r"[\"']tools[\"']|bench\.py[\"']|\.jax_cache", src)


@pytest.mark.parametrize("name", BENCH_CODE)
def test_bench_code_string_loads_no_reference(name):
    """Each code string bench passes to `python -c` imports the port's rpc
    package, and its imports load no jax, brpc_tpu or tools."""
    from brpc_tpu_torch.tools import bench

    builder = getattr(bench, name)
    code = (builder("127.0.0.1:1", 1024, 1.0) if "bulk" in name
            else builder("127.0.0.1:1", 1.0))
    imports = [ln for ln in code.splitlines()
               if ln.startswith(("import ", "from "))]
    assert any(ln.startswith("from brpc_tpu_torch.rpc import")
               for ln in imports), imports
    check = "\n".join(imports) + (
        "\nimport sys\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'brpc_tpu', 'tools'))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", check], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "OK"


@pytest.mark.parametrize("name", BENCH_ARGV)
def test_bench_argv_names_only_port_modules(name):
    """Every argv bench builds for a Python child runs a module of the
    port, never a file."""
    import torch

    from brpc_tpu_torch.tools import bench

    builder = getattr(bench, name)
    if name == "traffic_replay_cmd":
        argv = builder("127.0.0.1:1", "x.cap", [])
    elif name in ("_self_cmd", "kv_disagg_cmd", "pipeline_overlap_cmd"):
        argv = builder(torch.device("cpu"))
    else:
        argv = builder()
    assert argv[:2] == [sys.executable, "-m"], argv
    assert argv[2] in _modules() and argv[2].startswith("brpc_tpu_torch."), \
        argv
    assert not any(str(a).endswith(".py") for a in argv), argv


def test_bench_spawns_only_through_its_builders():
    """Every spawn in bench takes its argv from a builder above, the native
    bench_echo binary or nvidia-smi; only the builders name the
    interpreter."""
    src = BENCH.read_text()
    firsts = re.findall(r"subprocess\.(?:run|Popen)\(\s*([^\s,(]+)", src)
    assert firsts and set(firsts) <= {
        "_self_cmd", "_code_cmd", "traffic_replay_cmd", "cmd", "[exe",
        '["nvidia-smi"'}, firsts
    assert src.count("sys.executable") == 3
