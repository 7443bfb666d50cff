"""The port's native builds are safe across processes: several processes
that find build/libtpurpc.so stale at once take turns under one file lock,
one of them builds, and every one of them loads a whole library.

The tests run the port's `rpc/_lib.py` over a tiny tree of their own (a
one-file `cpp/` whose library exports `tpurpc_probe`), so the
repository's own build/ is never rebuilt by them: a rebuild there would
race the other test processes, which is the fault these tests pin.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PROCS = 4

CMAKE = """cmake_minimum_required(VERSION 3.10)
project(probe CXX)
add_library(tpurpc SHARED base/probe.cc)
"""
SOURCE = 'extern "C" int tpurpc_probe() { return 42; }\n'

# Child: load the copied _lib.py, wait for the common start, build, load.
CHILD = r"""
import ctypes, importlib.util, shutil, sys, time
spec = importlib.util.spec_from_file_location("plib", sys.argv[1])
lib = importlib.util.module_from_spec(spec)
spec.loader.exec_module(lib)
if sys.argv[3] == "compiler":
    which = shutil.which
    lib.shutil.which = lambda n: None if n == "cmake" else which(n)
while time.time() < float(sys.argv[2]):
    time.sleep(0.001)
lib.ensure_built()
print(ctypes.CDLL(str(lib._LIB_PATH)).tpurpc_probe(), flush=True)
"""


def _tree(root: pathlib.Path) -> pathlib.Path:
    """A repository layout holding only what `_lib.py` builds from, with a
    stale library: garbage bytes older than every source."""
    mod = root / "brpc_tpu_torch" / "rpc" / "_lib.py"
    mod.parent.mkdir(parents=True)
    shutil.copy(REPO / "brpc_tpu_torch" / "rpc" / "_lib.py", mod)
    (root / "cpp" / "base").mkdir(parents=True)
    (root / "cpp" / "CMakeLists.txt").write_text(CMAKE)
    (root / "cpp" / "base" / "probe.cc").write_text(SOURCE)
    stale = root / "build" / "libtpurpc.so"
    stale.parent.mkdir()
    stale.write_bytes(b"not an ELF file")
    os.utime(stale, (1, 1))
    return mod


def _spawn(mod, start: float, route: str):
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, str(mod), str(start), route],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("route", ["cmake", "compiler"])
def test_processes_that_find_the_library_stale_each_load_it(tmp_path,
                                                             route):
    if route == "cmake" and shutil.which("cmake") is None:
        pytest.skip("no cmake on this machine")
    mod = _tree(tmp_path)
    start = time.time() + 1.0
    procs = [_spawn(mod, start, route) for _ in range(PROCS)]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        results.append((p.returncode, out.strip(), err[-2000:]))
    assert all(rc == 0 and out == "42" for rc, out, _ in results), results
    assert (tmp_path / "build" / ".libtpurpc.lock").exists()


def test_a_load_waits_for_the_lock_held_by_a_build(tmp_path):
    """Even a library that is not stale is opened only under the lock, so
    a process never opens one that another process is still linking."""
    mod = _tree(tmp_path)
    first = _spawn(mod, 0.0, "cmake" if shutil.which("cmake") else
                   "compiler")
    out, err = first.communicate(timeout=120)
    assert first.returncode == 0 and out.strip() == "42", err[-2000:]

    import fcntl

    with open(tmp_path / "build" / ".libtpurpc.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        waiter = _spawn(mod, 0.0, "compiler")
        try:
            with pytest.raises(subprocess.TimeoutExpired):
                waiter.communicate(timeout=3.0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    try:
        out, err = waiter.communicate(timeout=60)
    finally:
        waiter.kill()
    assert waiter.returncode == 0 and out.strip() == "42", err[-2000:]
