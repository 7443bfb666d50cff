"""ctypes bindings to the shared native runtime — port of brpc_tpu/rpc/_lib.py.

The C++ half (cpp/ → build/libtpurpc.so) is shared with the reference and
built by the same recipe; this module binds the subset the port's echo data
plane calls: IOBufs, the device arena, sync RPC over Server/Channel, and the
registered ici staging slab.  Every pointer crosses as c_void_p and every
size as c_size_t, so nothing is cut to 32 bits.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
_BUILD = _REPO / "build"
_LIB_PATH = _BUILD / "libtpurpc.so"
_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _newest_source_mtime() -> float:
    newest = 0.0
    for path in (_REPO / "cpp").rglob("*"):
        if path.suffix in (".cc", ".h", ".inc", ".S", ".txt"):
            newest = max(newest, path.stat().st_mtime)
    return newest


def _run(cmd: list[str]) -> None:
    # Surface the compiler diagnostics: a bare CalledProcessError with
    # swallowed output is undiagnosable from an import failure.
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed: {' '.join(cmd[:4])} ...\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")


def _build_with_compiler() -> None:
    """cmake-less build: compile cpp/ straight with the system C++ compiler
    (the flags of cpp/CMakeLists.txt) into build/obj/ and link
    libtpurpc.so, one compile per core."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        raise FileNotFoundError(
            "neither cmake nor a C++ compiler available to build "
            "libtpurpc.so")
    cpp = _REPO / "cpp"
    obj_dir = _BUILD / "obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    sources: list[pathlib.Path] = []
    for sub, pats in (
        ("base", ("*.cc",)),
        ("fiber", ("*.cc", "*.S")),
        ("stat", ("*.cc",)),
        ("net", ("*.cc",)),
        ("capi", ("*.cc",)),
    ):
        for pat in pats:
            sources.extend(sorted((cpp / sub).glob(pat)))
    flags = [
        "-std=c++20", "-fPIC", "-O2", "-g", "-Wall", "-Wextra",
        "-Wno-unused-parameter", "-fno-omit-frame-pointer", "-I", str(cpp),
    ]
    # A header edit invalidates every object (no dependency scanning).
    newest_h = 0.0
    for pat in ("*.h", "*.inc"):
        for p in cpp.rglob(pat):
            newest_h = max(newest_h, p.stat().st_mtime)

    def compile_one(src: pathlib.Path) -> str:
        obj = obj_dir / (str(src.relative_to(cpp)).replace("/", "_") + ".o")
        if (not obj.exists()
                or obj.stat().st_mtime < max(src.stat().st_mtime, newest_h)):
            _run([cxx, *flags, "-c", str(src), "-o", str(obj)])
        return str(obj)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        objs = list(pool.map(compile_one, sources))
    _run([cxx, "-shared", "-o", str(_LIB_PATH), *objs,
          "-lpthread", "-lrt", "-lz", "-ldl"])


def ensure_built() -> None:
    """(Re)builds build/libtpurpc.so when missing or older than any cpp/
    source: cmake's `tpurpc` target where cmake exists, else a direct
    compiler build.  The same library the reference loads."""
    if (_LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= _newest_source_mtime()):
        return
    if shutil.which("cmake") is None:
        _build_with_compiler()
        return
    _run(["cmake", "-S", str(_REPO / "cpp"), "-B", str(_BUILD)])
    _run(["cmake", "--build", str(_BUILD), "-j", str(os.cpu_count() or 2),
          "--target", "tpurpc"])


# name -> (argtypes, restype) of every native entry the port calls.
_SIGNATURES = {
    # IOBuf (capi/base_capi.cc).
    "trpc_iobuf_create": ([], _P),
    "trpc_iobuf_destroy": ([_P], None),
    "trpc_iobuf_append": ([_P, ctypes.c_char_p, _SZ], None),
    "trpc_iobuf_size": ([_P], _SZ),
    "trpc_iobuf_copy_to": ([_P, _P, _SZ, _SZ], _SZ),
    "trpc_iobuf_cutn": ([_P, _P, _SZ], _SZ),
    "trpc_iobuf_pop_front": ([_P, _SZ], _SZ),
    "trpc_iobuf_block_count": ([_P], _SZ),
    "trpc_iobuf_block_ptr": ([_P, _SZ], _P),
    "trpc_iobuf_append_user_data": ([_P, _P, _SZ, _P, _P], None),
    "trpc_iobuf_append_block": ([_P, _P, ctypes.c_uint32], ctypes.c_int),
    # Device arena (cpp/base/device_arena.h).
    "trpc_arena_create": ([ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int],
                          _P),
    "trpc_arena_destroy": ([_P], None),
    "trpc_arena_alloc": ([_P, ctypes.POINTER(_P), _U64P], _P),
    "trpc_arena_release": ([_P, _P], None),
    "trpc_arena_block_size": ([_P], ctypes.c_uint32),
    "trpc_arena_blocks_in_use": ([_P], _SZ),
    # Sync RPC (capi/rpc_capi.cc).
    "trpc_server_create": ([], _P),
    "trpc_server_destroy": ([_P], None),
    "trpc_server_register": ([_P, ctypes.c_char_p, _P, _P], ctypes.c_int),
    "trpc_server_register_echo": ([_P, ctypes.c_char_p], ctypes.c_int),
    "trpc_server_start": ([_P, ctypes.c_int], ctypes.c_int),
    "trpc_server_port": ([_P], ctypes.c_int),
    "trpc_server_stop": ([_P], None),
    "trpc_call_respond": ([_P, ctypes.c_char_p, _SZ, ctypes.c_int,
                           ctypes.c_char_p], ctypes.c_int),
    "trpc_channel_create_ex": ([ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int], _P),
    "trpc_channel_destroy": ([_P], None),
    "trpc_channel_transport": ([_P, ctypes.c_char_p, _SZ], None),
    "trpc_channel_call": ([_P, ctypes.c_char_p, ctypes.c_char_p, _SZ, _P,
                           ctypes.c_int64, ctypes.c_char_p, _SZ],
                          ctypes.c_int),
    "trpc_channel_call_buf": ([_P, ctypes.c_char_p, _P, _P, ctypes.c_int64,
                               ctypes.c_char_p, _SZ], ctypes.c_int),
    # Registered ici staging slab + the native echo bench loop.
    "trpc_ici_staging_alloc": ([_SZ, ctypes.POINTER(ctypes.c_uint32)], _P),
    "trpc_ici_staging_free": ([_P], None),
    "trpc_ici_zero_copy_counters": ([_U64P, _U64P], None),
    "trpc_bench_echo_rpc": ([_P, _SZ, ctypes.c_int, ctypes.c_int,
                             ctypes.c_char_p, _P,
                             ctypes.POINTER(ctypes.c_double),
                             ctypes.c_char_p, _SZ, ctypes.c_char_p, _SZ],
                            ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """The native runtime, built at first use, with the port's entries
    typed."""
    global _lib
    with _lock:
        if _lib is None:
            ensure_built()
            lib = ctypes.CDLL(str(_LIB_PATH))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


class IOBuf:
    """Python view of trpc::IOBuf (zero-copy chained buffer)."""

    def __init__(self, data: bytes | None = None):
        self._lib = load_library()
        self._ptr = self._lib.trpc_iobuf_create()
        if data:
            self.append(data)

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.trpc_iobuf_destroy(ptr)

    def __len__(self) -> int:
        return self._lib.trpc_iobuf_size(self._ptr)

    def append(self, data: bytes) -> None:
        self._lib.trpc_iobuf_append(self._ptr, data, len(data))

    def to_bytes(self) -> bytes:
        n = len(self)
        out = ctypes.create_string_buffer(n)
        got = self._lib.trpc_iobuf_copy_to(self._ptr, out, n, 0)
        return out.raw[:got]

    def cutn(self, n: int) -> "IOBuf":
        out = IOBuf()
        self._lib.trpc_iobuf_cutn(self._ptr, out._ptr, n)
        return out

    def pop_front(self, n: int) -> int:
        return self._lib.trpc_iobuf_pop_front(self._ptr, n)

    @property
    def block_count(self) -> int:
        return self._lib.trpc_iobuf_block_count(self._ptr)
