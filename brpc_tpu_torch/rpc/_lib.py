"""ctypes bindings to the shared native runtime — port of brpc_tpu/rpc/_lib.py.

The C++ half (cpp/ → build/libtpurpc.so) is shared with the reference and
built by the same recipe.  Every entry the reference types is typed here, in
one table (`_SIGNATURES`): every pointer crosses as c_void_p and every size
as c_size_t, so nothing is cut to 32 bits, and every restype is declared —
including the void ones the reference leaves at ctypes' int default.
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

# Mirror of the C++ runtime's error-code table (the `constexpr int kE* =
# NNNN;` constants in cpp/net/*.h), as the reference's _lib.py carries it.
# The typed errors resolve codes through the runtime capi at call time;
# this table is the build-time contract the parity tests hold to the capi.
ERROR_CODES = {
    "kELimit": 2004,
    "kEOverloaded": 2005,
    "kEDraining": 2006,
    "kEDeadlineExpired": 2007,
    "kEKvMiss": 2101,
    "kEKvStale": 2102,
    "kEKvExists": 2103,
    "kENamingStaleEpoch": 2111,
    "kENamingMiss": 2112,
    "kECollAbort": 2121,
    "kECollEpoch": 2122,
    "kECollMismatch": 2123,
}


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


def _cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        raise FileNotFoundError(
            "neither cmake nor a C++ compiler available to build "
            "libtpurpc.so")
    return cxx


def _build_with_compiler() -> None:
    """cmake-less build: compile cpp/ straight with the system C++ compiler
    (the flags of cpp/CMakeLists.txt) into build/obj/ and link
    libtpurpc.so, one compile per core."""
    cxx = _cxx()
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


def ensure_built(all_targets: bool = False) -> None:
    """(Re)builds build/libtpurpc.so when missing or older than any cpp/
    source: cmake's `tpurpc` target (every target with `all_targets`) where
    cmake exists, else a direct compiler build of the library alone
    (all_targets callers must check for cmake themselves).  The same
    library the reference loads."""
    stale = (not _LIB_PATH.exists()
             or _LIB_PATH.stat().st_mtime < _newest_source_mtime())
    if shutil.which("cmake") is None:
        if stale:
            _build_with_compiler()
        return
    if not stale and not all_targets:
        return
    _run(["cmake", "-S", str(_REPO / "cpp"), "-B", str(_BUILD)])
    cmd = ["cmake", "--build", str(_BUILD), "-j", str(os.cpu_count() or 2)]
    if not all_targets:
        cmd += ["--target", "tpurpc"]
    _run(cmd)


def ensure_bench_echo() -> pathlib.Path:
    """Builds build/bench_echo (the C++ loopback echo benchmark) when
    missing or stale, linked against libtpurpc.so."""
    ensure_built()
    exe = _BUILD / "bench_echo"
    src = _REPO / "cpp" / "tools" / "bench_echo.cc"
    if exe.exists() and exe.stat().st_mtime >= max(
            src.stat().st_mtime, _LIB_PATH.stat().st_mtime):
        return exe
    _run([_cxx(), "-std=c++20", "-O2", "-g", "-fno-omit-frame-pointer",
          "-I", str(_REPO / "cpp"), str(src),
          "-L", str(_BUILD), f"-Wl,-rpath,{_BUILD}",
          "-ltpurpc", "-lpthread", "-o", str(exe)])
    return exe


_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_S = ctypes.c_char_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_U64P = ctypes.POINTER(ctypes.c_uint64)
_IP = ctypes.POINTER(ctypes.c_int)

# name -> (argtypes, restype) of every native entry the port calls.
_SIGNATURES = {
    # IOBuf and endpoints (capi/base_capi.cc).
    "trpc_iobuf_create": ([], _P),
    "trpc_iobuf_destroy": ([_P], None),
    "trpc_iobuf_append": ([_P, _S, _SZ], None),
    "trpc_iobuf_size": ([_P], _SZ),
    "trpc_iobuf_copy_to": ([_P, _P, _SZ, _SZ], _SZ),
    "trpc_iobuf_cutn": ([_P, _P, _SZ], _SZ),
    "trpc_iobuf_pop_front": ([_P, _SZ], _SZ),
    "trpc_iobuf_block_count": ([_P], _SZ),
    "trpc_iobuf_block_ptr": ([_P, _SZ], _P),
    "trpc_iobuf_append_user_data": ([_P, _P, _SZ, _P, _P], None),
    "trpc_iobuf_append_block": ([_P, _P, _U32], _I),
    "trpc_endpoint_parse": ([_S, _S, _SZ], _I),
    # Device arena (cpp/base/device_arena.h).
    "trpc_arena_create": ([_U32, _U32, _I], _P),
    "trpc_arena_destroy": ([_P], None),
    "trpc_arena_alloc": ([_P, ctypes.POINTER(_P), _U64P], _P),
    "trpc_arena_release": ([_P, _P], None),
    "trpc_arena_block_size": ([_P], _U32),
    "trpc_arena_blocks_in_use": ([_P], _SZ),
    # Flags (base/flags.h).
    "trpc_flag_set": ([_S, _S], _I),
    "trpc_flag_get": ([_S, _S, _SZ], _I),
    "trpc_flags_dump": ([_S, _SZ], _SZ),
    # Server, call and channel (capi/rpc_capi.cc).
    "trpc_server_create": ([], _P),
    "trpc_server_destroy": ([_P], None),
    "trpc_server_register": ([_P, _S, _P, _P], _I),
    "trpc_server_register_echo": ([_P, _S], _I),
    "trpc_server_start": ([_P, _I], _I),
    "trpc_server_port": ([_P], _I),
    "trpc_server_stop": ([_P], None),
    "trpc_call_respond": ([_P, _S, _SZ, _I, _S], _I),
    "trpc_channel_create": ([_S, _I64], _P),
    "trpc_channel_create_shm": ([_S, _I64], _P),
    "trpc_channel_create_ex": ([_S, _I64, _S, _I], _P),
    "trpc_channel_destroy": ([_P], None),
    "trpc_channel_transport": ([_P, _S, _SZ], None),
    "trpc_channel_call": ([_P, _S, _S, _SZ, _P, _I64, _S, _SZ], _I),
    "trpc_channel_call_buf": ([_P, _S, _P, _P, _I64, _S, _SZ], _I),
    # Cluster channel and cache-aware routing (net/cluster.h, lb_hint.h).
    "trpc_cluster_create": ([_S, _S, _I64, _I], _P),
    "trpc_cluster_create_ex": ([_S, _S, _I64, _I, _I64, _S, _I64, _I64],
                               _P),
    "trpc_cluster_destroy": ([_P], None),
    "trpc_cluster_call": ([_P, _S, _S, _SZ, _P, _U64, _S, _SZ], _I),
    "trpc_cluster_call_hinted": ([_P, _S, _S, _SZ, _P, _U64, _S, _S, _SZ],
                                 _I),
    "trpc_lb_hint_counters": ([_U64P, _U64P, _U64P], None),
    # One-sided RMA regions + kernel probe (net/rma.h, base/proc.h).
    "trpc_rma_alloc": ([_SZ, _U64P], _P),
    "trpc_rma_free": ([_P], None),
    "trpc_rma_reg": ([_P, _SZ], _U64),
    "trpc_rma_unreg": ([_U64], _I),
    "trpc_rma_region_count": ([], _SZ),
    "trpc_rma_spans_in_use": ([], _SZ),
    "trpc_rma_scavenge": ([], _SZ),
    "trpc_kernel_supports": ([_S], _I),
    # Paged KV-block registry and prefix cache (capi/kv_capi.cc).
    "trpc_server_enable_kv_registry": ([_P], _I),
    "trpc_server_enable_kv_store": ([_P], _I),
    "trpc_kv_publish": ([_P, _SZ, _U64, _I64, _U64P, _U64P, _U64P], _I),
    "trpc_kv_publish_ex": ([_P, _SZ, _U64, _I64, _U64, _U64P, _U64P,
                            _U64P], _I),
    "trpc_kv_withdraw": ([_U64], _I),
    "trpc_kv_renew": ([_U64, _I64], _I),
    "trpc_kv_store_count": ([], _SZ),
    "trpc_kv_store_bytes_used": ([], _U64),
    "trpc_kv_registry_count": ([], _SZ),
    "trpc_kv_codes": ([_IP, _IP, _IP], None),
    "trpc_kv_reset": ([], None),
    "trpc_kv_withdraw_all": ([], _SZ),
    "trpc_kv_content_hash": ([_P, _SZ, _U64P, _SZ, _U64P, _U64P], None),
    "trpc_kv_prefix_chain": ([_U64P, _SZ, _I64, _U64P, _SZ], _SZ),
    "trpc_kv_prefix_publish": ([_U64, _U64, _U32, _P, _SZ, _U64P, _SZ,
                                _I64, _U64, _U64P, _U64P, _U64P, _U64P,
                                _U64P], _I),
    "trpc_kv_prefix_withdraw": ([_U64, _U64], _I),
    "trpc_kv_prefix_store_count": ([], _SZ),
    "trpc_kv_prefix_hot_bytes": ([], _U64),
    "trpc_kv_prefix_cold_bytes": ([], _U64),
    "trpc_kv_prefix_registry_count": ([], _SZ),
    "trpc_kv_prefix_registry_replicas": ([], _SZ),
    "trpc_kv_prefix_counters": ([_U64P, _U64P, _U64P, _U64P, _U64P], None),
    # Cluster control plane: naming, drain and handoff (capi/naming_capi.cc).
    "trpc_server_enable_naming": ([_P], _I),
    "trpc_server_announce": ([_P, _S, _S, _S, _I], _I),
    "trpc_server_drain": ([_P, _I64, _S], _I),
    "trpc_server_start_handoff": ([_P, _S, _I64], _I),
    "trpc_server_draining": ([_P], _I),
    "trpc_draining_code": ([], _I),
    "trpc_naming_codes": ([_IP, _IP], None),
    "trpc_naming_member_count": ([_S], _SZ),
    "trpc_naming_reset": ([], None),
    # Collective schedules over the RMA fabric (capi/coll_capi.cc).
    "trpc_server_enable_collective": ([_P], _I),
    "trpc_coll_group_create": ([_S, _U32, _I64, _I], _P),
    "trpc_coll_group_create_naming": ([_S, _S, _I64, _I], _P),
    "trpc_coll_group_destroy": ([_P], None),
    "trpc_coll_group_rank": ([_P], _U32),
    "trpc_coll_group_size": ([_P], _U32),
    "trpc_coll_group_version": ([_P], _U64),
    "trpc_coll_run": ([_P, _I, _P, _U64, _P, _U64, _U64, _U64], _I),
    "trpc_coll_run_ready": ([_P, _I, _P, _U64, _P, _U64, _U64, _U64, _U64],
                            _I),
    "trpc_coll_ready_create": ([_P, _U64, _U64], _U64),
    "trpc_coll_ready_stamp": ([_U64, _U64, _U64], _I),
    "trpc_coll_ready_destroy": ([_U64], None),
    "trpc_coll_ready_maps": ([], _SZ),
    "trpc_coll_reshard_run": ([_P, _S, _U32, _U32, _U64, _P, _U64, _P, _U64,
                               _U64], _I),
    "trpc_coll_reshard_plan": ([_S, _U32, _U32, _U64, _U32, _U64P, _U64P,
                                _U64P, ctypes.POINTER(_U32)], _I),
    "trpc_coll_codes": ([_IP, _IP, _IP], None),
    "trpc_coll_sessions": ([], _SZ),
    # Fault injection (cpp/net/fault.h).
    "trpc_fault_set": ([_S], _I),
    "trpc_fault_get": ([_S, _SZ], _I),
    "trpc_fault_log": ([_S, _SZ], _SZ),
    "trpc_fault_reset": ([], None),
    "trpc_fault_injected": ([], _U64),
    "trpc_server_fault_set": ([_P, _S], _I),
    # QoS, reuseport shards (capi/qos_capi.cc).
    "trpc_server_set_qos": ([_P, _S], _I),
    "trpc_server_set_reuseport": ([_P, _I], _I),
    "trpc_server_accept_counts": ([_P, _U64P, _I], _I),
    "trpc_channel_set_qos": ([_P, _S, _I], None),
    "trpc_cluster_set_qos": ([_P, _S, _I], None),
    "trpc_call_qos": ([_P, _S, _SZ], _I),
    "trpc_qos_overloaded_code": ([], _I),
    "trpc_qos_lane_depth": ([_I], _I64),
    # Deadline & cancellation plane (capi/deadline_capi.cc).
    "trpc_deadline_expired_code": ([], _I),
    "trpc_call_remaining_us": ([_P], _I64),
    "trpc_call_cancelled": ([_P], _I),
    "trpc_deadline_ambient_set": ([_I64], None),
    "trpc_deadline_ambient_remaining": ([], _I64),
    "trpc_deadline_ambient_clear": ([], None),
    "trpc_cancel_registered": ([], _SZ),
    "trpc_deadline_ensure_registered": ([], None),
    # Batched async pipeline (capi/batch_capi.cc).
    "trpc_batch_create": ([_P, _I], _P),
    "trpc_batch_submit": ([_P, _S, ctypes.POINTER(_P), ctypes.POINTER(_SZ),
                           ctypes.POINTER(_P), ctypes.POINTER(_SZ), _SZ,
                           _I64, _P, ctypes.POINTER(_P), _U64P], _SZ),
    "trpc_batch_poll": ([_P, _P, _SZ, _I64], _SZ),
    "trpc_batch_cancel": ([_P, _U64], _I),
    "trpc_batch_outstanding": ([_P], _SZ),
    "trpc_batch_inflight": ([_P], _SZ),
    "trpc_batch_quiesce": ([_P], None),
    "trpc_batch_destroy": ([_P], None),
    # Observability plane: vars, rpcz, timeline (capi/observe_capi.cc).
    "trpc_vars_dump": ([_I, _S, _SZ], _SZ),
    "trpc_var_read": ([_S, _S, _SZ], _I),
    "trpc_var_exists": ([_S], _I),
    "trpc_latency_read": ([_S, ctypes.POINTER(ctypes.c_double)], _I),
    "trpc_rpcz_dump": ([_SZ, _U64, _I, _S, _SZ], _SZ),
    "trpc_timeline_dump": ([_I, _SZ, _S, _SZ], _SZ),
    "trpc_timeline_enabled": ([], _I),
    "trpc_timeline_reset": ([], None),
    "trpc_trace_get": ([_U64P, _U64P], None),
    "trpc_trace_set": ([_U64, _U64], None),
    "trpc_trace_clear": ([], None),
    "trpc_trace_new_id": ([], _U64),
    "trpc_span_start": ([_S, _I], _P),
    "trpc_span_annotate": ([_P, _S], None),
    "trpc_span_ids": ([_P, _U64P, _U64P], None),
    "trpc_span_end": ([_P, _I], None),
    "trpc_latency_create": ([_S, _S], _P),
    "trpc_latency_record": ([_P, _I64], None),
    "trpc_latency_destroy": ([_P], None),
    "trpc_gauge_create": ([_S, _S], _P),
    "trpc_gauge_set": ([_P, _I64], None),
    "trpc_gauge_add": ([_P, _I64], _I64),
    "trpc_gauge_destroy": ([_P], None),
    # SLO engine + fleet publication (capi/slo_capi.cc).
    "trpc_server_set_slo": ([_P, _S], _I),
    "trpc_slo_dump": ([_P, _S, _SZ], _SZ),
    "trpc_fleet_blob": ([_P, _S, _SZ], _SZ),
    "trpc_fleet_dump": ([_S, _S, _SZ], _SZ),
    "trpc_slo_enabled": ([], _I),
    "trpc_slo_breach_total": ([], _U64),
    # Self-tuning controller (capi/tuner_capi.cc).
    "trpc_tuner_enabled": ([], _I),
    "trpc_tuner_dump": ([_SZ, _S, _SZ], _SZ),
    "trpc_tuner_counters": ([_U64P, _U64P, _U64P, _U64P], None),
    "trpc_server_enable_tuner": ([_P], _I),
    "trpc_tuner_reset": ([], None),
    # Traffic capture (capi/capture_capi.cc).
    "trpc_capture_enabled": ([], _I),
    "trpc_capture_dump": ([_SZ, _S, _SZ], _SZ),
    "trpc_capture_dump_file": ([_S], ctypes.c_longlong),
    "trpc_capture_counters": ([_U64P, _U64P, _U64P, _U64P], None),
    "trpc_capture_reset": ([], None),
    # Streaming plane (capi/stream_capi.cc).
    "trpc_stream_open": ([_P, _S, _S, _SZ, _I64, _I64, _S, _I, _P, _IP, _S,
                          _SZ], _P),
    "trpc_call_stream_accept": ([_P, _I64], _P),
    "trpc_stream_read": ([_P, _S, _SZ, _I64], ctypes.c_long),
    "trpc_stream_next_len": ([_P], ctypes.c_long),
    "trpc_stream_write": ([_P, _S, _SZ], _I),
    "trpc_stream_close": ([_P], _I),
    "trpc_stream_destroy": ([_P], None),
    "trpc_stream_id": ([_P], _U64),
    "trpc_stream_pending": ([_P], _SZ),
    # Streamed-inference front door (capi/infer_capi.cc).
    "trpc_server_enable_infer": ([_P, _I, _S, _S], _P),
    "trpc_infer_stop": ([_P], None),
    "trpc_infer_dump": ([_P, _S, _SZ], _SZ),
    "trpc_infer_streams_live": ([_P], ctypes.c_longlong),
    "trpc_infer_streams_peak": ([_P], ctypes.c_longlong),
    # Registered ici staging slab + the native echo bench loop.
    "trpc_ici_staging_alloc": ([_SZ, ctypes.POINTER(_U32)], _P),
    "trpc_ici_staging_free": ([_P], None),
    "trpc_ici_zero_copy_counters": ([_U64P, _U64P], None),
    "trpc_bench_echo_rpc": ([_P, _SZ, _I, _I, _S, _P,
                             ctypes.POINTER(ctypes.c_double), _S, _SZ, _S,
                             _SZ], _I),
}


def load_library() -> ctypes.CDLL:
    """The native runtime, built at first use, with every entry typed."""
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


def parse_endpoint(addr: str) -> str:
    """Normalize 'host:port[/device]' via the native EndPoint parser."""
    lib = load_library()
    out = ctypes.create_string_buffer(64)
    if lib.trpc_endpoint_parse(addr.encode(), out, 64) != 0:
        raise ValueError(f"bad endpoint: {addr!r}")
    return out.value.decode()
