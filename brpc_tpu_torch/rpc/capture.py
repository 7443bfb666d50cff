"""Production traffic capture (the /capture page, in-process) and the
capture-file format shared with the replayers; port of
brpc_tpu/rpc/capture.py, carried across as it stands.

`cpp/stat/capture.cc` records sampled per-request METADATA — arrival
timestamps, method, tenant/priority (wire tail-group 5), deadline
budget (tail-group 7), trace/span ids, request/response sizes, status,
queue + handler latency — behind the default-off reloadable
`trpc_capture` flag, in a per-tenant stratified reservoir bounded by
`trpc_capture_max_records`.  Bodies stay with `Server::EnableDump`
(rpc_dump parity); this tier captures the *traffic shape* a replayer
needs: the arrival process, tenant mix and size distribution.

This module is the ctypes surface plus a pure-Python reader/writer for
the capture file (recordio "TREC" envelope; record 0 = "TRPCCAP1" magic
+ JSON header embedding the arrival-process summary and the recorded
per-tenant latency baseline; records 1..N = packed binary records):

- `enable_capture()` / `capture_enabled()` flip and read the flag;
- `summary()` returns the full /capture body (arrival-process summary:
  per-second rate series, burstiness CV, size histograms, per-tenant
  baseline, fan-out stats);
- `dump(path)` writes the capture file; `load_capture(path)` parses one
  (any process — no native library needed); `save_capture()` writes one
  from Python records (golden-capture tooling and tests);
- `counters()` exposes the seen/sampled/dropped/held accounting —
  `dropped > 0` means the capture is a uniform sample, not a complete
  record (the `capture_dropped_total` var says the same to Prometheus).

`tools/traffic_replay.py` consumes these files for exact (open-loop at
recorded inter-arrival times) and statistical (fitted arrival process)
replay; `cpp/tools/rpc_replay.cc` reads the same format natively.
"""

from __future__ import annotations

import ctypes
import json
import struct
from dataclasses import dataclass

from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.flags import set_flag
from brpc_tpu_torch.rpc.observe import _dump_with_retry

# Capture-file record 0 prefix (cpp/stat/capture.h kFileMagic).
FILE_MAGIC = b"TRPCCAP1"
# recordio envelope magic (cpp/base/recordio.cc).
RECORDIO_MAGIC = b"TREC"
# Packed binary record prefix (cpp/stat/capture.cc serialize_record):
# version, arrival_mono_us, arrival_wall_us, trace_id, parent_span_id,
# request_bytes, response_bytes, status, queue_us, handler_us,
# deadline_budget_us, priority, method_len, tenant_len.
RECORD_STRUCT = struct.Struct("<BqqQQQQiIIIBBB")
RECORD_VERSION = 1


@dataclass
class CaptureRecord:
    """One captured request's metadata (mirror of capture::Sample)."""

    arrival_mono_us: int = 0
    arrival_wall_us: int = 0
    trace_id: int = 0
    parent_span_id: int = 0
    request_bytes: int = 0
    response_bytes: int = 0
    status: int = 0
    queue_us: int = 0
    handler_us: int = 0
    deadline_budget_us: int = 0
    priority: int = 0
    method: str = ""
    tenant: str = ""


def enable_capture(on: bool = True) -> None:
    """Flips traffic capture (the reloadable `trpc_capture` flag; off by
    default — flag-off cost is one relaxed load per request)."""
    set_flag("trpc_capture", "true" if on else "false")


def capture_enabled() -> bool:
    return load_library().trpc_capture_enabled() == 1


def reset_capture() -> None:
    """Clears the reservoir, the window counters and the sampling
    decision index (a fresh capture window; the lifetime
    capture_*_total vars keep counting)."""
    load_library().trpc_capture_reset()


def summary(records: int = 0) -> dict:
    """The raw /capture body for THIS process: {"enabled", "counters",
    "flags", "summary": {rate series, burstiness CV, size histograms,
    per-tenant baseline, fan-out}, "records" (newest `records`) when
    records > 0}."""
    lib = load_library()
    raw = _dump_with_retry(
        lambda buf, n: lib.trpc_capture_dump(records, buf, n))
    return json.loads(raw.decode())


def counters() -> dict:
    """Lifetime admission counters + records held: {"seen", "sampled",
    "dropped", "records"}.  Provably frozen at 0 while `trpc_capture`
    has never been on."""
    lib = load_library()
    seen = ctypes.c_uint64()
    sampled = ctypes.c_uint64()
    dropped = ctypes.c_uint64()
    records = ctypes.c_uint64()
    lib.trpc_capture_counters(ctypes.byref(seen), ctypes.byref(sampled),
                              ctypes.byref(dropped), ctypes.byref(records))
    return {
        "seen": seen.value,
        "sampled": sampled.value,
        "dropped": dropped.value,
        "records": records.value,
    }


def dump(path: str) -> int:
    """Writes this process's reservoir to a capture file.  Returns the
    number of records written; raises OSError on I/O failure."""
    n = load_library().trpc_capture_dump_file(path.encode())
    if n < 0:
        raise OSError(f"cannot write capture file: {path}")
    return int(n)


def pack_record(rec: CaptureRecord) -> bytes:
    """Serializes one record into the capture-file binary layout."""
    method = rec.method.encode()[:64]
    tenant = rec.tenant.encode()[:64]
    return RECORD_STRUCT.pack(
        RECORD_VERSION, rec.arrival_mono_us, rec.arrival_wall_us,
        rec.trace_id, rec.parent_span_id, rec.request_bytes,
        rec.response_bytes, rec.status, rec.queue_us, rec.handler_us,
        rec.deadline_budget_us, rec.priority, len(method),
        len(tenant)) + method + tenant


def unpack_record(payload: bytes) -> CaptureRecord:
    """Parses one capture-file record payload (raises ValueError on
    truncation or version mismatch)."""
    if len(payload) < RECORD_STRUCT.size:
        raise ValueError("truncated capture record")
    (version, arrival_mono, arrival_wall, trace_id, parent_span,
     req_bytes, resp_bytes, status, queue_us, handler_us, budget_us,
     priority, mlen, tlen) = RECORD_STRUCT.unpack_from(payload)
    if version != RECORD_VERSION:
        raise ValueError(f"unsupported capture record version {version}")
    base = RECORD_STRUCT.size
    if len(payload) < base + mlen + tlen:
        raise ValueError("truncated capture record strings")
    return CaptureRecord(
        arrival_mono_us=arrival_mono,
        arrival_wall_us=arrival_wall,
        trace_id=trace_id,
        parent_span_id=parent_span,
        request_bytes=req_bytes,
        response_bytes=resp_bytes,
        status=status,
        queue_us=queue_us,
        handler_us=handler_us,
        deadline_budget_us=budget_us,
        priority=priority,
        method=payload[base:base + mlen].decode(errors="replace"),
        tenant=payload[base + mlen:base + mlen + tlen].decode(
            errors="replace"),
    )


def _read_recordio(path: str):
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            if head[:4] != RECORDIO_MAGIC:
                raise ValueError(f"bad recordio magic in {path}")
            (length,) = struct.unpack("<I", head[4:])
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"truncated record in {path}")
            yield payload


def load_capture(path: str) -> tuple[dict, list[CaptureRecord]]:
    """Reads a capture file: (header dict, records in arrival order).
    Pure Python — works in any process, no native library needed."""
    header: dict = {}
    records: list[CaptureRecord] = []
    for i, payload in enumerate(_read_recordio(path)):
        if i == 0:
            if not payload.startswith(FILE_MAGIC):
                raise ValueError(
                    f"{path} is not a capture file (body dumps replay "
                    "via cpp/tools/rpc_replay)")
            header = json.loads(payload[len(FILE_MAGIC):].decode())
            continue
        records.append(unpack_record(payload))
    records.sort(key=lambda r: r.arrival_mono_us)
    return header, records


def save_capture(path: str, header: dict,
                 records: list[CaptureRecord]) -> None:
    """Writes a capture file from Python records (golden-capture tooling
    and tests; the native writer is capture::dump_file)."""

    def envelope(payload: bytes) -> bytes:
        return RECORDIO_MAGIC + struct.pack("<I", len(payload)) + payload

    with open(path, "wb") as f:
        f.write(envelope(FILE_MAGIC + json.dumps(header).encode()))
        for rec in sorted(records, key=lambda r: r.arrival_mono_us):
            f.write(envelope(pack_record(rec)))
