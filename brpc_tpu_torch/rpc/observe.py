"""In-process observability: vars, latency recorders, rpcz spans, traces —
port of brpc_tpu/rpc/observe.py, host code over the native registry, carried
across as it stands.

Everything the builtin HTTP pages (/vars, /brpc_metrics, /rpcz) show is
readable here WITHOUT a server or an HTTP round-trip — a bare client
process has the same registry and span ring the serving processes do
(brpc jails bvar/rpcz behind builtin pages; this module is the ctypes
surface over `cpp/capi/observe_capi.cc`).

Three capability groups:

- **Read**: `Vars.dump()` / `Vars.read()` / `Vars.prometheus()` over the
  shared variable registry; `Latency.read(name)` for any registered
  recorder's window (count/qps/avg/p50/p90/p99/p999/max — e.g. a server
  method's `rpc_server_Echo.Echo` or a channel's `rpc_client_<addr>`);
  `spans()` / `rpcz_dump()` over the rpcz ring.
- **Register**: `Latency(name)` and `Gauge(name)` create NATIVE metrics
  owned by Python but living in the same registry, so client-side series
  appear in /vars and /brpc_metrics exactly like server methods do.
- **Trace**: `trace()` opens a span, installs it as the ambient trace
  context (fiber- or thread-local) so every RPC issued inside the block —
  sync calls, batch submits, nested hops across nodes — shares one
  trace_id; `annotate()` drops user timeline marks into the span.
  `get_trace()`/`set_trace()`/`clear_trace()` move the raw context across
  custom boundaries (queues, threads, processes).

Span collection for the AUTOMATIC per-RPC spans is gated by the
reloadable `rpcz_enabled` flag (`enable_rpcz()`); explicit `trace()`
spans always record.  When rpcz is off the plane costs nothing on the
hot path (guarded by test_perf_smoke).
"""

from __future__ import annotations

import ctypes
import json
import math
import struct
from dataclasses import dataclass, field

from brpc_tpu_torch.rpc._lib import load_library
from brpc_tpu_torch.rpc.flags import get_flag, set_flag


def _dump_with_retry(call, initial: int = 1 << 16) -> bytes:
    """Runs a size_t-returning dump C call, growing the buffer until the
    full rendering fits (the C side returns the FULL length)."""
    size = initial
    while True:
        out = ctypes.create_string_buffer(size)
        need = call(out, size)
        if need < size:
            return out.raw[:need]
        size = need + 1


# ---------------------------------------------------------------- vars ----


class Vars:
    """The shared variable registry (the /vars page, in-process)."""

    @staticmethod
    def dump() -> dict:
        """Every exposed variable: {name: float-or-str} (numeric values
        parse to numbers, structured ones — e.g. latency recorders' JSON
        summaries — stay strings)."""
        lib = load_library()
        raw = _dump_with_retry(
            lambda buf, n: lib.trpc_vars_dump(0, buf, n))
        return json.loads(raw.decode())

    @staticmethod
    def read(name: str):
        """One variable's value (float when numeric, parsed dict for
        latency-recorder summaries, str otherwise); KeyError if absent."""
        lib = load_library()
        size = 256
        while True:
            out = ctypes.create_string_buffer(size)
            rc = lib.trpc_var_read(name.encode(), out, size)
            if rc == 0:
                text = out.value.decode()
                break
            if rc == -2 and size < 1 << 24:
                size *= 4
                continue
            raise KeyError(name)
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            return text

    @staticmethod
    def prometheus() -> str:
        """The full Prometheus text exposition (the /brpc_metrics body)."""
        lib = load_library()
        return _dump_with_retry(
            lambda buf, n: lib.trpc_vars_dump(1, buf, n)).decode()


# ---------------------------------------------------------------- flags ----


def flags() -> list[dict]:
    """Every runtime flag with its introspection record: {"name",
    "type", "value", "default", "reloadable"} plus "min"/"max" where
    the flag declared numeric bounds (base/flags.h set_int_range) — the
    same body /flags?format=json serves.  Tools (and the self-tuning
    controller) read actuation bounds from here instead of guessing, so
    out-of-range writes are impossible by construction."""
    lib = load_library()
    raw = _dump_with_retry(lambda buf, n: lib.trpc_flags_dump(buf, n))
    return json.loads(raw.decode())


# ------------------------------------------------------------- latency ----


def unique_var_name(base: str) -> str:
    """First unregistered name among base, base#2, base#3...  expose()
    silently REPLACES the previous owner of a name, so two live owners
    (e.g. two Channels to one address) must not share a slot: the second
    would shadow the first and closing it would erase the series.  Best
    effort — a concurrent registration can still race the probe."""
    lib = load_library()
    name = base
    k = 1
    while lib.trpc_var_exists(name.encode()):
        k += 1
        name = f"{base}#{k}"
    return name


@dataclass(frozen=True)
class LatencyStats:
    """One recorder's trailing window + cumulative count."""

    count: int
    qps: int
    avg_us: int
    p50_us: int
    p90_us: int
    p99_us: int
    p999_us: int
    max_us: int


class Latency:
    """A native latency recorder registered under `name` (per-second
    windows + octave-bucketed percentiles, the same machinery behind the
    server's per-method recorders).  `record(us)` feeds it; `stats()`
    reads it.  Use the classmethod `read(name)` to read a recorder
    registered by anyone (server methods, channels, other modules)."""

    def __init__(self, name: str, description: str = ""):
        self._lib = load_library()
        self.name = name
        self._ptr = self._lib.trpc_latency_create(
            name.encode(), description.encode())
        if not self._ptr:
            raise ValueError(f"bad recorder name: {name!r}")

    @classmethod
    def read(cls, name: str) -> LatencyStats:
        """Reads ANY registered latency recorder by name (KeyError when
        absent, TypeError when the var is not a latency recorder)."""
        lib = load_library()
        out = (ctypes.c_double * 8)()
        rc = lib.trpc_latency_read(name.encode(), out)
        if rc == -1:
            raise KeyError(name)
        if rc != 0:
            raise TypeError(f"{name!r} is not a latency recorder")
        return LatencyStats(*(int(v) for v in out))

    def record(self, latency_us: int) -> None:
        if self._ptr:
            self._lib.trpc_latency_record(
                ctypes.c_void_p(self._ptr), int(latency_us))

    def stats(self) -> LatencyStats:
        return self.read(self.name)

    def close(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_latency_destroy(ctypes.c_void_p(ptr))

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class Gauge:
    """A native scalar gauge registered under `name` (pipeline depth,
    inflight counts, window sizes — levels, not event counts)."""

    def __init__(self, name: str, description: str = ""):
        self._lib = load_library()
        self.name = name
        self._ptr = self._lib.trpc_gauge_create(
            name.encode(), description.encode())
        if not self._ptr:
            raise ValueError(f"bad gauge name: {name!r}")

    def set(self, value: int) -> None:
        if self._ptr:
            self._lib.trpc_gauge_set(ctypes.c_void_p(self._ptr), int(value))

    def add(self, delta: int = 1) -> int:
        if not self._ptr:
            return 0
        return self._lib.trpc_gauge_add(
            ctypes.c_void_p(self._ptr), int(delta))

    def close(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.trpc_gauge_destroy(ctypes.c_void_p(ptr))

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# ---------------------------------------------------------------- rpcz ----


@dataclass
class Span:
    """One finished rpcz span (ids are 16-hex-digit strings — 64-bit
    values that would truncate as floats)."""

    trace_id: str
    span_id: str
    parent_span_id: str
    side: str  # "client" | "server"
    method: str
    start_us: int
    end_us: int
    latency_us: int
    error_code: int
    request_bytes: int
    response_bytes: int
    annotations: list = field(default_factory=list)  # [(ts_us, text)]
    # Fiber the span ran on (16-hex digits; all zeros off-fiber) — the
    # exact join key onto timeline fiber_run/fiber_park events.
    fid: str = "0" * 16

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            trace_id=d["trace_id"], span_id=d["span_id"],
            parent_span_id=d["parent_span_id"], side=d["side"],
            method=d["method"], start_us=int(d["start_us"]),
            end_us=int(d["end_us"]), latency_us=int(d["latency_us"]),
            error_code=int(d["error_code"]),
            request_bytes=int(d["request_bytes"]),
            response_bytes=int(d["response_bytes"]),
            annotations=[(int(a["ts_us"]), a["text"])
                         for a in d.get("annotations", [])],
            fid=d.get("fid", "0" * 16),
        )


def _trace_id_int(trace_id) -> int:
    if trace_id is None:
        return 0
    if isinstance(trace_id, str):
        return int(trace_id, 16)
    return int(trace_id)


def rpcz_dump(limit: int = 200, trace_id=None) -> dict:
    """The raw structured rpcz dump for THIS process — the same shape
    `/rpcz?format=json` serves: {"pid", "now_mono_us", "now_wall_us",
    "spans": [...]} (the clock pair lets tools/trace_stitch.py place this
    node's spans on a wall-clock timeline next to other nodes')."""
    lib = load_library()
    tid = _trace_id_int(trace_id)
    raw = _dump_with_retry(
        lambda buf, n: lib.trpc_rpcz_dump(limit, tid, 0, buf, n))
    return json.loads(raw.decode())


def spans(limit: int = 200, trace_id=None) -> list[Span]:
    """Recent spans, newest first; `trace_id` (int or hex str) filters."""
    return [Span.from_dict(d)
            for d in rpcz_dump(limit, trace_id)["spans"]]


def enable_rpcz(on: bool = True) -> None:
    """Flips automatic per-RPC span collection (the `rpcz_enabled`
    reloadable flag; off by default — the hot path pays nothing)."""
    set_flag("rpcz_enabled", "true" if on else "false")


def rpcz_enabled() -> bool:
    return get_flag("rpcz_enabled") == "true"


# ------------------------------------------------------------- timeline ----


# Decoder side of the flight recorder's event-type table
# (cpp/stat/timeline.h kEventNames).  tools/lint_trpc.py's timeline-event
# rule keeps BOTH tables in lockstep via the `timeline-event N (name)`
# markers: ids must be unique, consecutive from 1, and identical on the
# C++ encoder and this decoder.  Ids are APPEND-ONLY — a recorded binary
# dump must stay decodable by a newer reader.
TIMELINE_EVENTS = {
    1: "fiber_create",    # timeline-event 1 (fiber_create)
    2: "fiber_ready",     # timeline-event 2 (fiber_ready)
    3: "fiber_run",       # timeline-event 3 (fiber_run)
    4: "fiber_park",      # timeline-event 4 (fiber_park)
    5: "fiber_wake",      # timeline-event 5 (fiber_wake)
    6: "fiber_steal",     # timeline-event 6 (fiber_steal)
    7: "fiber_migrate",   # timeline-event 7 (fiber_migrate)
    8: "fiber_done",      # timeline-event 8 (fiber_done)
    9: "sweep_start",     # timeline-event 9 (sweep_start)
    10: "sweep_end",      # timeline-event 10 (sweep_end)
    11: "inline_begin",   # timeline-event 11 (inline_begin)
    12: "inline_end",     # timeline-event 12 (inline_end)
    13: "bulk_wake",      # timeline-event 13 (bulk_wake)
    14: "write_flush",    # timeline-event 14 (write_flush)
    15: "writer_handoff",  # timeline-event 15 (writer_handoff)
    16: "write_coalesce",  # timeline-event 16 (write_coalesce)
    17: "stripe_cut",     # timeline-event 17 (stripe_cut)
    18: "stripe_send",    # timeline-event 18 (stripe_send)
    19: "stripe_land",    # timeline-event 19 (stripe_land)
    20: "stripe_done",    # timeline-event 20 (stripe_done)
    21: "qos_drain",      # timeline-event 21 (qos_drain)
    22: "kv_block",       # timeline-event 22 (kv_block)
    23: "coll_step",      # timeline-event 23 (coll_step)
    24: "tuner_decision",  # timeline-event 24 (tuner_decision)
    25: "deadline",       # timeline-event 25 (deadline)
    26: "capture",        # timeline-event 26 (capture)
    27: "coll_ready",     # timeline-event 27 (coll_ready)
    28: "slo_breach",     # timeline-event 28 (slo_breach)
    29: "token_step",     # timeline-event 29 (token_step)
}

# kCapture `b` op tags (cpp/stat/capture.cc: b = op << 56 | request
# bytes, or records written for "dump") — traffic-capture reservoir
# keep/drop decisions and file dumps.
TIMELINE_CAPTURE_OPS = {1: "keep", 2: "drop", 3: "dump"}

# kKvBlock `b` op tags (cpp/net/kvstore.h: b = op << 56 | payload len) —
# how a kv_block event reads: the store published / served / evicted a
# block, rejected a stale-generation fetch, or moved a prefix block
# between the hot (registered) and cold (heap) tiers.
TIMELINE_KV_OPS = {1: "publish", 2: "serve", 3: "evict", 4: "stale",
                   5: "promote", 6: "demote"}

# kCollStep `b` op tags (cpp/net/collective.h CollOp: b = op << 56 |
# step bytes; a = step index) — one event per completed collective
# schedule step on the member that completed it.
TIMELINE_COLL_OPS = {1: "all_gather", 2: "reduce_scatter",
                     3: "all_to_all", 4: "reshard"}

# kSloBreach `b` op tags (cpp/stat/slo.cc: b = op << 56 | fast-window
# burn rate in milli-units; a = FNV-1a hash of the tenant name) — one
# event per breach-state EDGE, never per evaluation.
TIMELINE_SLO_OPS = {1: "breach", 2: "clear"}

# kTokenStep `b` op tags (cpp/net/infer.h: b = op << 56 | low bits;
# a = request id) — one request's life through the continuous batch:
# admit (low bits = prefix-cache-matched tokens), prefill_done, one
# `token` per decode step (low bits = token index), eos / cancel (low
# bits = tokens emitted), shed (low bits = error code; a = 0).
TIMELINE_TOKEN_OPS = {1: "admit", 2: "prefill_done", 3: "token",
                      4: "eos", 5: "cancel", 6: "shed"}

# kStripeSend rail index meaning "the call's primary socket" (head
# frame / dead-rail fallback) — cpp/stat/timeline.h kStripePrimaryRail.
TIMELINE_STRIPE_PRIMARY_RAIL = 0xFFFF

# kStripeSend rail values with this bit set are one-sided RMA rails
# (net/rma.h): the chunk was WRITTEN into the peer's registered region
# by rail (value & 0x7FFF) — no ring/socket copy happened.  Mirrors
# cpp/stat/timeline.h kStripeRmaRailBit.
TIMELINE_STRIPE_RMA_BIT = 0x8000

_TL_MAGIC = b"TRPCTL01"
_TL_HEADER = struct.Struct("<qqI")       # now_mono_us, now_wall_us, nrings
_TL_RING = struct.Struct("<Q16sI")       # tid, name, nevents
_TL_EVENT = struct.Struct("<Iq5Q")       # type, ts, a, b, trace, span, fid


@dataclass(frozen=True)
class TimelineEvent:
    """One flight-recorder event (ids are 16-hex-digit strings, like
    rpcz spans — 64-bit values that would truncate as floats)."""

    ts_us: int
    type: int
    name: str
    a: int
    b: int
    trace_id: str
    span_id: str
    fid: str
    tid: int
    thread: str


def enable_timeline(on: bool = True) -> None:
    """Flips the flight recorder (the reloadable `trpc_timeline` flag;
    off by default — every hook costs one relaxed load while off)."""
    set_flag("trpc_timeline", "true" if on else "false")


def timeline_enabled() -> bool:
    return load_library().trpc_timeline_enabled() == 1


def reset_timeline() -> None:
    """Hides everything recorded so far (per-ring floors — safe against
    concurrent writers; lifetime counters keep counting)."""
    load_library().trpc_timeline_reset()


def timeline_dump(limit: int = 4096) -> dict:
    """The raw structured timeline dump for THIS process — the same
    shape `/timeline` serves: {"pid", "now_mono_us", "now_wall_us",
    "enabled", "threads": [{"tid", "name", "events": [...]}]} (the clock
    pair lets tools/trace_stitch.py --timeline place these events on the
    same wall-clock timeline as the node's rpcz spans)."""
    lib = load_library()
    raw = _dump_with_retry(
        lambda buf, n: lib.trpc_timeline_dump(0, limit, buf, n))
    return json.loads(raw.decode())


def timeline_binary(limit: int = 4096) -> bytes:
    """The packed binary dump (the /timeline?format=binary body)."""
    lib = load_library()
    return _dump_with_retry(
        lambda buf, n: lib.trpc_timeline_dump(1, limit, buf, n))


def parse_timeline_binary(raw: bytes) -> dict:
    """Decodes a binary timeline dump into the JSON dump's dict shape.
    The event-type ids resolve through TIMELINE_EVENTS — the table the
    lint rule pins against the C++ encoder."""
    if raw[:8] != _TL_MAGIC:
        raise ValueError(f"bad timeline magic: {raw[:8]!r}")
    off = 8
    now_mono, now_wall, nrings = _TL_HEADER.unpack_from(raw, off)
    off += _TL_HEADER.size
    threads = []
    for _ in range(nrings):
        tid, name, nevents = _TL_RING.unpack_from(raw, off)
        off += _TL_RING.size
        events = []
        for _ in range(nevents):
            etype, ts, a, b, trace, span, fid = _TL_EVENT.unpack_from(
                raw, off)
            off += _TL_EVENT.size
            events.append({
                "ts_us": ts, "type": etype,
                "name": TIMELINE_EVENTS.get(etype, "unknown"),
                # a/b as 16-hex strings, matching the JSON dump (they
                # often carry 64-bit handles a JSON double would round).
                "a": f"{a:016x}", "b": f"{b:016x}",
                "trace_id": f"{trace:016x}",
                "span_id": f"{span:016x}", "fid": f"{fid:016x}",
            })
        threads.append({"tid": tid,
                        "name": name.split(b"\0")[0].decode(),
                        "events": events})
    return {"now_mono_us": now_mono, "now_wall_us": now_wall,
            "threads": threads}


def timeline(limit: int = 4096) -> list[TimelineEvent]:
    """Flight-recorder events of THIS process, flattened across threads
    and sorted by timestamp (per-thread order is exact; cross-thread
    order is clock order)."""
    out = []
    for t in timeline_dump(limit)["threads"]:
        for e in t["events"]:
            out.append(TimelineEvent(
                ts_us=int(e["ts_us"]), type=int(e["type"]),
                name=e["name"], a=int(e["a"], 16), b=int(e["b"], 16),
                trace_id=e["trace_id"], span_id=e["span_id"],
                fid=e["fid"], tid=int(t["tid"]), thread=t["name"]))
    out.sort(key=lambda e: e.ts_us)
    return out


# ------------------------------------------------- digests + SLO fleet ----


# Decoder side of the mergeable latency digest and the fleet publication
# blob (cpp/stat/digest.h documents both layouts; tools/lint_trpc.py's
# digest-wire rule keeps encoder and decoder in lockstep via these
# markers).  Digests pool the recorder's octave-bucketed SAMPLES, so
# fleet percentiles come from a rank walk over merged data — never from
# averaging per-node p99s — with the recorder's own one-octave (2x)
# error bound.
_DG_MAGIC = b"TRPCDG01"  # digest-wire 1 (TRPCDG01)
_DG_OCTAVES = 32
# count, sum_us, max_us, total_count, window_secs, noct
_DG_HEAD = struct.Struct("<qqqqdI")
_DG_OCT = struct.Struct("<IqI")          # octave index, added, nsamples

_FL_MAGIC = b"TRPCFL01"  # digest-wire 2 (TRPCFL01)
_FL_HEAD = struct.Struct("<qI")          # wall_us, nentries
# p99_target_us, avail_target, fast_window_ms, slow_window_ms,
# fast_total, fast_bad, fast_err, slow_total, slow_bad, slow_err,
# burn_fast, burn_slow, breached
_FL_TENANT = struct.Struct("<qd" + "q" * 8 + "ddB")

# INT64_MAX in the p99_target_us slot means "latency-unbounded" (the
# tenant only declared an availability target).
SLO_NO_P99_TARGET = (1 << 63) - 1


@dataclass
class Digest:
    """One decoded latency digest: pooled octave counts + reservoir
    samples.  `oct` maps octave index -> (added, [samples_us...])."""

    count: int = 0
    sum_us: int = 0
    max_us: int = 0
    total_count: int = 0
    window_secs: float = 0.0
    oct: dict = field(default_factory=dict)

    @property
    def qps(self) -> float:
        w = self.window_secs if self.window_secs > 0 else 1.0
        return self.count / w

    @property
    def avg_us(self) -> float:
        return self.sum_us / self.count if self.count else 0.0


def digest_decode(raw: bytes, off: int = 0) -> tuple[Digest, int]:
    """Decodes one digest-wire 1 block starting at `off`; returns
    (digest, bytes_consumed).  Mirrors cpp/stat/digest.cc digest_decode
    byte for byte; raises ValueError on a malformed block."""
    if raw[off:off + 8] != _DG_MAGIC:
        raise ValueError(f"bad digest magic: {raw[off:off + 8]!r}")
    start = off
    off += 8
    count, sum_us, max_us, total_count, window_secs, noct = \
        _DG_HEAD.unpack_from(raw, off)
    off += _DG_HEAD.size
    if noct > _DG_OCTAVES:
        raise ValueError(f"digest noct {noct} > {_DG_OCTAVES}")
    d = Digest(count=count, sum_us=sum_us, max_us=max_us,
               total_count=total_count, window_secs=window_secs)
    for _ in range(noct):
        idx, added, nsamp = _DG_OCT.unpack_from(raw, off)
        off += _DG_OCT.size
        if idx >= _DG_OCTAVES or off + 4 * nsamp > len(raw):
            raise ValueError("malformed digest octave")
        samples = list(struct.unpack_from(f"<{nsamp}I", raw, off))
        off += 4 * nsamp
        d.oct[idx] = (added, samples)
    return d, off - start


def digest_merge(into: Digest, other: Digest) -> Digest:
    """Octave-wise pooling — counts sum, reservoirs concatenate (the
    merge digest_percentile_us rank-walks over)."""
    into.count += other.count
    into.sum_us += other.sum_us
    into.total_count += other.total_count
    into.max_us = max(into.max_us, other.max_us)
    into.window_secs = max(into.window_secs, other.window_secs)
    for idx, (added, samples) in other.oct.items():
        a, s = into.oct.get(idx, (0, []))
        into.oct[idx] = (a + added, s + samples)
    return into


def digest_percentile_us(d: Digest, p: float) -> int:
    """Rank walk over the pooled octaves — the same arithmetic as
    cpp/stat/digest.cc digest_percentile_us (and the recorder's own
    window percentiles), so a merged fleet digest and a pooled
    single-recorder oracle agree within one octave (2x)."""
    total = sum(added for added, _ in d.oct.values())
    if total == 0:
        return 0
    n = min(max(math.ceil(p * total), 1), total)
    for i in range(_DG_OCTAVES):
        added, samples = d.oct.get(i, (0, []))
        if added == 0:
            continue
        if n <= added:
            if not samples:
                return 1 << i  # count but no samples: octave floor
            merged = sorted(samples)
            sample_n = int(n * len(merged) / added)
            if sample_n >= len(merged):
                sample_n = len(merged) - 1
            elif sample_n > 0:
                sample_n -= 1
            return merged[sample_n]
        n -= added
    return d.max_us


def fleet_blob_decode(raw: bytes) -> dict:
    """Decodes one node's digest-wire 2 publication blob: {"wall_us",
    "tenants": [{tenant, p99_target_us (None when unbounded),
    avail_target, windows, counters, burns, breached, digest}]}.
    Mirrors cpp/stat/slo.cc fleet_blob_decode."""
    if raw[:8] != _FL_MAGIC:
        raise ValueError(f"bad fleet blob magic: {raw[:8]!r}")
    off = 8
    wall_us, nentries = _FL_HEAD.unpack_from(raw, off)
    off += _FL_HEAD.size
    if nentries > 4096:
        raise ValueError(f"fleet blob nentries {nentries} > 4096")
    tenants = []
    for _ in range(nentries):
        (name_len,) = struct.unpack_from("<H", raw, off)
        off += 2
        name = raw[off:off + name_len].decode()
        off += name_len
        (p99_target_us, avail_target, fast_window_ms, slow_window_ms,
         fast_total, fast_bad, fast_err, slow_total, slow_bad, slow_err,
         burn_fast, burn_slow, breached) = _FL_TENANT.unpack_from(raw, off)
        off += _FL_TENANT.size
        digest, used = digest_decode(raw, off)
        off += used
        tenants.append({
            "tenant": name,
            "p99_target_us": (None if p99_target_us == SLO_NO_P99_TARGET
                              else p99_target_us),
            "avail_target": avail_target,
            "fast_window_ms": fast_window_ms,
            "slow_window_ms": slow_window_ms,
            "fast_total": fast_total, "fast_bad": fast_bad,
            "fast_err": fast_err,
            "slow_total": slow_total, "slow_bad": slow_bad,
            "slow_err": slow_err,
            "burn_fast": burn_fast, "burn_slow": burn_slow,
            "breached": breached != 0,
            "digest": digest,
        })
    return {"wall_us": wall_us, "tenants": tenants}


def enable_slo(on: bool = True) -> None:
    """Flips the SLO engine (the reloadable `trpc_slo` flag; off by
    default — flag-off, the response path pays one relaxed load and
    every slo_* var stays frozen)."""
    set_flag("trpc_slo", "true" if on else "false")


def slo_enabled() -> bool:
    return load_library().trpc_slo_enabled() == 1


def enable_fleet_publish(on: bool = True) -> None:
    """Flips fleet publication (the reloadable `trpc_fleet_publish`
    flag): when on, each Announcer renew round piggybacks this node's
    digest+SLO blob onto its lease/epoch-fenced naming record."""
    set_flag("trpc_fleet_publish", "true" if on else "false")


def slo_breach_total() -> int:
    """Lifetime breach EDGES across all engines (slo_breach_total)."""
    return int(load_library().trpc_slo_breach_total())


def fleet_dump(service: str = "fleet") -> dict:
    """The fleet-wide merged per-tenant view over the LOCAL naming
    registry (the /fleet builtin body): digests merged octave-wise,
    window counters summed, burn rates recomputed from pooled counters."""
    lib = load_library()
    raw = _dump_with_retry(
        lambda buf, n: lib.trpc_fleet_dump(service.encode(), buf, n))
    return json.loads(raw.decode())


# --------------------------------------------------------------- traces ----


def get_trace() -> tuple[int, int]:
    """The ambient (trace_id, parent_span_id) of this thread/fiber —
    (0, 0) when none is installed."""
    lib = load_library()
    t = ctypes.c_uint64()
    s = ctypes.c_uint64()
    lib.trpc_trace_get(ctypes.byref(t), ctypes.byref(s))
    return t.value, s.value


def set_trace(trace_id: int, span_id: int = 0) -> None:
    """Installs an ambient trace context: RPCs issued by this thread (or
    fiber) become children of (trace_id, span_id).  Use to carry a trace
    across custom boundaries — threads, queues, processes."""
    load_library().trpc_trace_set(int(trace_id), int(span_id))


def clear_trace() -> None:
    load_library().trpc_trace_clear()


def new_trace_id() -> int:
    """A fresh nonzero 64-bit id for minting root traces by hand."""
    return load_library().trpc_trace_new_id()


class trace:
    """Context manager opening a named span that owns the block: every
    RPC issued inside — sync calls, batch submits, calls the far server
    makes in turn — shares its trace_id, and `annotate()` drops user
    marks onto its timeline.  The span records into the rpcz ring at
    exit regardless of `rpcz_enabled` (it was explicitly asked for);
    the AUTOMATIC child spans still need `enable_rpcz()`.

        with observe.trace("step-42") as t:
            t.annotate("inputs staged")
            ch.call("Model.Forward", blob)
        print(hex(t.trace_id), observe.spans(trace_id=t.trace_id))
    """

    def __init__(self, name: str = "trace"):
        self._lib = load_library()
        self._name = name
        self._h = None
        self.trace_id = 0
        self.span_id = 0

    def __enter__(self) -> "trace":
        self._h = self._lib.trpc_span_start(self._name.encode(), 0)
        t = ctypes.c_uint64()
        s = ctypes.c_uint64()
        self._lib.trpc_span_ids(ctypes.c_void_p(self._h),
                                ctypes.byref(t), ctypes.byref(s))
        self.trace_id = t.value
        self.span_id = s.value
        return self

    def annotate(self, text: str) -> None:
        if self._h:
            self._lib.trpc_span_annotate(
                ctypes.c_void_p(self._h), text.encode())

    def __exit__(self, exc_type, exc, tb) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.trpc_span_end(
                ctypes.c_void_p(h), 0 if exc_type is None else 13)
