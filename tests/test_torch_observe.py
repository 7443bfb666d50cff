"""Port parity: brpc_tpu_torch.rpc.observe against brpc_tpu.rpc.observe.

The decoders (digest-wire 1 and 2, the binary timeline) take the same
seeded bytes through both packages and must agree exactly; the readers over
the shared native registry (vars, latency recorders, gauges, flags, rpcz
spans, trace context, the timeline) must see what the reference sees.
Mirrors tests/test_observe.py and tests/test_timeline_python.py."""

import dataclasses
import struct

import numpy as np
import pytest

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import observe as ref_obs
from brpc_tpu_torch.rpc import observe as obs

SEEDS = range(6)


def _digest_bytes(rng) -> bytes:
    """One digest-wire 1 block with seeded counts, octaves and samples."""
    octaves = sorted(rng.choice(32, size=int(rng.integers(0, 9)),
                                replace=False).tolist())
    body = b""
    count = 0
    for idx in octaves:
        added = int(rng.integers(1, 500))
        samples = rng.integers(1 << idx, 2 << idx,
                               size=int(rng.integers(0, min(added, 40) + 1)))
        count += added
        body += struct.pack("<IqI", idx, added, len(samples))
        body += struct.pack(f"<{len(samples)}I", *samples.tolist())
    head = struct.pack("<qqqqdI", count, int(rng.integers(0, 1 << 40)),
                       int(rng.integers(0, 1 << 31)), count + 7,
                       float(rng.uniform(0.5, 10.0)), len(octaves))
    return b"TRPCDG01" + head + body


def _timeline_bytes(rng) -> bytes:
    rings = int(rng.integers(0, 4))
    out = b"TRPCTL01" + struct.pack("<qqI", int(rng.integers(0, 1 << 50)),
                                    int(rng.integers(0, 1 << 52)), rings)
    for r in range(rings):
        n = int(rng.integers(0, 12))
        out += struct.pack("<Q16sI", int(rng.integers(0, 1 << 40)),
                           f"worker-{r}".encode(), n)
        for _ in range(n):
            out += struct.pack(
                "<Iq5Q", int(rng.integers(1, 33)),
                int(rng.integers(0, 1 << 50)),
                *(int(v) for v in rng.integers(0, 1 << 63, size=5,
                                               dtype=np.uint64)))
    return out


def _fleet_bytes(rng) -> bytes:
    n = int(rng.integers(0, 4))
    out = b"TRPCFL01" + struct.pack("<qI", int(rng.integers(0, 1 << 52)), n)
    for i in range(n):
        name = f"tenant{i}".encode()
        p99 = (1 << 63) - 1 if i == 0 else int(rng.integers(100, 10**6))
        out += struct.pack("<H", len(name)) + name
        out += struct.pack(
            "<qd" + "q" * 8 + "ddB", p99, float(rng.uniform(0.9, 1.0)),
            *(int(v) for v in rng.integers(0, 10**6, size=8)),
            float(rng.uniform(0, 5)), float(rng.uniform(0, 5)), i % 2)
        out += _digest_bytes(rng)
    return out


def _plain(x):
    """Decoder output with Digest dataclasses turned into dicts (the two
    packages' Digest classes are distinct types with equal fields)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("seed", SEEDS)
def test_digest_decode_merge_percentile_match_reference(seed):
    rng = np.random.default_rng(seed)
    raws = [_digest_bytes(rng) for _ in range(3)]
    got = [obs.digest_decode(r) for r in raws]
    want = [ref_obs.digest_decode(r) for r in raws]
    assert [(_plain(d), n) for d, n in got] == \
        [(_plain(d), n) for d, n in want]
    merged, ref_merged = obs.Digest(), ref_obs.Digest()
    for (d, _), (w, _) in zip(got, want):
        obs.digest_merge(merged, d)
        ref_obs.digest_merge(ref_merged, w)
    assert _plain(merged) == _plain(ref_merged)
    for p in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert obs.digest_percentile_us(merged, p) == \
            ref_obs.digest_percentile_us(ref_merged, p)
    assert (merged.qps, merged.avg_us) == (ref_merged.qps, ref_merged.avg_us)
    # Offsets: two blocks back to back decode at the consumed length.
    d2, used = obs.digest_decode(raws[0] + raws[1], len(raws[0]))
    assert used == len(raws[1]) and _plain(d2) == _plain(got[1][0])


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_binary_decode_matches_reference(seed):
    raw = _timeline_bytes(np.random.default_rng(100 + seed))
    assert obs.parse_timeline_binary(raw) == \
        ref_obs.parse_timeline_binary(raw)


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_blob_decode_matches_reference(seed):
    raw = _fleet_bytes(np.random.default_rng(200 + seed))
    got = obs.fleet_blob_decode(raw)
    assert _plain(got) == _plain(ref_obs.fleet_blob_decode(raw))
    if got["tenants"]:
        assert got["tenants"][0]["p99_target_us"] is None


@pytest.mark.parametrize("bad", [
    b"XXXXXXXX" + b"\0" * 64,
    b"TRPCDG01" + struct.pack("<qqqqdI", 0, 0, 0, 0, 1.0, 33),
    b"TRPCDG01" + struct.pack("<qqqqdI", 1, 0, 0, 1, 1.0, 1)
    + struct.pack("<IqI", 40, 1, 0),
])
def test_malformed_digests_rejected_like_reference(bad):
    with pytest.raises(ValueError):
        ref_obs.digest_decode(bad)
    with pytest.raises(ValueError):
        obs.digest_decode(bad)


def test_decoder_tables_equal_reference():
    for name in ("TIMELINE_EVENTS", "TIMELINE_CAPTURE_OPS",
                 "TIMELINE_KV_OPS", "TIMELINE_COLL_OPS", "TIMELINE_SLO_OPS",
                 "TIMELINE_TOKEN_OPS", "TIMELINE_STRIPE_PRIMARY_RAIL",
                 "TIMELINE_STRIPE_RMA_BIT", "SLO_NO_P99_TARGET"):
        assert getattr(obs, name) == getattr(ref_obs, name), name


def _echo_server():
    srv = port.Server()
    srv.register("Echo.Echo", lambda call, req: call.respond(req))
    srv.register_native_echo("Echo.Native")
    srv.start(0)
    return srv


def test_latency_read_server_and_client_no_http():
    srv = _echo_server()
    try:
        ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        try:
            for _ in range(64):
                assert ch.call("Echo.Echo", b"p" * 256) == b"p" * 256
            server = obs.Latency.read("rpc_server_Echo.Echo")
            client = obs.Latency.read(ch.latency.name)
            assert server.count >= 64 and client.count == 64
            assert client.p50_us <= client.p99_us <= client.max_us
            assert ref_obs.Latency.read(ch.latency.name).count == 64
            v = obs.Vars.read(ch.latency.name)
            assert v["count"] == 64 and v["p99_us"] > 0
        finally:
            ch.close()
    finally:
        srv.close()
    with pytest.raises(KeyError):
        obs.Latency.read("no_such_recorder_anywhere")
    with pytest.raises(TypeError):
        obs.Latency.read("process_memory_rss_kb")


def test_vars_and_prometheus_agree_with_reference():
    srv = _echo_server()
    try:
        ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        try:
            ch.call("Echo.Echo", b"x")
            v = obs.Vars.dump()
            assert "rpc_server_Echo.Echo" in v and ch.latency.name in v
            assert set(ref_obs.Vars.dump()) >= {ch.latency.name}
            prom = obs.Vars.prometheus()
            assert "# TYPE socket_inline_write_attempts_total counter" \
                in prom
        finally:
            ch.close()
    finally:
        srv.close()
    with pytest.raises(KeyError):
        obs.Vars.read("no_such_var_anywhere")


def test_gauge_and_unique_names_across_packages():
    g = obs.Gauge(obs.unique_var_name("test_torch_observe_gauge"), "gauge")
    try:
        g.set(7)
        assert obs.Vars.read(g.name) == ref_obs.Vars.read(g.name) == 7
        assert g.add(3) == 10
        # The reference probes the same registry: the name is taken.
        second = ref_obs.unique_var_name(g.name)
        assert second == f"{g.name}#2"
        assert obs.unique_var_name(g.name) == second
    finally:
        g.close()
    with pytest.raises(KeyError):
        obs.Vars.read(g.name)
    with pytest.raises(ValueError):
        obs.Gauge("")


def test_flags_introspection_matches_reference():
    assert obs.flags() == ref_obs.flags()
    by_name = {f["name"]: f for f in obs.flags()}
    assert by_name["trpc_stripe_rails"]["value"] == \
        port.get_flag("trpc_stripe_rails")


def test_trace_context_roundtrip_across_packages():
    tid = obs.new_trace_id()
    assert tid != 0
    obs.set_trace(tid, 42)
    try:
        assert obs.get_trace() == ref_obs.get_trace() == (tid, 42)
    finally:
        obs.clear_trace()
    assert obs.get_trace() == (0, 0)


@pytest.fixture
def rpcz():
    obs.enable_rpcz(True)
    try:
        assert obs.rpcz_enabled() and ref_obs.rpcz_enabled()
        yield
    finally:
        obs.enable_rpcz(False)


def test_trace_block_owns_client_and_batch_spans(rpcz):
    srv = _echo_server()
    try:
        ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        try:
            with obs.trace("torch-trace") as t:
                t.annotate("first")
                ch.call("Echo.Echo", b"z")
                assert ch.call_batch("Echo.Native", [b"a" * 64] * 3) == \
                    [b"a" * 64] * 3
                t.annotate("second")
            sp = obs.spans(limit=500, trace_id=t.trace_id)
            assert [s.method for s in sp] == \
                [s.method for s in ref_obs.spans(limit=500,
                                                 trace_id=t.trace_id)]
            by = {}
            for s in sp:
                by.setdefault(s.method, []).append(s)
            root = by["torch-trace"][0]
            assert [a[1] for a in root.annotations] == ["first", "second"]
            batch = by["batch:Echo.Native"][0]
            assert batch.parent_span_id == root.span_id
            members = [s for s in by.get("Echo.Native", [])
                       if s.side == "client"
                       and s.parent_span_id == batch.span_id]
            assert len(members) == 3
            assert obs.get_trace() == (0, 0)
            dump = obs.rpcz_dump(limit=10, trace_id=f"{t.trace_id:x}")
            assert {"pid", "now_mono_us", "now_wall_us", "spans"} <= set(dump)
            assert obs.Latency.read("rpc_client_batch").count >= 3
        finally:
            ch.close()
    finally:
        srv.close()


def test_timeline_dump_and_binary_agree():
    obs.enable_timeline(True)
    try:
        assert obs.timeline_enabled() and ref_obs.timeline_enabled()
        obs.reset_timeline()
        srv = _echo_server()
        try:
            ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
            try:
                for _ in range(4):
                    ch.call("Echo.Native", b"t" * 128)
            finally:
                ch.close()
        finally:
            srv.close()
        raw = obs.timeline_binary(1 << 14)
        assert obs.parse_timeline_binary(raw) == \
            ref_obs.parse_timeline_binary(raw)
        events = obs.timeline(1 << 14)
        assert events and all(e.name in obs.TIMELINE_EVENTS.values()
                              or e.name == "unknown" for e in events)
        assert [e.ts_us for e in events] == sorted(e.ts_us for e in events)
        assert obs.timeline_dump(16)["enabled"] is True
    finally:
        obs.enable_timeline(False)
    assert not obs.timeline_enabled()


def test_slo_and_fleet_switches_restore():
    assert obs.slo_enabled() == ref_obs.slo_enabled()
    was = obs.slo_enabled()
    obs.enable_slo(True)
    try:
        assert obs.slo_enabled() and ref_obs.slo_enabled()
    finally:
        obs.enable_slo(was)
    assert obs.slo_breach_total() == ref_obs.slo_breach_total()
    old = port.get_flag("trpc_fleet_publish")
    obs.enable_fleet_publish(True)
    try:
        assert ref.get_flag("trpc_fleet_publish") == "true"
    finally:
        port.set_flag("trpc_fleet_publish", old)
    assert obs.fleet_dump("no-such-fleet-service") == \
        ref_obs.fleet_dump("no-such-fleet-service")
