"""The readers of the batch pipeline's queue counters, the program's spans
beside the harness's trace reduction (rpcbench/program_spans.py), and a CPU
rehearsal of a traced echo cell that reads both."""

import json
import time

import pytest

from rpcbench import batch_queue, harness, program_spans, spec
from rpcbench.tracer import Tracer

MS = 1_000_000  # ns
SPEC = spec.Spec.load(spec.PACKAGE.parent)
NEW = ("wire_us.calls", "ring_wait_us.calls", "wire_ms.bulk",
       "ring_wait_ms.bulk")


def _run(counters, view=None):
    return harness.RunData({}, {}, {}, "cpu", [], 1.0, harness.Window(),
                           view, counters)


def _recorder(monkeypatch, avg_us):
    """The program's recorder `rpc_client_batch` reads `avg_us` (None: the
    program has no such recorder)."""
    from brpc_tpu_torch.rpc import observe

    def read(cls, name):
        if avg_us is None or name != batch_queue.RECORDER:
            raise KeyError(name)
        return observe.LatencyStats(100, 10, avg_us, avg_us, avg_us, avg_us,
                                    avg_us, avg_us)

    monkeypatch.setattr(observe.Latency, "read", classmethod(read))


@pytest.mark.parametrize("name, want", [
    ("wire_us.calls", 500.0), ("ring_wait_us.calls", 100.0),
    ("wire_ms.bulk", 0.5), ("ring_wait_ms.bulk", 0.1)])
def test_queue_readers_on_synthetic_counters(name, want, monkeypatch):
    reader = SPEC.reader(name)
    ring = name.startswith("ring_wait")
    full = {batch_queue.DRAINED: (10, 20), batch_queue.HELD_US: (100, 6100)}
    assert set(getattr(reader, "COUNTERS", ())) == (
        set(full) if ring else set())
    _recorder(monkeypatch, 500)
    assert reader.read(_run(full)) == pytest.approx(want)
    # A program without the held counters, or a window that drained
    # nothing: no ring wait; the wire is the recorder's.
    absent = dict.fromkeys(full, (None, None))
    idle = dict(full, **{batch_queue.DRAINED: (20, 20)})
    for counters in (absent, idle):
        got = reader.read(_run(counters))
        assert got is None if ring else got == pytest.approx(want)
    # A program without the recorder, or one that saw no call.
    for avg in (None, 0):
        _recorder(monkeypatch, avg)
        assert reader.read(_run(full)) is None


def test_queue_metrics_are_listed_for_their_cells():
    for name, cell in zip(NEW, ["echo_1k_d64", "echo_1k_d64",
                                "echo_64m_d8", "echo_64m_d8"]):
        assert name in [m["name"] for m in SPEC.per_layer(cell)]
        assert name not in [m["name"] for m in SPEC.per_layer(
            "gather_4x64m")]


class _Profile:
    """Stands in for a stopped torch profiler: writes fixed events."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(name, cat, start_ms, end_ms, **extra):
    return {"ph": "X", "cat": cat, "name": name, "ts": start_ms * 1000.0,
            "dur": (end_ms - start_ms) * 1000.0, "pid": 1, "tid": 7,
            **extra}


HOST_EVENTS = [
    _x("rpcbench.slice", "user_annotation", 0, 100),
    _x("rpcbench.poll", "user_annotation", 10, 60),
    _x("rpcbench.submit", "user_annotation", 70, 80),
]
PROGRAM_EVENTS = [
    _x("trpc.echo.poll", "user_annotation", 11, 59),
    _x("trpc.batch.wait", "user_annotation", 12, 50),
    _x("trpc.echo.land", "user_annotation", 51, 53),
    _x("trpc.echo.check", "user_annotation", 53, 56),
    _x("trpc.echo.submit", "user_annotation", 71, 79),
    _x("trpc.batch.issue", "user_annotation", 72, 74),
]
DEVICE_EVENTS = [
    _x("void echo_kernel<256, 4>(unsigned int const*)", "kernel", 5, 6,
       args={"device": 0}),
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 56, 57,
       args={"device": 0}),
    _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 75, 76,
       args={"device": 0}),
]


def _view_of(events, tracer_cls=Tracer):
    tracer = tracer_cls(True, 1.0, True)
    tracer.begin_window(10.0)
    tracer._done_prof = _Profile(events)
    tracer.completed = 4
    return tracer, tracer.view([0])


def test_every_reader_reads_the_same_with_program_spans_in_the_trace():
    _, bare = _view_of(HOST_EVENTS + DEVICE_EVENTS)
    _, spanned = _view_of(HOST_EVENTS + PROGRAM_EVENTS + DEVICE_EVENTS)
    assert bare == spanned
    assert bare.breakdown() == spanned.breakdown()
    mix = {"chunk_bytes": 1 << 20}
    window = harness.Window(seconds=2.0, completed=8, bytes_per_call=1024)
    for m in SPEC.bench["end_to_end"] + SPEC.bench["per_layer"]:
        reader = SPEC.reader(m["name"])
        got = [reader.read(harness.RunData(
            {}, {}, mix, "NVIDIA H100 80GB HBM3", [], 1.0, window, v, {}))
            for v in (bare, spanned)]
        assert got[0] == got[1], m["name"]


def test_program_spans_self_times_host_time_and_gap_names():
    tracer, view = _view_of(HOST_EVENTS + PROGRAM_EVENTS + DEVICE_EVENTS,
                            program_spans._tracer_class(Tracer))
    spans = tracer.spans
    assert {s[0] for s in spans} == {e["name"] for e in PROGRAM_EVENTS}
    own = program_spans.self_ns(spans)
    assert own["trpc.echo.poll"] == (48 - 38 - 2 - 3) * MS
    assert own["trpc.echo.submit"] == (8 - 2) * MS
    assert own["trpc.batch.wait"] == 38 * MS
    # (48 + 8 - 38) ms of host time over 4 completions
    assert program_spans.host_us_per_call(spans, 4) == pytest.approx(4500)
    assert program_spans.host_us_per_call(spans, 0) is None
    gaps = program_spans.name_gaps(view, spans)
    assert [g[0] for g in gaps] == ["rpcbench.poll > trpc.batch.wait"] + [
        "rpcbench.slice"] * 3
    assert [g[1] for g in gaps] == pytest.approx([0.050, 0.024, 0.018,
                                                  0.005])
    # The harness's own names are left as they were.
    assert [g[0] for g in view.breakdown()["idle_gaps"]][:1] == [
        "rpcbench.poll"]


def test_little_counts_the_calls_in_the_native_part_of_the_loop():
    # 64 calls in flight at 6,400 calls/s: 10 ms each, all of it native.
    assert program_spans.little(9000.0, 1000.0, 6400, 1.0, 64) == \
        pytest.approx(1.0)
    assert program_spans.little(None, 1000.0, 6400, 1.0, 64) is None


def test_a_traced_rehearsal_reads_the_queue_and_the_program_spans(root):
    result, tracer = program_spans.traced_run(
        root, "echo_1k_d64", 2 ** 31 + 17, 0.8, t_start=time.perf_counter(),
        device="cpu", overrides={"trace_slice_s": 0.2},
        log=lambda line: None)
    assert harness.Tracer is Tracer
    assert result["correct"] is True
    rehearsal = result["rehearsal"]
    assert rehearsal["wire_us.calls"] > 0
    assert rehearsal["ring_wait_us.calls"] >= 0
    mix = SPEC.mix(SPEC.cell("echo_1k_d64"))
    out = program_spans.report(result, tracer, mix)
    assert out["host_us_per_call"] > 0
    assert {"trpc.echo.submit", "trpc.echo.poll", "trpc.batch.wait",
            "trpc.echo.land", "trpc.echo.check"} <= set(
                out["self_us_per_call"])
    assert 0 < out["little"] <= 1.05
    json.dumps(out)
