"""The trace reduction and the per-layer readers on a hand-made slice."""

import array
import time

import pytest

from rpcbench import harness, spec, yardstick
from rpcbench.tracer import Op, Span, TraceView, merge, short_name

MS = 1_000_000  # ns


def _view(ops, spans=(), devices=(0,), completed=10):
    spans = [Span("rpcbench.slice", 0, 100 * MS), *spans]
    return TraceView(0, 100 * MS, list(ops), spans, list(devices),
                     completed)


def _run(view, card="NVIDIA H100 80GB HBM3", mix=None, window=None):
    return harness.RunData({}, {}, mix or {}, card, [], 1.0,
                           window or harness.Window(seconds=1.0), view, {})


def test_merge():
    assert merge([(5, 8), (0, 2), (1, 3), (8, 9)]) == [[0, 3], [5, 9]]


def test_short_names():
    assert short_name("void (anonymous namespace)::bulk_gather<true>("
                      "GatherArgs)") == "bulk_gather<true>"
    assert short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"


def test_busy_idle_and_gaps():
    ops = [Op("k", "kernel", 0, 10 * MS, 30 * MS),
           Op("c", "gpu_memcpy", 0, 20 * MS, 40 * MS),
           Op("k", "kernel", 0, 90 * MS, 120 * MS),  # clipped at 100
           Op("k", "kernel", 1, 0, 50 * MS)]
    v = _view(ops, [Span("rpcbench.poll", 40 * MS, 95 * MS)], devices=[0, 1])
    assert v.busy(0) == [[10 * MS, 40 * MS], [90 * MS, 100 * MS]]
    assert v.busy_s() == pytest.approx((0.040 + 0.050) / 2)
    gaps = sorted(g[:2] for g in v.idle_gaps())
    assert gaps == [(0.01, 0), (0.05, 0), (0.05, 1)]
    b = v.breakdown()
    assert b["device_ops"][0][0] == "k"
    assert b["device_ops"][0][1] == pytest.approx(0.020 + 0.010 + 0.050)
    assert b["idle_gaps"][0][0] == "rpcbench.poll (cuda:0)"
    assert len(b["idle_gaps"]) <= 10


def test_no_device_op_reads_nothing():
    assert _view([]).busy_s() is None
    s = spec.Spec.load(spec.PACKAGE.parent)
    for name in ("device_idle_pct.bulk", "k1_roofline.bulk",
                 "copy_ms_per_call.bulk", "device_ops_per_call.calls",
                 "k2_roofline.gather"):
        assert s.reader(name).read(_run(_view([]))) is None
        assert s.reader(name).read(_run(None)) is None


def test_readers_on_a_hand_made_slice():
    s = spec.Spec.load(spec.PACKAGE.parent)
    size = 64 << 20
    k1_ms = 0.05
    ops = [Op("void (anonymous namespace)::echo_kernel<256, 4>(x)", "kernel",
              0, i * MS, i * MS + int(k1_ms * MS)) for i in range(10)]
    ops += [Op("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 0,
               50 * MS, 53 * MS)]
    run = _run(_view(ops), window=harness.Window(bytes_per_call=size,
                                                 seconds=1.0))
    want = 100 * yardstick.k1_bound_ms(size, 3350.0) / k1_ms
    assert s.reader("k1_roofline.bulk").read(run) == pytest.approx(want)
    assert s.reader("copy_ms_per_call.bulk").read(run) == pytest.approx(0.3)
    assert s.reader("device_ops_per_call.calls").read(run) == 1.1
    idle = s.reader("device_idle_pct.bulk").read(run)
    assert idle == pytest.approx(100 * (1 - 0.035))
    # An unknown card has no published peak: no roofline share.
    assert s.reader("k1_roofline.bulk").read(_run(_view(ops), "cpu")) is None


def test_k2_roofline_takes_the_slowest_card():
    s = spec.Spec.load(spec.PACKAGE.parent)
    chunk = 64 << 20
    bound, by = yardstick.k2_bound_ms(4, chunk, 3350.0, 450.0)
    assert by == "nvlink" and bound == pytest.approx(0.44739, rel=1e-4)
    ops = [Op("void (anonymous namespace)::bulk_gather<true>(a)", "kernel",
              d, 0, int((0.5 + 0.1 * d) * MS)) for d in range(4)]
    run = _run(_view(ops, devices=[0, 1, 2, 3]),
               mix={"chunk_bytes": chunk})
    assert s.reader("k2_roofline.gather").read(run) == pytest.approx(
        100 * bound / 0.8)
    missing_card = _run(_view(ops[:3], devices=[0, 1, 2, 3]),
                        mix={"chunk_bytes": chunk})
    assert s.reader("k2_roofline.gather").read(missing_card) is None


def test_end_to_end_readers():
    s = spec.Spec.load(spec.PACKAGE.parent)
    w = harness.Window(seconds=2.0, completed=100, bytes_per_call=1 << 20,
                       latencies_s=array.array("d", [i / 1e6 for i in
                                                     range(1, 201)]),
                       spans={"ring_all_gather": [1e-4, 3e-4]})
    run = _run(None, window=w)
    assert s.reader("calls_per_s").read(run) == 50.0
    assert s.reader("goodput_gbps").read(run) == pytest.approx(
        100 * (1 << 20) / 2 / 1e9)
    assert s.reader("gather_ms").read(run) == 20.0
    assert s.reader("p99_us.calls").read(run) == pytest.approx(198.0)
    assert s.reader("enqueue_us.gather").read(run) == pytest.approx(200.0)
    assert s.reader("setup_s").read(run) == 1.0


def test_inline_write_share_from_counter_deltas():
    s = spec.Spec.load(spec.PACKAGE.parent)
    run = harness.RunData({}, {}, {}, "x", [], 1.0, harness.Window(), None,
                          {"socket_inline_write_attempts": (100.0, 300.0),
                           "socket_inline_write_hits": (50.0, 200.0)})
    assert s.reader("inline_write_pct.calls").read(run) == 75.0
    run.counters["socket_inline_write_attempts"] = (5.0, 5.0)
    assert s.reader("inline_write_pct.calls").read(run) is None


def test_epoch_marks_the_profiled_slice():
    """`quiet(since)` holds only where the profiler neither ran nor started
    or stopped since `since` was read."""
    import time

    from rpcbench.tracer import Tracer

    t = Tracer(True, 0.05, False)
    t.begin_window(0.4)  # too short for START_S: the slice moves earlier
    assert t.start_s == pytest.approx(0.1)
    before = t.epoch
    assert t.quiet(before)
    seen_active = False
    start = time.perf_counter()
    while time.perf_counter() - start < 0.3:
        t.tick(0)
        if t.active:
            seen_active = True
            assert not t.quiet(t.epoch) and not t.quiet(before)
    t.stop(0)
    assert seen_active and t.epoch == before + 2
    assert not t.quiet(before) and t.quiet(t.epoch)


def test_traced_latencies_leave_out_the_slice(root):
    """In a traced run the calls the profiler touched give no latency; the
    rest do."""
    import time

    lines = []
    harness.run_cell(root, "echo_1k_d64", 13, 0.8, True,
                     t_start=time.perf_counter(), device="cpu",
                     overrides={"trace_slice_s": 0.2}, log=lines.append)
    samples = int(next(x for x in lines if x.startswith("latency samples"))
                  .split(":")[1])
    window = next(x for x in lines if x.startswith("window:"))
    completed = int(window.split(",")[1].split()[0])
    assert 0 < samples < completed


def test_progress_is_counted_every_interval(monkeypatch):
    monkeypatch.setattr(harness, "PROGRESS_S", 0.01)
    ctx = harness.Context({}, {}, {}, 1, 1.0, [], harness.Tracer(
        False, 1.0, False))
    w = harness.Window()
    ctx.begin_window(w)
    for n in range(1, 4):
        time.sleep(0.011)
        ctx.tick(10 * n)
    assert w.progress == [10, 20, 30]
