"""The readers of the echo pipeline's calling-thread clocks
(rpcbench/main_thread.py) on fabricated runs: each reads nothing without
its gauges, and computes its arithmetic with them."""

import pytest

from rpcbench import harness, main_thread, spec

SPEC = spec.Spec.load(spec.PACKAGE.parent)
READERS = ("poll_us_per_call.calls", "submit_us_per_call.calls",
           "caller_us_per_call.calls", "calls_per_poll.calls",
           "host_oncpu_pct.calls")
CALLS = 1000
#: Window changes of the gauges over a 0.1 s window of CALLS calls.
DELTAS = {
    main_thread.POLLS: 125,                # 8 calls a poll
    main_thread.LANDED: CALLS,
    main_thread.SUBMITTED: CALLS,
    main_thread.POLL_NS: 20_000_000,       # 20 us a call
    main_thread.POLL_WAIT_NS: 30_000_000,  # 30 us
    main_thread.SUBMIT_NS: 10_000_000,     # 10 us
    main_thread.HOST_CPU_NS: 90_000_000,   # 0.09 of the thread's 0.1 s
    main_thread.HOST_CPU_WALL_NS: 100_000_000,
}
WANT = {"poll_us_per_call.calls": 20.0, "submit_us_per_call.calls": 10.0,
        "caller_us_per_call.calls": 40.0, "calls_per_poll.calls": 8.0,
        "host_oncpu_pct.calls": 90.0}


def _run(deltas, seconds=0.1, completed=CALLS):
    counters = {n: (None, None) if d is None else (7, 7 + d)
                for n, d in deltas.items()}
    window = harness.Window(seconds=seconds, completed=completed)
    return harness.RunData({}, {}, {}, "cpu", [], 1.0, window, None,
                           counters)


@pytest.mark.parametrize("name", READERS)
def test_reader_arithmetic_and_absent_gauges(name):
    reader = SPEC.reader(name)
    assert set(reader.COUNTERS) <= set(DELTAS)
    assert reader.read(_run(DELTAS)) == pytest.approx(WANT[name])
    # A program without any one of its gauges (the parent) reads nothing.
    for missing in reader.COUNTERS:
        assert reader.read(_run(dict(DELTAS, **{missing: None}))) is None
    assert reader.read(_run({})) is None


@pytest.mark.parametrize("name, zero", [
    ("poll_us_per_call.calls", main_thread.LANDED),
    ("submit_us_per_call.calls", main_thread.SUBMITTED),
    ("calls_per_poll.calls", main_thread.POLLS),
    ("host_oncpu_pct.calls", main_thread.HOST_CPU_WALL_NS)])
def test_a_window_that_counted_nothing_reads_nothing(name, zero):
    assert SPEC.reader(name).read(_run(dict(DELTAS, **{zero: 0}))) is None


def test_caller_and_oncpu_need_a_window_and_a_stretch():
    caller = SPEC.reader("caller_us_per_call.calls")
    assert caller.read(_run(DELTAS, completed=0)) is None
    assert caller.read(_run(DELTAS, seconds=0.0)) is None
    no_stretch = dict(DELTAS, **{main_thread.HOST_CPU_NS: 0,
                                 main_thread.HOST_CPU_WALL_NS: 0})
    assert SPEC.reader("host_oncpu_pct.calls").read(_run(no_stretch)) is None


@pytest.mark.parametrize("seconds", [0.06, 0.1, 2.5])
def test_the_split_adds_up_to_the_window_per_call(seconds):
    """poll + wait + submit + caller is the window per call, when every
    call submitted was landed and completed."""
    run = _run(DELTAS, seconds=seconds)
    wait_us = DELTAS[main_thread.POLL_WAIT_NS] / CALLS / 1000
    split = (main_thread.poll_us(run) + wait_us + main_thread.submit_us(run)
             + main_thread.caller_us(run))
    assert split == pytest.approx(seconds * 1e6 / CALLS)


def test_the_metrics_are_entries_of_the_one_kibibyte_cell():
    entries = {m["name"]: m for m in SPEC.bench["per_layer"]}
    layers = {entries[n]["layer"] for n in READERS}
    assert len(layers) == 1
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == ["echo_1k_d64"]
        assert (m["moves"], m["source"]) == ("calls_per_s", "program_counter")
    assert [m["name"] for m in SPEC.per_layer("echo_1k_d64")][-5:] == list(
        READERS)
