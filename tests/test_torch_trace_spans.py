"""The port's host spans and the batch pipeline's queue counters.

`observe.span` is a `torch.profiler` range while a profiler records and one
shared no-op otherwise; `EchoPipeline` and `Batch` open theirs
(`trpc.echo.*`, `trpc.batch.*`) nested on the caller's thread.  Each poll
that drains adds to the process-wide `rpc_client_batch_drained` and
`rpc_client_batch_held_us` (the host's submit to the poll's return, summed
over the drained calls).  The K2 spans (`trpc.k2.*`) need a card and are
checked by the card tests of `rpcbench/tests`."""

import time

import numpy as np
import pytest
import torch
import torch.profiler as tp

import brpc_tpu_torch.rpc as port
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.models.echo import EchoPipeline
from brpc_tpu_torch.ops.echo_kernel import _BLOCK
from brpc_tpu_torch.rpc import observe
from brpc_tpu_torch.rpc.batch import DRAINED, HELD_US

COUNTERS = (DRAINED, HELD_US)
#: Each echo span and the span it opens inside.
PARENT = {
    "trpc.echo.reuse_wait": "trpc.echo.submit",
    "trpc.batch.stage": "trpc.echo.submit",
    "trpc.batch.issue": "trpc.echo.submit",
    "trpc.batch.wait": "trpc.echo.poll",
    "trpc.echo.land": "trpc.echo.poll",
    "trpc.echo.check": "trpc.echo.poll",
}


@pytest.fixture(scope="module")
def server():
    srv = port.Server()
    srv.register_native_echo("Echo.Native")
    srv.start(0)
    yield srv
    srv.close()


@pytest.fixture
def channel(server):
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    yield ch
    ch.close()


def _counters() -> dict:
    return {n: int(observe.Vars.read(n)) for n in COUNTERS}


def _program_spans(prof) -> list:
    """(name, thread, start_us, end_us) of the trpc.* ranges recorded."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("trpc.")]


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not observe.profiling()
    first = observe.span("trpc.test.a")
    assert first is observe.span("trpc.test.b")
    with first:
        pass
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        assert observe.profiling()
        assert observe.span("trpc.test.a") is not first
        with observe.span("trpc.test.a"):
            pass
    assert not observe.profiling()
    assert [e.name for e in prof.events()].count("trpc.test.a") == 1


def test_echo_pipeline_spans_nest_on_the_callers_thread(channel):
    payload = payload_from_numpy(np.arange(_BLOCK, dtype=np.uint32), "cpu")
    bufs = [torch.empty(_BLOCK * 4, dtype=torch.uint8) for _ in range(4)]
    pipe = EchoPipeline(channel, payload, bufs, method="Echo.Native")
    done = 0
    try:
        with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
            pipe.submit(4)
            while done < 6:
                got = pipe.poll(max_n=4, timeout_ms=10000)
                assert got, "wedged"
                done += len(got)
                if done <= 4:
                    pipe.submit(min(len(got), 6 - done))
    finally:
        pipe.close()
    spans = _program_spans(prof)
    names = {s[0] for s in spans}
    assert names == set(PARENT) | set(PARENT.values())
    assert len({s[1] for s in spans}) == 1  # one thread
    for name, _, start, end in spans:
        if name in PARENT:
            assert any(p == PARENT[name] and ps <= start and end <= pe
                       for p, _, ps, pe in spans), name
    for per_call in ("trpc.echo.land", "trpc.echo.check"):
        assert sum(s[0] == per_call for s in spans) == done


@pytest.mark.parametrize("k", [1, 5])
def test_drained_counts_every_polled_call(channel, k):
    pipe = channel.pipeline()
    try:
        before = _counters()
        pipe.submit("Echo.Native", [b"x" * 64] * k)
        done = 0
        deadline = time.monotonic() + 15
        while done < k and time.monotonic() < deadline:
            done += len(pipe.poll(max_n=k, timeout_ms=2000))
        after = _counters()
    finally:
        pipe.close()
    assert done == k
    delta = {n: after[n] - before[n] for n in COUNTERS}
    assert delta[DRAINED] == k
    assert delta[HELD_US] >= 0
    text = observe.Vars.prometheus()
    for name in COUNTERS:
        assert f"# HELP {name}" in text


def test_ring_time_counts_the_wait_for_the_poll(channel):
    pipe = channel.pipeline()
    try:
        pipe.submit("Echo.Native", [b"y" * 64])
        deadline = time.monotonic() + 15
        while pipe.inflight and time.monotonic() < deadline:
            time.sleep(0.001)
        assert not pipe.inflight, "the call never completed"
        before = _counters()
        time.sleep(0.05)
        assert len(pipe.poll(max_n=1, timeout_ms=2000)) == 1
        after = _counters()
    finally:
        pipe.close()
    assert after[DRAINED] - before[DRAINED] == 1
    # Completed before the sleep: at least 45 ms of it waited for the poll.
    assert after[HELD_US] - before[HELD_US] >= 45_000
