"""EchoPipeline's clocks of its calling thread, taken without a profiler.

Each `poll` adds its wall time less the native wait (`trpc_echo_poll_ns`),
that wait (`trpc_echo_poll_wait_ns`, stamped inside `Batch.poll` when given
`waited`), and each poll that lands calls one to `trpc_echo_polls`; each
`submit` its wall time.  A pipeline adds its sums to the gauges at its
flushes, and a flush at least `CPU_READ_NS` after the thread last read its
CPU clock adds the thread's CPU and wall time since then.  Driven here with CPU payloads over the native echo
server, at 1 KiB (the runtime copies the request) and above
`COPY_REQUEST_MAX` (a pin a call)."""

import threading
import time

import numpy as np
import pytest
import torch

import brpc_tpu_torch.rpc as port
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.models import echo
from brpc_tpu_torch.models.echo import (HOST_CPU_NS, HOST_CPU_WALL_NS, LANDED,
                                        POLL_NS, POLL_WAIT_NS, POLLS,
                                        SUBMIT_NS, SUBMITTED, EchoPipeline)
from brpc_tpu_torch.rpc import observe
from brpc_tpu_torch.rpc.batch import COPY_REQUEST_MAX

GAUGES = (POLLS, POLL_NS, POLL_WAIT_NS, SUBMIT_NS, HOST_CPU_NS,
          HOST_CPU_WALL_NS, LANDED, SUBMITTED)
MS = 1_000_000  # ns


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


def _read() -> dict:
    return {n: int(observe.Vars.read(n)) for n in GAUGES}


@pytest.mark.parametrize("pipes", [1, 2])
@pytest.mark.parametrize("nbytes", [1024, 2 * COPY_REQUEST_MAX])
def test_poll_and_submit_clocks_cover_the_loop_once(channel, nbytes, pipes,
                                                    monkeypatch):
    """Over a refill loop on one thread (one pipeline, or two in turn) with
    empty polls among the full ones, polls that land several calls, and a
    poll that waits out its timeout, read once the loop has drained: the
    polls that landed calls are counted exactly, landed over polls is the
    mean the loop saw, every clock grows, the counted sections fit inside
    the loop's own wall time, and so do the thread's stretches between
    flushes (one stretch a time, whichever pipeline flushes), whose CPU
    time lies inside their wall time less the blocked poll."""
    monkeypatch.setattr(echo, "_thread_clock", threading.local())
    monkeypatch.setattr(echo, "CLOCK_FLUSH_POLLS", 2)  # flushes interleave
    monkeypatch.setattr(echo, "CPU_READ_NS", 0)  # each reads the CPU clock
    lanes, depth, calls = nbytes // 4, 8, 48
    arr = np.random.default_rng(nbytes).integers(0, 1 << 32, size=lanes,
                                                 dtype=np.uint32)
    made = [EchoPipeline(channel, payload_from_numpy(arr, "cpu"),
                         [torch.empty(nbytes, dtype=torch.uint8)
                          for _ in range(depth)],
                         method="Echo.Native", rows=1, cols=lanes)
            for _ in range(pipes)]
    assert made[0]._prep.copied == (nbytes <= COPY_REQUEST_MAX)
    sizes = []  # calls each delivering poll landed
    before = _read()
    t0 = time.perf_counter_ns()
    try:
        for pipe in made:
            pipe.submit(depth)
        submitted = depth * pipes
        while sum(sizes) < calls:
            if len(sizes) % 2:
                time.sleep(0.005)  # let several calls finish for one poll
            pipe = made[len(sizes) % pipes]
            for timeout_ms in (0, 10000):
                got = pipe.poll(max_n=depth, timeout_ms=timeout_ms)
                if got:
                    sizes.append(len(got))
                    break
            assert got, "wedged"
            k = min(len(got), calls - submitted)
            if k:
                pipe.submit(k)
                submitted += k
        for pipe in made:  # the rest of the calls in flight
            while pipe.inflight:
                got = pipe.poll(max_n=depth, timeout_ms=10000)
                assert got, "wedged"
                sizes.append(len(got))
        # Nothing in flight: a poll that waits out its timeout.
        assert made[0].poll(max_n=depth, timeout_ms=200) == []
        loop_ns = time.perf_counter_ns() - t0
        after = _read()  # drained, not yet closed: as the harness reads
    finally:
        for pipe in made:
            pipe.close()
    d = {n: a - before[n] for n, a in after.items()}
    assert d[LANDED] == d[SUBMITTED] == sum(sizes) == submitted
    assert d[POLLS] == len(sizes) and max(sizes) > 1
    assert d[LANDED] / d[POLLS] == pytest.approx(np.mean(sizes))
    for name in (POLL_NS, POLL_WAIT_NS, SUBMIT_NS, HOST_CPU_NS,
                 HOST_CPU_WALL_NS):
        assert d[name] > 0, name
    assert d[POLL_WAIT_NS] >= 190 * MS
    assert d[POLL_NS] + d[POLL_WAIT_NS] + d[SUBMIT_NS] <= loop_ns
    assert d[HOST_CPU_WALL_NS] <= loop_ns
    # the 200 ms poll blocked inside a stretch, off the CPU
    assert d[HOST_CPU_NS] <= d[HOST_CPU_WALL_NS] - 100 * MS
    text = observe.Vars.prometheus()
    for name in GAUGES:
        assert f"# HELP {name}" in text, name


def test_the_cpu_clock_is_read_once_a_period(channel, monkeypatch):
    """However often pipelines flush, a thread reads its CPU clock (a
    system call) once a CPU_READ_NS: here once in a loop shorter than it,
    so the CPU gauges do not move."""
    monkeypatch.setattr(echo, "_thread_clock", threading.local())
    monkeypatch.setattr(echo, "CLOCK_FLUSH_POLLS", 1)
    monkeypatch.setattr(echo, "CPU_READ_NS", 60_000 * MS)
    reads = []
    clock = time.thread_time_ns
    monkeypatch.setattr(echo.time, "thread_time_ns",
                        lambda: reads.append(1) or clock())
    arr = np.arange(256, dtype=np.uint32)
    pipe = EchoPipeline(channel, payload_from_numpy(arr, "cpu"),
                        [torch.empty(1024, dtype=torch.uint8)
                         for _ in range(4)],
                        method="Echo.Native", rows=1, cols=256)
    before = _read()
    try:
        for _ in range(8):
            pipe.submit(4)
            while pipe.inflight:
                assert pipe.poll(max_n=4, timeout_ms=10000), "wedged"
        after = _read()
    finally:
        pipe.close()
    assert after[POLLS] - before[POLLS] >= 8  # as many flushes
    assert len(reads) == 1
    for name in (HOST_CPU_NS, HOST_CPU_WALL_NS):
        assert after[name] == before[name], name


def test_a_stamped_poll_holds_its_native_wait(channel):
    """`Batch.poll(waited=...)` stamps the native poll's start and return:
    a poll that times out after 50 ms holds the timeout between them;
    without `waited` nothing is stamped."""
    pipe = channel.pipeline()
    try:
        waited = [0, 0]
        assert pipe.poll(max_n=1, timeout_ms=50, waited=waited) == []
        assert waited[1] - waited[0] >= 45 * MS
        again = list(waited)
        assert pipe.poll(max_n=1, timeout_ms=0) == []
        assert waited == again
        wall = [0, 0]
        pipe.poll(max_n=1, timeout_ms=0, waited=wall)
        assert again[1] < wall[0] <= wall[1]
    finally:
        pipe.close()
