"""QoS class streams on the card: a tagged `EchoPipeline` runs its device
work on its class's stream at the priority its lane gives; with a long
kernel queued on the bulk class's stream, a latency-class submit and poll
complete before it ends (an untagged pair, on the caller's stream, waits);
and echoes handed back from a class stream read correctly on the caller's
stream while the allocator reuses their memory.

Marked `card`: every test skips without a CUDA card.  On the card, run as
tests/card/conftest.py says."""

import time

import pytest
import torch

pytestmark = pytest.mark.card

SLEEP_S = 0.25  # the long kernel queued on the bulk class's stream


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def addr(card):
    from brpc_tpu_torch.rpc import Server

    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    yield f"127.0.0.1:{srv.port}"
    srv.stop()
    srv.close()


def _sleep_cycles(seconds: float) -> int:
    """`torch.cuda._sleep`'s cycles for about `seconds` on this card."""
    probe = 10_000_000
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(end))


def _pipe(addr, card, nbytes, depth, tenant=None, priority=0, seed=1):
    """A pipeline over a channel of its own (tagged when `tenant` is
    given), its payload and its pinned landing buffers."""
    from brpc_tpu_torch.models.echo import EchoPipeline
    from brpc_tpu_torch.rpc import Channel

    lanes = nbytes // 4
    payload = torch.randint(-(1 << 31), 1 << 31, (lanes,), dtype=torch.int32,
                            device=card,
                            generator=torch.Generator(card).manual_seed(seed))
    payload = payload.view(torch.uint32)
    kw = {} if tenant is None else {"qos_tenant": tenant,
                                    "qos_priority": priority}
    ch = Channel(addr, timeout_ms=60000,
                 connection_type="pooled" if nbytes >= 1 << 20 else "single",
                 **kw)
    bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(depth)]
    tile = (1, lanes) if nbytes < 1 << 20 else (16, 8192)
    pipe = EchoPipeline(ch, payload, bufs, rows=tile[0], cols=tile[1])
    return pipe, ch, payload


def _round(pipe, k: int) -> list:
    """k calls submitted and drained."""
    pipe.submit(k)
    out = []
    while len(out) < k:
        got = pipe.poll(max_n=k, timeout_ms=60000)
        assert got, "wedged"
        out += got
    return out


def _same(back, payload) -> bool:
    return torch.equal(back.view(torch.int32), payload.view(torch.int32))


def test_a_tagged_pipeline_runs_on_its_class_stream(card, addr):
    from brpc_tpu_torch.models.echo import (TENANT_DEVICE_WAIT_US,
                                            class_stream)
    from brpc_tpu_torch.rpc import observe

    fg, fg_ch, payload = _pipe(addr, card, 1024, 8, "cardfg", 0)
    bulk, bulk_ch, _ = _pipe(addr, card, 2 << 20, 2, "cardbulk", 3, seed=2)
    plain, plain_ch, _ = _pipe(addr, card, 1024, 8, seed=3)
    try:
        top = torch.cuda.Stream(card, priority=torch.cuda.Stream
                                .priority_range()[1]).priority
        assert top < 0
        assert fg._stream == class_stream(card, "cardfg", 0)
        assert fg._stream.priority == top
        assert bulk._stream.priority == 0
        assert plain._stream is None
        assert fg._stream != bulk._stream
        assert torch.cuda.current_stream(card) not in (fg._stream,
                                                       bulk._stream)
        _round(fg, 4)  # warm
        # A kernel queued on the class's own stream holds the landing
        # launch and event of the next round; the round after it takes
        # those buffers, and its reuse wait synchronises that event.
        name = TENANT_DEVICE_WAIT_US.format("cardfg")
        waited = int(observe.Vars.read(name))
        with torch.cuda.stream(fg._stream):
            torch.cuda._sleep(_sleep_cycles(SLEEP_S))
        t0 = time.perf_counter()
        out = _round(fg, 4) + _round(fg, 4)
        took = time.perf_counter() - t0
        assert took >= 0.8 * SLEEP_S
        assert int(observe.Vars.read(name)) - waited >= 0.8 * SLEEP_S * 1e6
        assert all(_same(b, payload) for b, _ in out)
    finally:
        for p, c in ((fg, fg_ch), (bulk, bulk_ch), (plain, plain_ch)):
            p.close()
            c.close()


def test_the_staging_synchronise_counts_once(card, addr):
    """A tagged pipeline stages its request in its constructor, on its
    class stream: a kernel queued there holds that one synchronise, which
    the tenant's device wait counts; its submits stage nothing."""
    from brpc_tpu_torch.models.echo import (STAGED, TENANT_DEVICE_WAIT_US,
                                            class_stream)
    from brpc_tpu_torch.rpc import observe

    name = TENANT_DEVICE_WAIT_US.format("stagefg")
    fg, fg_ch, _ = _pipe(addr, card, 1024, 8, "stagefg", 0)  # warm
    fg.close()
    fg_ch.close()
    waited = int(observe.Vars.read(name))
    staged = int(observe.Vars.read(STAGED))
    with torch.cuda.stream(class_stream(card, "stagefg", 0)):
        torch.cuda._sleep(_sleep_cycles(SLEEP_S))
    fg, fg_ch, payload = _pipe(addr, card, 1024, 8, "stagefg", 0, seed=7)
    try:
        assert int(observe.Vars.read(name)) - waited >= 0.8 * SLEEP_S * 1e6
        assert int(observe.Vars.read(STAGED)) - staged == 1
        out = [pair for _ in range(4) for pair in _round(fg, 4)]
        assert int(observe.Vars.read(STAGED)) - staged == 1
        assert all(_same(b, payload) for b, _ in out)
    finally:
        fg.close()
        fg_ch.close()


@pytest.mark.parametrize("tagged", [True, False])
def test_head_of_line_freedom(card, addr, tagged):
    """A long kernel on the bulk class's stream: the latency class's
    submit and poll complete before it ends, and its echoes read right on
    the caller's stream meanwhile.  Untagged, both pipelines share the
    caller's stream and the latency class waits for the kernel."""
    fg, fg_ch, payload = _pipe(addr, card, 1024, 16,
                               "holfg" if tagged else None, 0)
    bulk, bulk_ch, _ = _pipe(addr, card, 2 << 20, 2,
                             "holbulk" if tagged else None, 3, seed=4)
    try:
        _round(fg, 16)
        _round(bulk, 2)
        torch.cuda.synchronize()
        bulk_stream = bulk._stream or torch.cuda.current_stream(card)
        with torch.cuda.stream(bulk_stream):
            torch.cuda._sleep(_sleep_cycles(SLEEP_S))
            ended = torch.cuda.Event()
            ended.record()
        t0 = time.perf_counter()
        out = _round(fg, 16)
        torch.cuda.current_stream(card).synchronize()
        took = time.perf_counter() - t0
        if tagged:
            assert not ended.query(), f"the latency class took {took:.3f} s"
            assert took < 0.5 * SLEEP_S
            assert all(_same(b, payload) for b, _ in out)
            assert not ended.query()
        else:
            assert took >= 0.8 * SLEEP_S
            assert all(_same(b, payload) for b, _ in out)
        torch.cuda.synchronize()
    finally:
        for p, c in ((fg, fg_ch), (bulk, bulk_ch)):
            p.close()
            c.close()


@pytest.mark.parametrize("nbytes", [1024, 2 << 20])
def test_echoes_read_right_on_the_callers_stream(card, addr, nbytes):
    """Each round's echoes are copied on the caller's stream behind a
    kernel there and dropped at once; the class stream's next round
    allocates while those copies wait.  Every copy equals the payload."""
    pipe, ch, payload = _pipe(addr, card, nbytes, 4, "reusefg", 0, seed=6)
    copies = []
    try:
        cycles = _sleep_cycles(0.005)
        for _ in range(12):
            out = _round(pipe, 4)
            torch.cuda._sleep(cycles)  # the caller's stream lags behind
            copies += [b.clone() for b, _ in out]
            sums = [g.clone() for _, g in out]
            del out
        torch.cuda.synchronize()
        assert all(_same(c, payload) for c in copies)
        assert all(int(s) == int(pipe.sent) for s in sums)
    finally:
        pipe.close()
        ch.close()
