"""K1's batched landing on the CPU: the engage rule (`batched_landing`),
the chunking of a drained batch into launches (`land_chunks`), and
`EchoPipeline`'s bookkeeping on either path.  The launch itself runs on
the card only (tests/card/test_torch_echo_land_card.py); here the batched path
runs with a plain version of the launch that reads the landing buffers by
address, and a CPU payload keeps the per-call path and `echo_reference`."""

import contextlib
import ctypes
import itertools

import numpy as np
import pytest
import torch

import brpc_tpu_torch.rpc as port
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.models import echo as echo_mod
from brpc_tpu_torch.models.echo import (LANDED, LANDED_BATCHED,
                                        EchoPipeline)
from brpc_tpu_torch.ops import echo_kernel
from brpc_tpu_torch.ops.checksum import sum32
from brpc_tpu_torch.ops.echo_kernel import (LAND_BATCH_BELOW, LAND_MAX_CALLS,
                                            batched_landing, land_chunks)
from brpc_tpu_torch.rpc import observe
from brpc_tpu_torch.rpc.batch import _landing_bytes

CUDA = torch.device("cuda", 0)
HOSTS = [0x7F0000001000 + 4096 * i for i in range(4)]


def identity(host, device):
    """Every buffer mapped, read at its host address."""
    return host


@pytest.mark.parametrize("nbytes,engages", [
    (16, True), (1024, True), (256 * 1024, True),
    (LAND_BATCH_BELOW - 16, True), (LAND_BATCH_BELOW, False),
    (64 << 20, False), (1020, False), (0, False)])
def test_engages_below_one_mib_in_whole_lanes(nbytes, engages):
    got = batched_landing(CUDA, nbytes, HOSTS, mapped=identity)
    assert got == (HOSTS if engages else None)


def test_a_cpu_payload_never_engages():
    asked = []
    got = batched_landing(torch.device("cpu"), 1024, HOSTS,
                          mapped=lambda h, d: asked.append(h) or h)
    assert got is None and asked == []


def test_a_large_payload_asks_no_buffer():
    """The size rule decides first: a 64 MiB pipeline asks nothing of
    CUDA."""
    asked = []
    assert batched_landing(CUDA, 64 << 20, HOSTS,
                           mapped=lambda h, d: asked.append(h) or h) is None
    assert asked == []


@pytest.mark.parametrize("bad", [
    None,              # pageable memory: not device-mapped
    HOSTS[2] + 4,      # mapped, but out of K1's 16-byte phase
    HOSTS[2] + 8,
])
def test_one_unmapped_or_misaligned_buffer_falls_back(bad):
    def mapped(host, device):
        return bad if host == HOSTS[2] else host

    assert batched_landing(CUDA, 1024, HOSTS, mapped=mapped) is None


def test_mapped_addresses_need_not_be_the_host_addresses():
    got = batched_landing(CUDA, 1024, HOSTS,
                          mapped=lambda h, d: h + (1 << 40))
    assert got == [h + (1 << 40) for h in HOSTS]


@pytest.mark.parametrize("k,want", [
    (0, []),
    (1, [(0, 1)]),
    (63, [(0, 63)]),
    (64, [(0, 64)]),
    (65, [(0, 64), (64, 65)]),
    (128, [(0, 64), (64, 128)]),
    (200, [(0, 64), (64, 128), (128, 192), (192, 200)]),
])
def test_land_chunks(k, want):
    got = land_chunks(k)
    assert got == want
    assert all(0 < b - a <= LAND_MAX_CALLS for a, b in got)



@pytest.fixture(scope="module")
def server():
    srv = port.Server()
    srv.register_native_echo("Echo.Native")
    srv.start(0)
    yield srv
    srv.close()


def _counts():
    out = []
    for name in (LANDED, LANDED_BATCHED):
        try:
            out.append(int(observe.Vars.read(name)))
        except KeyError:
            out.append(0)
    return out


def _window(pipe, calls: int, depth: int) -> list:
    """A refill loop of `calls` completions at `depth` in flight."""
    done = []
    pipe.submit(depth)
    submitted = depth
    while len(done) < calls:
        got = pipe.poll(max_n=depth, timeout_ms=10000)
        assert got, "wedged"
        done += got
        k = min(len(got), calls - submitted)
        if k:
            pipe.submit(k)
            submitted += k
    assert pipe.inflight == 0
    return done


def test_cpu_payload_keeps_the_per_call_path(server):
    """A CPU payload lands call by call with the plain version; the
    gauges count every call landed and none batched."""
    arr = np.random.default_rng(31).integers(0, 1 << 32, size=256,
                                             dtype=np.uint32)
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    bufs = [torch.empty(1024, dtype=torch.uint8) for _ in range(8)]
    pipe = EchoPipeline(ch, payload_from_numpy(arr, "cpu"), bufs,
                        method="Echo.Native", rows=1, cols=256)
    before = _counts()
    try:
        assert pipe._mapped is None
        done = _window(pipe, 24, 8)
    finally:
        pipe.close()
        ch.close()
    landed, batched = (a - b for a, b in zip(_counts(), before))
    assert (landed, batched) == (24, 0)
    for back, got in done:
        assert int(got) == int(pipe.sent)
        np.testing.assert_array_equal(
            back.view(torch.int32).numpy().view(np.uint32), arr)


class _Event:
    """torch.cuda.Event's surface, on the CPU."""

    def __init__(self):
        self.waited = 0

    def record(self):
        pass

    def synchronize(self):
        self.waited += 1


def _plain_land(addrs, lanes, device):
    """echo_land_batch's result, read by address on the CPU."""
    rows = [torch.frombuffer(bytearray((ctypes.c_char * (lanes * 4))
                                       .from_address(a)), dtype=torch.int32)
            for a in addrs]
    out = torch.stack(rows) if rows else torch.empty((0, lanes),
                                                     dtype=torch.int32)
    sums = torch.stack([sum32(r.view(torch.uint32)).view(torch.int32)
                        for r in rows])
    return out.view(torch.uint32), sums.view(torch.uint32)


@pytest.fixture
def batched_on_cpu(monkeypatch):
    """EchoPipeline's batched path with its device parts stubbed: every
    buffer mapped at its host address, the launch's plain version, a
    no-op device scope and CPU events; yields the launches' sizes."""
    sizes = []

    def land(addrs, lanes, device):
        sizes.append(len(addrs))
        return _plain_land(addrs, lanes, device)

    monkeypatch.setattr(
        echo_mod, "batched_landing",
        lambda device, nbytes, hosts: list(hosts))
    monkeypatch.setattr(echo_mod, "echo_land_batch", land)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    return sizes


@pytest.mark.parametrize("landing", ["tensor", "rma"])
def test_batched_bookkeeping_on_cpu(server, batched_on_cpu, landing):
    """One plain launch a poll over the drained calls in drain order; each
    pair is a row and an element of that launch's output; the buffers the
    launch read go back to the free list behind one event a poll, which a
    reuse waits for; the gauges count every call batched."""
    arr = np.random.default_rng(32).integers(0, 1 << 32, size=256,
                                             dtype=np.uint32)
    want = int(sum32(payload_from_numpy(arr, "cpu")))
    if landing == "rma":
        bufs = [port.RmaBuffer(1024) for _ in range(8)]
    else:
        bufs = [torch.empty(1024, dtype=torch.uint8) for _ in range(8)]
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    pipe = EchoPipeline(ch, payload_from_numpy(arr, "cpu"), bufs,
                        method="Echo.Native", rows=1, cols=256)
    before = _counts()
    try:
        assert set(pipe._mapped) == {id(b) for b in bufs}
        assert set(pipe._mapped.values()) == {
            _landing_bytes(b).ctypes.data for b in bufs}
        done = _window(pipe, 40, 8)
        assert len(pipe._free) == 8
        events = {id(e): e for _, e in pipe._free}
        assert None not in events.values()
        assert len(events) <= len(batched_on_cpu)  # one a poll at most
    finally:
        pipe.close()
        ch.close()
        if landing == "rma":
            for b in bufs:
                b.free()
    landed, batched = (a - b for a, b in zip(_counts(), before))
    assert (landed, batched) == (40, 40)
    assert sum(batched_on_cpu) == 40 and all(batched_on_cpu)
    assert all(e.waited for e in events.values())  # close waits
    assert len(done) == 40
    for back, got in done:
        assert back.dtype == torch.uint32 and back.shape == (256,)
        assert got.dtype == torch.uint32 and got.dim() == 0
        assert int(got) == want
        np.testing.assert_array_equal(
            back.view(torch.int32).numpy().view(np.uint32), arr)


def test_batched_poll_with_a_failed_member(batched_on_cpu):
    """A failed member among a batched poll's completions: the others
    land in one launch, the failed one's buffer is retired, and the poll
    raises its typed error after handling them all."""
    srv = port.Server()
    calls = itertools.count()

    def second_fails(call, req):
        if next(calls) == 1:
            call.respond(error_code=7, error_text="second member rejected")
        else:
            call.respond(req)

    srv.register("Echo.SecondFails", second_fails)
    srv.start(0)
    arr = np.arange(256, dtype=np.uint32)
    bufs = [torch.empty(1024, dtype=torch.uint8) for _ in range(4)]
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=10000)
    pipe = EchoPipeline(ch, payload_from_numpy(arr, "cpu"), bufs,
                        method="Echo.SecondFails", rows=1, cols=256)
    try:
        pipe.submit(4)
        got = []
        with pytest.raises(port.RpcError) as err:
            while pipe.inflight:
                got += pipe.poll(max_n=4, timeout_ms=10000)
        assert err.value.code == 7
        while pipe.inflight:
            got += pipe.poll(max_n=4, timeout_ms=10000)
        assert len(pipe._free) == 3
        assert sum(batched_on_cpu) == 3
    finally:
        pipe.close()
        ch.close()
        srv.close()


def test_mapped_pointer_needs_the_card():
    """The mapping query is the kernel library's: without nvcc or a card it
    raises instead of guessing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests cover the query")
    with pytest.raises((RuntimeError, AssertionError)):
        echo_kernel.mapped_pointer(HOSTS[0], CUDA)
