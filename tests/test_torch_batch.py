"""Port parity: the batched submit/poll pipeline of brpc_tpu_torch.rpc
(Batch, Completion, ZeroCopyResponse, call_batch, pinned_requests) against
brpc_tpu.rpc's, both driving the same native server, and the pipelined echo
data plane (`rpc_batch_echo_step`) on the CPU against JAX sum32.  Mirrors the
batch cases of tests/test_rpc_python.py; the port-only cases hold tensors at
the boundary: CPU tensors submitted by reference, responses landing in and
viewed as tensors."""

import errno
import gc
import itertools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.ops.checksum import sum32 as jax_sum32
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.models.echo import EchoPipeline, rpc_batch_echo_step
from brpc_tpu_torch.ops.echo_kernel import _BLOCK
from brpc_tpu_torch.rpc import batch as port_batch
from brpc_tpu_torch.rpc import zerocopy

PKGS = {"reference": ref, "port": port}


def _drained() -> bool:
    # The write fiber drops the last IOBuf reference a hair after the
    # response lands; the pin registry must drain to zero.
    deadline = time.monotonic() + 10
    while port_batch.pinned_requests() > 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    return port_batch.pinned_requests() == 0


def _poll_all(pipe, n, timeout_s=15.0) -> dict:
    done = {}
    deadline = time.monotonic() + timeout_s
    while len(done) < n and time.monotonic() < deadline:
        for c in pipe.poll(timeout_ms=2000):
            assert c.token not in done  # exactly once
            done[c.token] = c
    assert len(done) == n, f"{len(done)} of {n} completions"
    return done


@pytest.fixture(scope="module")
def server():
    srv = port.Server()

    def maybe_fail(call, req):
        if req.startswith(b"fail"):
            call.respond(error_code=7, error_text="member rejected")
        else:
            call.respond(req)

    srv.register("Echo.Echo", lambda call, req: call.respond(req))
    srv.register("Echo.MaybeFail", maybe_fail)
    srv.register_native_echo("Echo.Native")
    srv.start(0)
    yield srv
    srv.close()


@pytest.fixture
def second_fails_server():
    """An echo server that rejects the second call it receives."""
    srv = port.Server()
    calls = itertools.count()

    def second_fails(call, req):
        if next(calls) == 1:
            call.respond(error_code=7, error_text="second member rejected")
        else:
            call.respond(req)

    srv.register("Echo.SecondFails", second_fails)
    srv.start(0)
    try:
        yield srv
    finally:
        srv.close()


@pytest.fixture
def delayed_server():
    """A native echo server whose every dispatch parks `delay_ms`."""
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    try:
        yield srv
    finally:
        srv.set_faults("")
        srv.close()


@pytest.mark.parametrize("method", ["Echo.Echo", "Echo.Native"])
def test_call_batch_ordering_and_correlation(server, method):
    addr = f"127.0.0.1:{server.port}"
    reqs = [f"member-{i}".encode() * (1 + i % 5) for i in range(32)]
    got = {}
    for name, mod in PKGS.items():
        ch = mod.Channel(addr, timeout_ms=10000)
        try:
            b = ch.pipeline()
            tokens = b.submit(method, reqs)
            assert tokens == sorted(tokens)  # FIFO token order per channel
            done = _poll_all(b, len(tokens))
            got[name] = [done[t].tobytes() for t in tokens]
            b.close()
            assert ch.call_batch(method, reqs) == reqs
        finally:
            ch.close()
    assert got["port"] == got["reference"] == reqs


def test_call_batch_error_isolation_matches_reference(server):
    addr = f"127.0.0.1:{server.port}"
    reqs = [b"ok-a", b"fail-1", b"ok-b", b"fail-2", b"ok-c"]
    got = {}
    for name, mod in PKGS.items():
        ch = mod.Channel(addr, timeout_ms=10000)
        try:
            res = ch.call_batch("Echo.MaybeFail", reqs)
        finally:
            ch.close()
        got[name] = [(type(r).__name__, r.code, r.text)
                     if isinstance(r, Exception) else r for r in res]
        assert all(isinstance(r, mod.RpcError) for r in res
                   if not isinstance(r, bytes))
    assert got["port"] == got["reference"]
    assert got["port"][1] == ("RpcError", 7, "member rejected")


@pytest.mark.parametrize("kind", ["numpy", "tensor", "bytearray"])
def test_response_buffers_match_reference(server, kind):
    """Responses land in caller buffers natively on both packages: the same
    bytes, the same in_caller_buffer flags, no data object."""
    addr = f"127.0.0.1:{server.port}"
    payloads = [np.arange(256 * (i + 1), dtype=np.uint32) for i in range(4)]
    make = {"numpy": lambda n: np.zeros(n, dtype=np.uint8),
            "tensor": lambda n: torch.zeros(n, dtype=torch.uint8),
            "bytearray": bytearray}[kind]
    got = {}
    for name, mod in PKGS.items():
        if name == "reference" and kind == "tensor":
            bufs = [np.zeros(p.nbytes, dtype=np.uint8) for p in payloads]
        else:
            bufs = [make(p.nbytes) for p in payloads]
        ch = mod.Channel(addr, timeout_ms=10000)
        b = ch.pipeline()
        try:
            tokens = b.submit("Echo.Native", payloads, resp_bufs=bufs)
            done = _poll_all(b, len(tokens))
            got[name] = [(done[t].ok, done[t].in_caller_buffer,
                          done[t].data is None, done[t].resp_len,
                          bytes(memoryview(np.asarray(buf)).cast("B")))
                         for t, buf in zip(tokens, bufs)]
        finally:
            b.close()
            ch.close()
    assert got["port"] == got["reference"]
    for (ok, in_buf, no_data, n, data), p in zip(got["port"], payloads):
        assert ok and in_buf and no_data and n == p.nbytes
        assert data == p.tobytes()


def test_mixed_landing_and_view_flags_match_reference(server):
    """Entries without a landing buffer ride out as ZeroCopyResponses on
    both packages, the others land: per-entry flags equal."""
    addr = f"127.0.0.1:{server.port}"
    reqs = [bytes([i]) * (100 + i) for i in range(4)]
    got = {}
    for name, mod in PKGS.items():
        bufs = [bytearray(len(r)) if i % 2 else None
                for i, r in enumerate(reqs)]
        ch = mod.Channel(addr, timeout_ms=10000)
        b = ch.pipeline()
        try:
            tokens = b.submit("Echo.Native", reqs, resp_bufs=bufs)
            done = _poll_all(b, len(tokens))
            got[name] = [(done[t].in_caller_buffer,
                          bytes(buf) if buf is not None
                          else done[t].tobytes())
                         for t, buf in zip(tokens, bufs)]
        finally:
            b.close()
            ch.close()
    assert got["port"] == got["reference"]
    assert [f for f, _ in got["port"]] == [False, True, False, True]
    assert [d for _, d in got["port"]] == reqs


def test_zero_copy_response_view_and_tensor_pin_blocks(server):
    """A memoryview or tensor exported from a ZeroCopyResponse keeps the
    pool blocks alive after every other reference is collected; the tensor
    sits on the response block itself (pointer identity)."""
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    b = ch.pipeline()
    try:
        payload = b"pin-these-bytes" * 100
        b.submit("Echo.Echo", [payload, payload])
        c1, c2 = _poll_all(b, 2).values()
        assert c1.ok and c2.ok
        mv = c1.data.view()
        t = c2.data.tensor()
        assert t.dtype == torch.uint8 and t.numel() == len(payload)
        assert t.data_ptr() == zerocopy.block_ptr(c2.data._ptr)
        del c1, c2
        gc.collect()
        assert bytes(mv) == payload
        assert t.numpy().tobytes() == payload
        del mv, t
        gc.collect()
    finally:
        b.close()
        ch.close()


def test_cpu_tensor_requests_enter_by_reference(delayed_server):
    """`[t] * k` with a CPU tensor: every entry is pinned over the tensor's
    own memory (no copy), each with its own deleter ctx; the pins drop once
    the runtime releases the requests."""
    delayed_server.set_faults("svr_delay=1:300")
    ch = port.Channel(f"127.0.0.1:{delayed_server.port}", timeout_ms=10000)
    b = ch.pipeline()
    try:
        t = torch.arange(1 << 14, dtype=torch.int32)
        assert _drained()
        with zerocopy._lock:
            before = set(zerocopy._live)
        tokens = b.submit("Echo.Echo", [t] * 4)
        with zerocopy._lock:
            pins = {k: v for k, v in zerocopy._live.items()
                    if k not in before}
        assert len(pins) == 4  # one deleter ctx per entry
        for flat, _owner, req in pins.values():
            assert flat.ctypes.data == t.data_ptr()  # the tensor's memory
            assert req is t
        done = _poll_all(b, len(tokens))
        for c in done.values():
            assert c.ok and c.tobytes() == t.numpy().tobytes()
    finally:
        b.close()
        ch.close()
    assert _drained()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the staging rule
    of Batch.submit without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_one_host_copy_per_distinct_gpu_tensor(server, monkeypatch):
    """A GPU tensor named k times in one submit is copied to the host once
    (the copy pinned k times), two distinct ones twice."""
    staged = []

    def host_view(tensor):
        staged.append(tensor)
        flat = torch.Tensor.contiguous(tensor).reshape(-1).view(torch.uint8)
        host = flat.as_subclass(torch.Tensor).clone()
        return host.numpy(), host

    monkeypatch.setattr(zerocopy, "host_view", host_view)
    a = torch.arange(256, dtype=torch.int32).as_subclass(_FakeCuda)
    c = (torch.arange(256, dtype=torch.int32) * 3).as_subclass(_FakeCuda)
    assert a.device.type == "cuda"
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    try:
        res = ch.call_batch("Echo.Native", [a] * 4 + [c] * 2)
    finally:
        ch.close()
    assert len(staged) == 2
    want_a = torch.arange(256, dtype=torch.int32).numpy().tobytes()
    assert res[:4] == [want_a] * 4
    assert res[4:] == [(torch.arange(256, dtype=torch.int32) * 3).numpy()
                       .tobytes()] * 2
    assert _drained()


@pytest.mark.parametrize("bad", [
    lambda n: b"\0" * n,                                  # read-only
    lambda n: torch.zeros(2 * n, dtype=torch.uint8)[::2],  # non-contiguous
])
def test_bad_landing_buffers_raise_without_leaking_pins(server, bad):
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=5000)
    b = ch.pipeline()
    try:
        assert _drained()
        with pytest.raises(ValueError):
            b.submit("Echo.Echo", [b"x" * 64], resp_bufs=[bad(64)])
        with pytest.raises(ValueError):
            b.submit("Echo.Echo", [b"x", b"y"], resp_bufs=[None])
        assert port_batch.pinned_requests() == 0
        assert b.outstanding == 0
    finally:
        b.close()
        ch.close()


def test_batch_cancel_mid_batch(delayed_server):
    delayed_server.set_faults("svr_delay=1:600")
    ch = port.Channel(f"127.0.0.1:{delayed_server.port}", timeout_ms=10000)
    b = ch.pipeline()
    try:
        tokens = b.submit("Echo.Echo", [b"a", b"b", b"c", b"d"])
        time.sleep(0.1)  # members are parked server-side now
        assert b.cancel(tokens[1]) is True
        assert b.cancel(10**9) is False  # unknown token
        done = _poll_all(b, 4)
        assert done[tokens[1]].status == errno.ECANCELED
        for t in (tokens[0], tokens[2], tokens[3]):
            assert done[t].ok, (done[t].status, done[t].error)
        assert b.cancel(tokens[1]) is False  # a polled token is gone
    finally:
        b.close()
        ch.close()


def test_batch_poll_after_channel_close(server):
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    b = port.Batch(ch)
    try:
        tokens = b.submit("Echo.Native", [b"first", b"second"])
        deadline = time.monotonic() + 10
        while b.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert b.inflight == 0 and b.outstanding == 2
        ch.close()
        done = _poll_all(b, 2)
        assert done[tokens[0]].tobytes() == b"first"
        assert done[tokens[1]].tobytes() == b"second"
    finally:
        b.close()
    with pytest.raises(ValueError):
        b.poll(timeout_ms=0)


def test_batch_close_wakes_parked_poller(server):
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=5000)
    b = ch.pipeline()
    results = []

    def poller():
        try:
            results.append(b.poll(timeout_ms=-1))
        except ValueError:
            results.append("closed")

    t = threading.Thread(target=poller)
    t.start()
    time.sleep(0.2)  # the poller is parked in the native wait by now
    b.close()
    t.join(timeout=10)
    assert not t.is_alive(), "parked poller never woke after close()"
    assert results == [[]] or results == ["closed"]
    ch.close()


def test_channel_close_settles_explicit_pipelines(delayed_server):
    delayed_server.set_faults("svr_delay=1:800")
    ch = port.Channel(f"127.0.0.1:{delayed_server.port}", timeout_ms=10000)
    p = ch.pipeline()
    try:
        tokens = p.submit("Echo.Echo", [b"a", b"b", b"c"])
        time.sleep(0.1)
        ch.close()  # members in flight: must settle them, not crash
        got = _poll_all(p, 3, timeout_s=10)
        assert set(got) == set(tokens)
        for c in got.values():
            assert c.status in (0, errno.ECANCELED), (c.status, c.error)
    finally:
        p.close()


def test_batch_poll_releases_gil():
    """A deep poll sleeps OUTSIDE the GIL: the handler producing the
    response is a Python callback, and a background thread keeps ticking
    while the poller is parked."""
    srv = port.Server()

    def delayed_echo(call, req):
        time.sleep(0.4)
        call.respond(req)

    srv.register("Echo.Delayed", delayed_echo)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=10000)
    ticks = []
    stop = threading.Event()

    def ticker():
        while not stop.is_set():
            ticks.append(time.monotonic())
            time.sleep(0.005)

    t = threading.Thread(target=ticker)
    t.start()
    try:
        b = ch.pipeline()
        tokens = b.submit("Echo.Delayed", [b"gil-probe"])
        done = b.poll(max_n=8, timeout_ms=10000)
        assert [c.token for c in done] == tokens
        assert done[0].ok and done[0].tobytes() == b"gil-probe"
        b.close()
    finally:
        stop.set()
        t.join(timeout=10)
        ch.close()
        srv.close()
    assert len(ticks) >= 10


def test_default_pipeline_submit_poll_cancel(server):
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    try:
        tokens = ch.submit("Echo.Native", [b"one", b"two"])
        got = {}
        deadline = time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            for c in ch.poll(timeout_ms=2000):
                got[c.token] = c.tobytes()
        assert [got[t] for t in tokens] == [b"one", b"two"]
        assert ch.cancel(tokens[0]) is False
    finally:
        ch.close()


def test_request_pins_drain_like_reference(server):
    addr = f"127.0.0.1:{server.port}"
    payload = np.arange(1 << 16, dtype=np.uint32)
    for mod in PKGS.values():
        ch = mod.Channel(addr, timeout_ms=10000)
        try:
            res = ch.call_batch("Echo.Native", [payload] * 4)
        finally:
            ch.close()
        assert all(r == payload.tobytes() for r in res)
    from brpc_tpu.rpc.batch import pinned_requests as ref_pinned

    assert _drained()
    deadline = time.monotonic() + 10
    while ref_pinned() > 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert ref_pinned() == 0


@pytest.mark.parametrize("use_shm", [False, True])
def test_rpc_batch_echo_step_on_cpu(server, use_shm):
    """The pipelined echo plane as a whole: K1's plain version makes the
    copy, a window of 3 calls lands in uint8 tensors, and every echoed
    checksum equals JAX sum32 of the same numpy payload."""
    arr = np.random.default_rng(21).integers(0, 1 << 32, size=2 * _BLOCK,
                                             dtype=np.uint32)
    want = int(jax_sum32(jnp.asarray(arr)))
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000,
                      use_shm=use_shm)
    bufs = [torch.empty(arr.nbytes, dtype=torch.uint8) for _ in range(3)]
    try:
        echoed, sent, got = rpc_batch_echo_step(
            ch, payload_from_numpy(arr, "cpu"), 3, bufs,
            method="Echo.Native")
    finally:
        ch.close()
    assert int(sent) == want and [int(g) for g in got] == [want] * 3
    for e in echoed:
        assert e.dtype == torch.uint32
        np.testing.assert_array_equal(e.view(torch.int32).numpy()
                                      .view(np.uint32), arr)
    # The echoed tensors are copies: reusing the buffers leaves them be.
    for buf in bufs:
        buf.zero_()
    np.testing.assert_array_equal(echoed[0].view(torch.int32).numpy()
                                  .view(np.uint32), arr)
    assert _drained()


def test_rpc_batch_echo_step_1kib_tile(server):
    """A 1 KiB payload at depth 16 under the (1, 256) tile."""
    arr = np.random.default_rng(22).integers(0, 1 << 32, size=256,
                                             dtype=np.uint32)
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    try:
        bufs = [torch.empty(1024, dtype=torch.uint8) for _ in range(16)]
        echoed, sent, got = rpc_batch_echo_step(
            ch, payload_from_numpy(arr, "cpu"), 16, bufs,
            method="Echo.Native", rows=1, cols=256)
        with pytest.raises(AssertionError):
            rpc_batch_echo_step(ch, payload_from_numpy(arr, "cpu"), 1, bufs)
    finally:
        ch.close()
    want = int(jax_sum32(jnp.asarray(arr)))
    assert len(echoed) == 16
    assert int(sent) == want and all(int(g) == want for g in got)


def test_echo_pipeline_refill_and_typed_failure(server):
    """The windowed refill loop of the batch leg: poll k, resubmit k; a
    member that fails raises its typed error."""
    arr = np.arange(_BLOCK, dtype=np.uint32)
    payload = payload_from_numpy(arr, "cpu")
    ch = port.Channel(f"127.0.0.1:{server.port}", timeout_ms=10000)
    bufs = [torch.empty(arr.nbytes, dtype=torch.uint8) for _ in range(4)]
    pipe = EchoPipeline(ch, payload, bufs, method="Echo.Native")
    try:
        pipe.submit(4)
        with pytest.raises(ValueError):
            pipe.submit(1)  # no free landing buffer left
        submitted, checked = 4, 0
        while checked < 12:
            got = pipe.poll(max_n=4, timeout_ms=10000)
            assert got, "wedged"
            for _back, csum in got:
                assert int(csum) == int(pipe.sent)
            checked += len(got)
            k = min(len(got), 12 - submitted)
            if k:
                pipe.submit(k)
                submitted += k
        assert pipe.inflight == 0
    finally:
        pipe.close()
    with pytest.raises(ValueError):
        EchoPipeline(ch, payload, [torch.empty(8, dtype=torch.uint8)])
    failing = EchoPipeline(ch, payload, bufs, method="No.Such")
    try:
        failing.submit(1)
        with pytest.raises(port.RpcError):
            for _ in range(5):
                failing.poll(max_n=1, timeout_ms=2000)
    finally:
        failing.close()
        ch.close()


@pytest.mark.parametrize("landing", ["tensor", "rma"])
def test_echo_pipeline_failure_mid_poll(second_fails_server, landing,
                                       monkeypatch):
    """One member fails among four completions drained by one poll, placed
    second of the four: the poll handles all four before it raises the
    typed error, the failed member's landing buffer is retired (a late put
    may still reach an RmaBuffer), and the pipeline goes on with the other
    three."""
    arr = np.random.default_rng(23).integers(0, 1 << 32, size=256,
                                             dtype=np.uint32)
    payload = payload_from_numpy(arr, "cpu")
    if landing == "rma":
        bufs = [port.RmaBuffer(arr.nbytes) for _ in range(4)]
    else:
        bufs = [torch.empty(arr.nbytes, dtype=torch.uint8) for _ in range(4)]
    ch = port.Channel(f"127.0.0.1:{second_fails_server.port}",
                      timeout_ms=10000)
    pipe = EchoPipeline(ch, payload, bufs, method="Echo.SecondFails",
                        rows=1, cols=256)
    try:
        pipe.submit(4)
        deadline = time.monotonic() + 10
        while pipe._pipe.inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pipe._pipe.inflight == 0, "the window did not complete"
        real_poll = pipe._pipe.poll

        def failed_second(**kw):
            got = real_poll(**kw)
            good = [c for c in got if c.ok]
            return good[:1] + [c for c in got if not c.ok] + good[1:]

        monkeypatch.setattr(pipe._pipe, "poll", failed_second)
        with pytest.raises(port.RpcError) as err:
            pipe.poll(max_n=4, timeout_ms=0)
        assert err.value.code == 7
        assert pipe.inflight == 0 and pipe._pipe.outstanding == 0
        free = [id(b) for b, _ in pipe._free]
        assert len(free) == 3 and len(set(free)) == 3
        assert set(free) < {id(b) for b in bufs}
        pipe.submit(3)
        echoed = []
        while pipe.inflight:
            got = pipe.poll(max_n=3, timeout_ms=10000)
            assert got, "wedged"
            echoed += got
        want = int(jax_sum32(jnp.asarray(arr)))
        assert [int(g) for _, g in echoed] == [want] * 3
    finally:
        pipe.close()
        ch.close()
        if landing == "rma":
            for b in bufs:
                b.free()
