"""K1's batched landing on the card: `echo_land_batch` bit-exact against
`echo_reference` at k = 1, 2, 63, 64 and 65 calls (the last across two
launches), 1 KiB and 256 KiB, from pinned and from CUDA-registered
`RmaBuffer` landing buffers; and `EchoPipeline` windows counted by
wrapper: the batched launch at 1 KiB, `echo_fused` a call at 64 MiB.

Marked `card`: every test skips without a CUDA card.  On the card, run
as tests/card/conftest.py says."""

import ctypes

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def _buffers(kind: str, k: int, nbytes: int, device):
    from brpc_tpu_torch.rpc import RmaBuffer

    if kind == "rma":
        return [RmaBuffer(nbytes, device=device) for _ in range(k)]
    return [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(k)]


def _free(kind: str, bufs) -> None:
    if kind == "rma":
        for b in bufs:
            b.free()


def _fill(bufs, lanes: np.ndarray) -> list:
    """Writes row c of `lanes` into landing buffer c; their host
    addresses."""
    from brpc_tpu_torch.rpc.batch import _landing_bytes

    hosts = []
    for buf, row in zip(bufs, lanes):
        view = _landing_bytes(buf)
        view[:row.nbytes] = row.view(np.uint8)
        hosts.append(view.ctypes.data)
    return hosts


def _land_and_check(addrs, lanes: np.ndarray, device) -> None:
    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import (LAND_WRAPPER,
                                                echo_land_batch,
                                                echo_reference, land_chunks)

    k, n = lanes.shape
    before = _kernels.launches[LAND_WRAPPER]
    out, sums = echo_land_batch(addrs, n, device)
    torch.cuda.synchronize()
    assert _kernels.launches[LAND_WRAPPER] - before == len(land_chunks(k))
    assert out.shape == (k, n) and out.dtype == torch.uint32
    assert sums.shape == (k,) and sums.dtype == torch.uint32
    got = out.view(torch.int32).cpu().numpy().view(np.uint32)
    got_sums = sums.view(torch.int32).cpu().numpy().view(np.uint32)
    for c in range(k):
        copy, csum = echo_reference(
            torch.from_numpy(lanes[c].view(np.int32)).view(torch.uint32))
        np.testing.assert_array_equal(
            got[c], copy.view(torch.int32).numpy().view(np.uint32))
        assert int(got_sums[c]) == int(csum), c


@pytest.mark.parametrize("kind", ["pinned", "rma"])
@pytest.mark.parametrize("nbytes", [1024, 256 * 1024])
@pytest.mark.parametrize("k", [1, 2, 63, 64, 65])
def test_land_batch_matches_the_reference(card, kind, nbytes, k):
    from brpc_tpu_torch.ops.echo_kernel import batched_landing

    rng = np.random.default_rng(1000 * k + nbytes)
    lanes = rng.integers(0, 1 << 32, size=(k, nbytes // 4), dtype=np.uint32)
    lanes[0, :4] = [0xFFFFFFFF, 0xFFFFFFFF, 1, 0]  # the sum wraps
    bufs = _buffers(kind, k, nbytes, card)
    try:
        addrs = batched_landing(card, nbytes, _fill(bufs, lanes))
        assert addrs is not None, "a landing buffer is not device-mapped"
        _land_and_check(addrs, lanes, card)
    finally:
        _free(kind, bufs)


@pytest.mark.parametrize("kind", ["pinned", "rma"])
def test_land_batch_reads_what_the_host_wrote_last(card, kind):
    """The same buffers landed twice, rewritten by the host in between:
    the second launch reads the new bytes, not cached old ones."""
    from brpc_tpu_torch.ops.echo_kernel import batched_landing

    rng = np.random.default_rng(7)
    bufs = _buffers(kind, 8, 1024, card)
    try:
        for _ in range(3):
            lanes = rng.integers(0, 1 << 32, size=(8, 256), dtype=np.uint32)
            addrs = batched_landing(card, 1024, _fill(bufs, lanes))
            _land_and_check(addrs, lanes, card)
    finally:
        _free(kind, bufs)


def test_land_batch_refuses_a_misaligned_address(card):
    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import (LAND_WRAPPER,
                                                echo_land_batch,
                                                mapped_pointer)

    buf = torch.empty(2048, dtype=torch.uint8, pin_memory=True)
    addr = mapped_pointer(buf.data_ptr(), card)
    assert addr is not None
    before = _kernels.launches[LAND_WRAPPER]
    with pytest.raises(RuntimeError, match="cudaError 716"):
        echo_land_batch([addr, addr + 4], 256, card)
    assert _kernels.launches[LAND_WRAPPER] == before


def test_pageable_memory_is_not_mapped(card):
    from brpc_tpu_torch.ops.echo_kernel import mapped_pointer

    host = (ctypes.c_char * 4096)()
    assert mapped_pointer(ctypes.addressof(host), card) is None


@pytest.mark.parametrize("nbytes,kind,batched", [
    (1024, "pinned", True),
    (1024, "rma", True),
    (64 << 20, "pinned", False),
])
def test_pipeline_window_counts_launches_by_wrapper(card, nbytes, kind,
                                                    batched):
    """A native echo server, a window of calls refilled as they drain:
    at 1 KiB the batched launch lands them (no echo_fused but the
    constructor's), at 64 MiB echo_fused checks each call as before.
    Every echo bit-exact, every checksum the sent one."""
    from brpc_tpu_torch.models.echo import (LANDED, LANDED_BATCHED,
                                            EchoPipeline)
    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import LAND_WRAPPER, WRAPPER
    from brpc_tpu_torch.rpc import Channel, Server, observe

    depth, calls = (16, 160) if batched else (2, 6)
    lanes = nbytes // 4
    payload = torch.randint(-(1 << 31), 1 << 31, (lanes,), dtype=torch.int32,
                            device=card,
                            generator=torch.Generator(card).manual_seed(5))
    payload = payload.view(torch.uint32)
    tile = (1, lanes) if batched else (16, 8192)
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    ch = Channel(f"127.0.0.1:{srv.port}", timeout_ms=60000,
                 use_shm=kind == "rma")
    bufs = _buffers(kind, depth, nbytes, card)

    def counts():
        return [int(observe.Vars.read(n)) for n in (LANDED, LANDED_BATCHED)]

    try:
        before_k1 = _kernels.launches[WRAPPER]
        before_land = _kernels.launches[LAND_WRAPPER]
        pipe = EchoPipeline(ch, payload, bufs, rows=tile[0], cols=tile[1])
        assert (pipe._mapped is not None) == batched
        before = counts()
        done, submitted = [], depth
        pipe.submit(depth)
        while len(done) < calls:
            got = pipe.poll(max_n=depth, timeout_ms=60000)
            assert got, "wedged"
            done += got
            k = min(len(got), calls - submitted)
            if k:
                pipe.submit(k)
                submitted += k
        pipe.close()
        torch.cuda.synchronize()
        landed, landed_batched = (a - b for a, b in zip(counts(), before))
        k1 = _kernels.launches[WRAPPER] - before_k1
        land = _kernels.launches[LAND_WRAPPER] - before_land
    finally:
        ch.close()
        srv.stop()
        srv.close()
        _free(kind, bufs)
    assert len(done) == calls == landed
    if batched:
        assert k1 == 1 and 0 < land <= calls
        assert landed_batched == calls
    else:
        assert k1 == 1 + calls and land == 0
        assert landed_batched == 0
    sent = int(pipe.sent)
    want = payload.view(torch.int32)
    for back, got in done:
        assert int(got) == sent
        assert torch.equal(back.view(torch.int32), want)
