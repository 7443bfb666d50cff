"""Port parity: the RPC hand-off of brpc_tpu_torch (Server/Channel, the
zero-copy tensor→wire path, the device arena, the ici staging slab) against
brpc_tpu's, and the echo data plane as a whole on the CPU.  Mirrors
tests/test_device_arena.py for torch tensors."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops.checksum import sum32 as jax_sum32
from brpc_tpu.rpc import zerocopy as jax_zerocopy
from brpc_tpu.rpc.client import Channel as JaxChannel
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.models.echo import rpc_echo_step
from brpc_tpu_torch.ops.echo_kernel import _BLOCK
from brpc_tpu_torch.rpc import Channel, RpcError, Server, zerocopy
from brpc_tpu_torch.rpc._lib import IOBuf, load_library
from brpc_tpu_torch.rpc.arena import DeviceArena, call_with_block


def _drained(live_sends) -> bool:
    # The write fiber drops the last IOBuf reference a hair after the
    # response lands; the keepalive registry must drain to zero.
    for _ in range(400):
        if live_sends() == 0:
            return True
        time.sleep(0.005)
    return False


@pytest.fixture(scope="module")
def echo_server():
    srv = Server()
    srv.register("Echo.Echo", lambda call, req: call.respond(req))
    srv.register("Echo.Fail", lambda call, req: 1 / 0)
    srv.register_native_echo("Native.Echo")
    srv.start(0)
    yield srv
    srv.close()


@pytest.fixture()
def channel(echo_server):
    ch = Channel(f"127.0.0.1:{echo_server.port}", timeout_ms=5000)
    yield ch
    ch.close()


@pytest.mark.parametrize("use_shm,transport", [(False, "tcp"),
                                               (True, "shm_ring")])
@pytest.mark.parametrize("method", ["Echo.Echo", "Native.Echo"])
def test_channel_loopback(echo_server, use_shm, transport, method):
    ch = Channel(f"127.0.0.1:{echo_server.port}", timeout_ms=5000,
                 use_shm=use_shm)
    try:
        payload = bytes(range(256)) * 64
        assert ch.call(method, payload) == payload
        assert ch.transport == transport
    finally:
        ch.close()


def test_handler_error_reaches_caller(channel):
    with pytest.raises(RpcError) as info:
        channel.call("Echo.Fail", b"x")
    assert info.value.code == 13 and "ZeroDivisionError" in info.value.text


def test_iobuf_basics():
    buf = IOBuf(b"hello world")
    assert len(buf) == 11 and buf.block_count >= 1
    head = buf.cutn(6)
    assert head.to_bytes() == b"hello " and buf.to_bytes() == b"world"
    assert buf.pop_front(2) == 2 and buf.to_bytes() == b"rld"


def test_append_torch_pointer_identity():
    """The tensor's OWN memory is on the wire: the IOBuf block's data
    pointer is the tensor's data_ptr() — no staging copy anywhere."""
    lib = load_library()
    x = torch.arange(8192, dtype=torch.int32).view(torch.uint32)
    req = lib.trpc_iobuf_create()
    try:
        assert zerocopy.append_torch(req, x, lib) == 8192 * 4
        assert zerocopy.live_sends() >= 1
        assert zerocopy.block_ptr(req, 0, lib) == x.data_ptr()
    finally:
        lib.trpc_iobuf_destroy(req)
    # Destroying the IOBuf ran the deleter: the tensor is unpinned.
    assert _drained(zerocopy.live_sends)


def test_host_view_of_cpu_tensor_is_a_view():
    x = torch.arange(100, dtype=torch.int32)
    flat, _owner = zerocopy.host_view(x)
    assert flat.dtype == np.uint8 and flat.size == 400
    assert flat.ctypes.data == x.data_ptr()


def test_append_torch_keeps_noncontiguous_copy_alive():
    lib = load_library()
    x = torch.arange(64, dtype=torch.int32).reshape(8, 8).t()
    req = lib.trpc_iobuf_create()
    try:
        zerocopy.append_torch(req, x, lib)
        buf_bytes = IOBuf()
        lib.trpc_iobuf_cutn(req, buf_bytes._ptr, 64 * 4)
        got = np.frombuffer(buf_bytes.to_bytes(), dtype=np.int32)
        np.testing.assert_array_equal(got, x.contiguous().reshape(-1).numpy())
    finally:
        lib.trpc_iobuf_destroy(req)
    del buf_bytes
    assert _drained(zerocopy.live_sends)


def test_pin_unpin_registry():
    token = zerocopy.pin(torch.zeros(4))
    assert zerocopy.live_sends() >= 1
    zerocopy.unpin(token)
    assert _drained(zerocopy.live_sends)


def test_zero_copy_rpc_matches_reference(echo_server, channel):
    """The same numpy payload through the reference's call_zero_copy (a jax
    array) and the port's (a torch tensor) echoes the same bytes."""
    arr = np.random.default_rng(3).integers(0, 1 << 32, size=1 << 18,
                                            dtype=np.uint32)  # 1MB
    got = zerocopy.call_zero_copy(channel, "Echo.Echo",
                                  payload_from_numpy(arr, "cpu"))
    ref_ch = JaxChannel(f"127.0.0.1:{echo_server.port}", timeout_ms=5000)
    try:
        want = jax_zerocopy.call_zero_copy(ref_ch, "Echo.Echo",
                                           jnp.asarray(arr))
    finally:
        ref_ch.close()
    assert got == want == arr.tobytes()
    landed = zerocopy.call_zero_copy_into(channel, "Native.Echo",
                                          payload_from_numpy(arr, "cpu"))
    assert landed.dtype == torch.uint8 and landed.numpy().tobytes() == want
    assert _drained(zerocopy.live_sends)


def test_torch_tensor_through_arena_rpc(channel):
    arena = DeviceArena(block_size=64 * 1024, blocks_per_slab=4)
    try:
        x = torch.arange(4096, dtype=torch.int32).view(torch.uint32)
        block = arena.alloc()
        assert arena.blocks_in_use == 1
        n = block.put(x)  # the single landing copy
        assert n == 4096 * 4
        resp = call_with_block(channel, "Echo.Echo", block, n)
        for _ in range(200):
            if arena.blocks_in_use == 0:
                break
            time.sleep(0.005)
        assert arena.blocks_in_use == 0
        np.testing.assert_array_equal(np.frombuffer(resp, dtype=np.uint32),
                                      x.numpy())
    finally:
        arena.close()


def test_arena_block_meta_release_and_capacity():
    arena = DeviceArena(block_size=16 * 1024, blocks_per_slab=2)
    try:
        a, b = arena.alloc(), arena.alloc()
        assert a.meta != b.meta and arena.blocks_in_use == 2
        with pytest.raises(ValueError):
            a.put(torch.zeros(16 * 1024 + 1, dtype=torch.uint8))
        a.release()
        b.release()
        assert arena.blocks_in_use == 0
        blocks = [arena.alloc() for _ in range(5)]  # slab growth
        assert arena.blocks_in_use == 5
        for blk in blocks:
            blk.release()
    finally:
        arena.close()


def test_ici_staging_zero_copy_from_python():
    """A registered ici staging slab as a torch tensor: land a payload in
    it, run the native echo over the ici rings, and check the payload rode
    sender-owned descriptors with the round trip content verified."""
    size = 4 << 20
    slab = zerocopy.alloc_staging(size)
    try:
        assert slab.dtype == torch.uint8 and slab.numel() == size
        payload = torch.arange(size // 4, dtype=torch.int32)
        assert zerocopy.land(slab, payload) == size
        wrs0, bytes0 = zerocopy.zero_copy_counters()
        resp = torch.empty(size, dtype=torch.uint8)
        gbps, used = zerocopy.bench_echo(slab, "ici", 4, resp)
        assert used == "ici_ring" and gbps > 0
        assert torch.equal(resp.view(torch.int32), payload)
        wrs1, bytes1 = zerocopy.zero_copy_counters()
        assert wrs1 > wrs0 and bytes1 - bytes0 >= size
    finally:
        zerocopy.free_staging(slab)
    zerocopy.free_staging(slab)  # unknown base now: a no-op


@pytest.mark.parametrize("payload,resp", [
    (torch.zeros(64, dtype=torch.uint8), torch.zeros(8, dtype=torch.uint8)),
    (torch.zeros(16, dtype=torch.int32), None),
    (torch.zeros(128, dtype=torch.uint8)[::2], None),
])
def test_bench_echo_checks_buffers(payload, resp):
    with pytest.raises(ValueError):
        zerocopy.bench_echo(payload, "tcp", 1, resp)


@pytest.mark.parametrize("method", ["Echo.Echo", "Native.Echo"])
def test_echo_slice_end_to_end_on_cpu(channel, method):
    """The slice as a whole: payload → fused echo pass → RPC echo by
    reference → back → fused checksum, equal to JAX sum32 of the same
    numpy payload."""
    arr = np.random.default_rng(11).integers(0, 1 << 32, size=2 * _BLOCK,
                                             dtype=np.uint32)
    payload = payload_from_numpy(arr, "cpu")
    back, sent, got = rpc_echo_step(channel, payload, method=method)
    want = int(jax_sum32(jnp.asarray(arr)))
    assert int(sent) == int(got) == want
    np.testing.assert_array_equal(back.numpy(), arr)
    assert _drained(zerocopy.live_sends)


def test_echo_slice_through_staging_on_cpu():
    """payload → fused echo pass → registered staging slab → native echo
    over the ici rings → back, checksum equal to JAX sum32."""
    from brpc_tpu_torch.ops.echo_kernel import echo_fused

    arr = np.random.default_rng(12).integers(0, 1 << 32, size=2 * _BLOCK,
                                             dtype=np.uint32)
    resp, sent = echo_fused(payload_from_numpy(arr, "cpu"))
    slab = zerocopy.alloc_staging(arr.nbytes, device="cpu")
    try:
        zerocopy.land(slab, resp)
        echoed = torch.empty(arr.nbytes, dtype=torch.uint8)
        zerocopy.bench_echo(slab, "ici", 2, echoed)
    finally:
        zerocopy.free_staging(slab)
    _, got = echo_fused(echoed.view(torch.int32).view(torch.uint32))
    assert int(sent) == int(got) == int(jax_sum32(jnp.asarray(arr)))
