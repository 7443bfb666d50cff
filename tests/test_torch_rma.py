"""Port parity: one-sided RMA landing buffers of brpc_tpu_torch.rpc.rma
against brpc_tpu.rpc.rma, driving the same native servers.  Mirrors
tests/test_rma_python.py: the RmaBuffer lifecycle, a batch response PUT by
the server straight into the caller's registered buffer over shm (the rma
vars move, the stripe vars do not), the same buffer degrading to the copy
path over TCP, a separate server process writing into this process's
region, and the kernel probe.  Port-only: the tensor view over the
registered bytes, and a CUDA registration that cannot happen raising with
nothing left registered."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port

PKGS = {"reference": ref, "port": port}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RMA_KEYS = ("rma_tx_msgs", "rma_rx_msgs", "rma_tx_bytes", "rma_rejected")
_STRIPE_KEYS = ("stripe_tx_chunks", "stripe_reassembled")


def _vars(keys):
    v = port.observe.Vars.dump()
    return {k: v.get(k, 0) for k in keys}


def _pattern(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.uint64) * 2654435761 >> 13).astype(np.uint8)


@pytest.fixture(scope="module")
def server():
    srv = port.Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    yield srv
    srv.close()


def test_rma_buffer_lifecycle_and_tensor_view():
    lib = port.load_library()
    before = int(lib.trpc_rma_region_count())
    buf = port.RmaBuffer(1 << 20)
    assert buf.rkey != 0 and len(buf) == buf.nbytes == 1 << 20
    assert not buf.cuda_registered
    assert int(lib.trpc_rma_region_count()) == before + 1
    t = buf.tensor
    assert t.dtype == torch.uint8 and t.numel() == 1 << 20
    assert t.data_ptr() == buf.address
    t.fill_(0x5A)
    view = np.frombuffer(buf.view, dtype=np.uint8)
    assert int(view[12345]) == 0x5A  # one memory, two views
    del t, view
    buf.free()
    buf.free()  # idempotent
    assert int(lib.trpc_rma_region_count()) == before
    for attr in ("view", "tensor", "address"):
        with pytest.raises(ValueError):
            getattr(buf, attr)
    with pytest.raises(ValueError):
        port.RmaBuffer(0)


def test_cuda_registration_without_cuda_raises_and_frees():
    """With a CUDA device the region must be registered with the CUDA
    driver; where that cannot happen the buffer raises and leaves no
    region behind — it never carries on unregistered."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; chip_smoke.py covers it")
    lib = port.load_library()
    before = int(lib.trpc_rma_region_count())
    with pytest.raises((AssertionError, RuntimeError)):
        port.RmaBuffer(1 << 20, device="cuda")
    assert int(lib.trpc_rma_region_count()) == before


def _land(mod, addr, size, payload, use_shm, as_tensor=False):
    """One batch call whose response lands in an RmaBuffer; returns
    (in_caller_buffer, landed bytes, rma var delta, stripe var delta)."""
    conn = "single" if use_shm else "pooled"
    ch = mod.Channel(addr, timeout_ms=60000, use_shm=use_shm,
                     connection_type=conn)
    try:
        if use_shm:
            assert ch.call("Echo.Echo", b"warm") == b"warm"
            assert ch.transport == "shm_ring"
        rma0, stripe0 = _vars(_RMA_KEYS), _vars(_STRIPE_KEYS)
        with mod.RmaBuffer(size) as land:
            pipe = ch.pipeline()
            try:
                req = torch.from_numpy(payload) if as_tensor else payload
                resp = land if as_tensor else land.view
                toks = pipe.submit("Echo.Echo", [req], resp_bufs=[resp])
                cs = pipe.poll(max_n=1, timeout_ms=60000)
                assert len(cs) == 1 and cs[0].ok and cs[0].token == toks[0]
                got = np.frombuffer(land.view, dtype=np.uint8).copy()
                in_buf = cs[0].in_caller_buffer
            finally:
                pipe.close()
        rma1, stripe1 = _vars(_RMA_KEYS), _vars(_STRIPE_KEYS)
    finally:
        ch.close()
    return (in_buf, got,
            {k: rma1[k] - rma0[k] for k in _RMA_KEYS},
            {k: stripe1[k] - stripe0[k] for k in _STRIPE_KEYS})


def test_remote_landing_over_shm_matches_reference(server):
    """A 16MB response PUT by the server straight into the caller's
    registered buffer: the same bytes and flags from both packages' clients,
    and for each the request and the response rode the one-sided plane."""
    size = 16 << 20
    payload = _pattern(size)
    addr = f"127.0.0.1:{server.port}"
    got = {name: _land(mod, addr, size, payload, use_shm=True,
                       as_tensor=name == "port")
           for name, mod in PKGS.items()}
    for name, (in_buf, landed, rma, stripe) in got.items():
        assert in_buf, name
        assert np.array_equal(landed, payload), f"{name}: landing corrupt"
        assert rma["rma_tx_msgs"] >= 2 and rma["rma_rx_msgs"] >= 2, name
        assert rma["rma_tx_bytes"] >= 2 * size and rma["rma_rejected"] == 0
        assert stripe == {k: 0 for k in _STRIPE_KEYS}, name


def test_rma_buffer_degrades_over_tcp_like_reference(server):
    size = 8 << 20
    payload = _pattern(size)
    addr = f"127.0.0.1:{server.port}"
    got = {name: _land(mod, addr, size, payload, use_shm=False,
                       as_tensor=name == "port")
           for name, mod in PKGS.items()}
    assert got["port"][0] == got["reference"][0]
    for name, (_in_buf, landed, rma, _stripe) in got.items():
        assert np.array_equal(landed, payload), name
        assert rma["rma_tx_msgs"] == 0, name  # TCP: the plane untouched


_CHILD_SERVER = r"""
import sys
from brpc_tpu_torch.rpc import Server
srv = Server()
srv.register_native_echo("Echo.Echo")
srv.start(0)
print(srv.port, flush=True)
sys.stdin.readline()  # parent closes stdin to stop us
srv.close()
"""


def test_cross_process_remote_landing_into_tensor_view():
    """A SEPARATE server process (the port's Server) maps this process's
    region by rkey and writes the response into it; the tensor view sees
    the bytes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.Popen([sys.executable, "-c", _CHILD_SERVER], env=env,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True)
    try:
        port_no = int(child.stdout.readline())
        size = 16 << 20
        payload = _pattern(size)
        ch = port.Channel(f"127.0.0.1:{port_no}", timeout_ms=60000,
                          use_shm=True)
        try:
            assert ch.call("Echo.Echo", b"warm") == b"warm"
            assert ch.transport == "shm_ring"
            rma0 = _vars(_RMA_KEYS)
            with port.RmaBuffer(size) as land:
                res = ch.call_batch("Echo.Echo", [payload], resp_bufs=[land])
                assert res == [None]  # landed in the caller's buffer
                assert torch.equal(land.tensor, torch.from_numpy(payload))
            rma1 = _vars(_RMA_KEYS)
            assert rma1["rma_tx_msgs"] > rma0["rma_tx_msgs"]
            assert rma1["rma_rx_msgs"] > rma0["rma_rx_msgs"]
        finally:
            ch.close()
    finally:
        child.stdin.close()
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=10)


def test_kernel_supports_matches_reference(server):
    a = port.kernel_supports("io_uring")
    assert a in (0, 1) and a == ref.kernel_supports("io_uring")
    assert port.kernel_supports("definitely_not_a_feature") == -1
    deadline = time.monotonic() + 5
    val = None
    while val is None and time.monotonic() < deadline:
        val = port.observe.Vars.dump().get("kernel_io_uring_supported")
        time.sleep(0.05)
    assert val == a


def test_rma_window_flag_validated():
    old = port.get_flag("trpc_rma_window_bytes")
    try:
        port.set_flag("trpc_rma_window_bytes", str(64 << 20))
        assert int(ref.get_flag("trpc_rma_window_bytes")) == 64 << 20
        with pytest.raises(ValueError):
            port.set_flag("trpc_rma_window_bytes", "12345")  # not a pow2
        with pytest.raises(ValueError):
            port.set_flag("trpc_shm_rails", "99")  # out of range
    finally:
        port.set_flag("trpc_rma_window_bytes", old)
