"""Port parity: brpc_tpu_torch.rpc.stream and .infer against brpc_tpu.rpc's,
on the same native servers.  Mirrors tests/test_infer_python.py: raw
streams (offer/accept, ordered chunks both ways, graceful close, no silent
truncation), and the streamed-inference front door (equal token sequences
for equal prompts from both packages' clients, EOS, prefix-cache prefill,
client cancel freeing the slot, deadline expiry, typed per-tenant shedding).
The wire formats are compared byte for byte."""

import struct
import time

import pytest

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import infer as ref_infer
from brpc_tpu.rpc import kv as ref_kv
from brpc_tpu_torch.rpc import infer

PKGS = {"reference": ref, "port": port}
_FLAGS = {
    "trpc_infer_batch_max": "256",
    "trpc_infer_queue_max": "200000",
    "trpc_infer_step_us": "1000",
    "trpc_infer_prefill_us_per_token": "0",
    "trpc_infer_max_new_tokens": "256",
    "trpc_infer_bytes_per_token": "64",
    "trpc_kv_prefix_block_tokens": "8",
}


@pytest.fixture(autouse=True)
def _infer_flags():
    """Known knobs for every test; the process-wide values are restored
    after it."""
    old = {name: port.get_flag(name) for name in _FLAGS}
    for name, value in _FLAGS.items():
        port.set_flag(name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            port.set_flag(name, value)


def _prompt(seed: int, n: int) -> list:
    return [seed * 100003 + i + 1 for i in range(n)]


def _wait(cond, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("tokens,max_new,publish", [
    ([1, 2, 3, 4], 8, True), ([], 0, False), ([2**64 - 1, 0, 7], 3, False)])
def test_pack_submit_bytes_equal_reference(tokens, max_new, publish):
    got = infer.pack_submit(tokens, max_new, publish)
    assert got == ref_infer.pack_submit(tokens, max_new, publish)
    magic, flags, n_new, n = struct.unpack_from("<IIII", got)
    assert (magic, n_new, n) == (0x31464E49, max_new, len(tokens))
    assert flags == (0 if publish else infer.SUBMIT_NO_PUBLISH)
    for name in ("INFER_MAGIC", "SUBMIT_NO_PUBLISH", "TOKEN_EOS",
                 "TOKEN_CANCELLED", "SUBMIT_METHOD"):
        assert getattr(infer, name) == getattr(ref_infer, name)


def test_token_record_flags():
    rec = infer.TokenRecord(5, 2, infer.TOKEN_EOS)
    assert rec.eos and not rec.cancelled
    assert repr(rec) == repr(ref_infer.TokenRecord(5, 2, infer.TOKEN_EOS))
    assert infer.TokenRecord(1, 0, infer.TOKEN_CANCELLED).cancelled


@pytest.mark.parametrize("server_pkg", sorted(PKGS))
def test_stream_echo_roundtrip(server_pkg):
    """The port's client stream against a server stream accepted through
    either package's Call.accept_stream."""
    srv = PKGS[server_pkg].Server()
    accepted = []

    def handler(call, req):
        accepted.append(call.accept_stream())
        call.respond(b"hi:" + req)

    srv.register("Echo.Stream", handler)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
    try:
        st, resp = port.open_stream(ch, "Echo.Stream", b"abc")
        assert resp == b"hi:abc"
        assert _wait(lambda: len(accepted) == 1)
        peer = accepted[0]
        assert st.id != 0
        peer.write(b"one")
        peer.write(b"two")
        assert st.read(timeout_ms=3000) == b"one"
        assert st.read(timeout_ms=3000) == b"two"
        st.write(b"up")
        assert peer.read(timeout_ms=3000) == b"up"
        with pytest.raises(port.StreamTimeoutError):
            st.read(timeout_ms=50)
        peer.write(b"last")
        peer.close()
        assert _wait(lambda: st.pending() == 1)
        assert st.read(timeout_ms=3000) == b"last"
        with pytest.raises(port.StreamClosedError):
            st.read(timeout_ms=3000)
        st.destroy()
        peer.destroy()
        with pytest.raises(port.StreamClosedError):
            st.read()
    finally:
        ch.close()
        srv.close()


def test_stream_read_never_truncates():
    srv = port.Server()
    accepted = []

    def handler(call, req):
        accepted.append(call.accept_stream())
        call.respond(b"ok")

    srv.register("Echo.Stream", handler)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
    try:
        st, _ = port.open_stream(ch, "Echo.Stream")
        assert _wait(lambda: len(accepted) == 1)
        peer = accepted[0]
        peer.write(b"x" * 32)
        with pytest.raises(port.StreamChunkTooLargeError) as ei:
            st.read(max_bytes=16, timeout_ms=3000)
        assert ei.value.needed == 32 and ei.value.cap == 16
        assert st.read(max_bytes=32, timeout_ms=3000) == b"x" * 32
        st.destroy()
        peer.destroy()
    finally:
        ch.close()
        srv.close()


def test_no_stream_offered_and_failed_open_typed():
    srv = port.Server()
    offered = []

    def handler(call, req):
        offered.append(call.accept_stream())
        call.respond(b"")

    srv.register("Plain.Call", handler)
    srv.start(0)
    addr = f"127.0.0.1:{srv.port}"
    chans = {name: mod.Channel(addr, timeout_ms=5000)
             for name, mod in PKGS.items()}
    try:
        assert chans["port"].call("Plain.Call", b"") == b""
        assert offered == [None]  # the request offered no stream
        errs = {}
        for name, mod in PKGS.items():
            with pytest.raises(mod.RpcError) as ei:
                mod.open_stream(chans[name], "No.Such", b"")
            errs[name] = (type(ei.value).__name__, ei.value.code)
        assert errs["port"] == errs["reference"]
    finally:
        for ch in chans.values():
            ch.close()
        srv.close()


def test_infer_tokens_equal_reference_and_eos():
    """Four prompts through both packages' InferClient on one server:
    every record sequence ends at EOS and equal prompts decode to equal
    token sequences."""
    srv = port.Server()
    srv.enable_infer(prefix_cache=False)
    srv.start(0)
    addr = f"127.0.0.1:{srv.port}"
    chans = {name: mod.Channel(addr, timeout_ms=5000)
             for name, mod in PKGS.items()}
    try:
        d0 = srv.infer_dump()
        got = {}
        for name, mod in PKGS.items():
            client = mod.InferClient(chans[name])
            seqs = []
            for seed in range(4):
                comp = client.submit(_prompt(seed, 4 + seed),
                                     max_new_tokens=8, timeout_ms=30000)
                assert comp.request_id > 0 and comp.cached_tokens == 0
                recs = list(comp.records())
                assert [r.index for r in recs] == list(range(8))
                assert recs[-1].eos and comp.finished
                seqs.append([r.token for r in recs])
            got[name] = seqs
        assert got["port"] == got["reference"]
        again = list(port.InferClient(chans["port"]).submit(
            _prompt(0, 4), max_new_tokens=8, timeout_ms=30000))
        assert again == got["port"][0]
        d1 = srv.infer_dump()
        assert d1["done"] - d0["done"] == 9
        assert d1["tokens"] - d0["tokens"] == 72
        assert _wait(lambda: srv.infer_streams_live() == 0)
        assert srv.infer_streams_peak() >= 1
    finally:
        for ch in chans.values():
            ch.close()
        srv.close()


def test_infer_prefix_cache_skips_recompute():
    ref_kv.reset()
    srv = port.Server()
    srv.enable_infer(prefix_cache=True)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
    try:
        client = port.InferClient(ch)
        prompt = _prompt(2, 32)  # 4 full blocks at block_tokens=8
        d0 = srv.infer_dump()
        cold = client.submit(prompt, max_new_tokens=4, timeout_ms=30000)
        assert cold.cached_tokens == 0
        cold_tokens = list(cold)
        d1 = srv.infer_dump()
        assert d1["bytes_recomputed"] - d0["bytes_recomputed"] == 32 * 64
        warm = client.submit(prompt, max_new_tokens=4, timeout_ms=30000)
        assert warm.cached_tokens == 32 and warm.block_tokens == 8
        assert list(warm) == cold_tokens
        d2 = srv.infer_dump()
        assert d2["bytes_recomputed"] == d1["bytes_recomputed"]
        assert d2["bytes_cached"] - d1["bytes_cached"] == 4 * 8 * 64
        assert _wait(lambda: srv.infer_streams_live() == 0)
    finally:
        ch.close()
        srv.close()
        ref_kv.reset()


def test_infer_client_close_frees_slot_for_waiter():
    port.set_flag("trpc_infer_batch_max", "1")
    port.set_flag("trpc_infer_step_us", "5000")
    srv = port.Server()
    srv.enable_infer(prefix_cache=False)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
    try:
        client = port.InferClient(ch)
        with client.submit(_prompt(3, 4), max_new_tokens=200,
                           timeout_ms=30000) as hog:
            waiter = client.submit(_prompt(4, 4), max_new_tokens=3,
                                   timeout_ms=30000)
            assert srv.infer_dump()["waiting"] >= 1 or not waiter.finished
        assert hog.finished  # closed by the with block
        assert len(list(waiter)) == 3
        assert _wait(lambda: srv.infer_streams_live() == 0)
        assert srv.infer_dump()["cancelled"] >= 1
    finally:
        ch.close()
        srv.close()


def test_infer_deadline_expiry_raises_cancelled():
    port.set_flag("trpc_infer_step_us", "20000")
    srv = port.Server()
    srv.enable_infer(prefix_cache=False)
    srv.start(0)
    ch = port.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
    try:
        comp = port.InferClient(ch).submit(_prompt(5, 4),
                                           max_new_tokens=256,
                                           timeout_ms=400)
        got = []
        with pytest.raises(infer.CancelledError):
            for tok in comp:
                got.append(tok)
        assert 0 < len(got) < 256 and comp.cancelled
        assert _wait(lambda: srv.infer_streams_live() == 0)
    finally:
        ch.close()
        srv.close()


def test_infer_overload_sheds_typed_like_reference():
    port.set_flag("trpc_infer_batch_max", "2")
    port.set_flag("trpc_infer_queue_max", "6")  # cap 8, pressure at live >= 4
    port.set_flag("trpc_infer_step_us", "5000")
    srv = port.Server()
    srv.enable_infer(prefix_cache=False)
    srv.start(0)
    addr = f"127.0.0.1:{srv.port}"
    ch = port.Channel(addr, timeout_ms=5000)
    ref_ch = ref.Channel(addr, timeout_ms=5000)
    held = []
    try:
        hog = port.InferClient(ch, tenant="hog")
        victim = port.InferClient(ch, tenant="victim")
        for i in range(4):
            held.append(hog.submit(_prompt(10 + i, 4), max_new_tokens=200,
                                   timeout_ms=30000))
        held.append(victim.submit(_prompt(20, 4), max_new_tokens=200,
                                  timeout_ms=30000))
        shed = {}
        for name, client in (
                ("port", hog),
                ("reference", ref.InferClient(ref_ch, tenant="hog"))):
            with pytest.raises(PKGS[name].OverloadedError) as ei:
                client.submit(_prompt(21, 4), max_new_tokens=200,
                              timeout_ms=30000)
            shed[name] = (type(ei.value).__name__, ei.value.code)
        assert shed["port"] == shed["reference"] == ("OverloadedError", 2005)
        held.append(victim.submit(_prompt(22, 4), max_new_tokens=200,
                                  timeout_ms=30000))
        assert srv.infer_dump()["shed"] >= 2
    finally:
        for c in held:
            c.close()
        assert _wait(lambda: srv.infer_streams_live() == 0, 10.0)
        ch.close()
        ref_ch.close()
        srv.close()
