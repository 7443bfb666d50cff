"""Port parity: brpc_tpu_torch.rpc.kv against brpc_tpu.rpc.kv.

Both packages load the same libtpurpc.so, so one native block store and
registry serve both packages' clients: a block the port publishes out of
its RmaBuffer is fetched by both KvClients.  The store is process-wide;
every test starts and ends with it empty (`kv.reset()`)."""

import numpy as np
import pytest
import torch

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import kv as ref_kv
from brpc_tpu_torch.rpc import kv as port_kv

BB = 4 << 20  # block bytes: above the stripe threshold (one-sided landing)
PKGS = {"reference": ref, "port": port}


def _pattern(n: int, salt: int) -> np.ndarray:
    return ((np.arange(n, dtype=np.uint64) * 2654435761 + salt * 97)
            >> 13).astype(np.uint8)


def _rx() -> int:
    return int(port.observe.Vars.dump().get("rma_rx_msgs", 0))


@pytest.fixture()
def node():
    """One prefill node on the port's Server: store + registry, two blocks
    published from a port RmaBuffer (filled through its tensor view) and
    registered by the port's registry client."""
    port_kv.reset()
    srv = port.Server()
    srv.enable_kv_store()
    srv.enable_kv_registry()
    srv.start(0)
    addr = f"127.0.0.1:{srv.port}"
    pages = port.RmaBuffer(2 * BB)
    pages.tensor[:BB].copy_(torch.from_numpy(_pattern(BB, 1)))
    pages.tensor[BB:].copy_(torch.from_numpy(_pattern(BB, 2)))
    reg = port_kv.KvRegistryClient(port.Channel(addr, timeout_ms=10000),
                                   owns_channel=True)
    metas = {}
    for i in (1, 2):
        metas[i] = port_kv.publish(i, pages, offset=(i - 1) * BB, length=BB,
                                   lease_ms=600000, node=addr)
        reg.register(metas[i], lease_ms=600000)
    clients = {name: mod.kv.KvClient(addr, use_shm=True)
               for name, mod in PKGS.items()}
    yield addr, pages, reg, metas, clients
    for c in clients.values():
        c.close()
    reg.close()
    pages.free()
    srv.close()
    port_kv.reset()


@pytest.mark.parametrize("fields", [
    (1, 1, 7, 0, 4096, "127.0.0.1:80", 0),
    ((1 << 64) - 1, 1 << 40, 3, 1 << 33, 1, "n" * 90, 0),
])
@pytest.mark.parametrize("lease_ms", [0, 600000, -5])
def test_wire_pack_bytes_equal(fields, lease_ms):
    assert port_kv._WIRE.format == ref_kv._WIRE.format
    assert port_kv._PREFIX_WIRE.format == ref_kv._PREFIX_WIRE.format
    bid, gen, rkey, off, length, node, _lease = fields
    a = port_kv.KvBlockMeta(*fields)
    b = ref_kv.KvBlockMeta(*fields)
    assert a.pack(lease_ms) == b.pack(lease_ms)
    assert vars(port_kv.KvBlockMeta.unpack(b.pack(lease_ms))) == \
        vars(ref_kv.KvBlockMeta.unpack(a.pack(lease_ms)))
    assert port_kv._req(bid, gen, lease_ms) == ref_kv._req(bid, gen, lease_ms)
    pre = (bid, gen, rkey, off, length, 9, 4 << 10, 1 << 20, 3, node, 0, 1)
    pa, pb = port_kv.KvPrefixMeta(*pre), ref_kv.KvPrefixMeta(*pre)
    assert pa.pack(lease_ms) == pb.pack(lease_ms)
    raw = b"\x00" * 5 + pb.pack(lease_ms)
    assert vars(port_kv.KvPrefixMeta.unpack(raw, 5)) == \
        vars(ref_kv.KvPrefixMeta.unpack(raw, 5))


def test_content_hash_and_prefix_chain_equal():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << 32, size=4099, dtype=np.uint32)
    tokens = [int(t) for t in rng.integers(0, 1 << 40, size=300)]
    want = ref_kv.content_hash(data.tobytes(), tokens)
    assert port_kv.content_hash(data.tobytes(), tokens) == want
    # A tensor hashes as its contiguous bytes, whatever its dtype/shape.
    t = torch.from_numpy(data.view(np.int32)).view(torch.uint32)
    assert port_kv.content_hash(t, tokens) == want
    as_u8 = torch.from_numpy(data.view(np.uint8).copy())
    assert port_kv.content_hash(as_u8, tokens) == want
    strided = torch.from_numpy(data.view(np.uint8).reshape(2, -1).T.copy())
    assert port_kv.content_hash(strided.T, tokens) == want
    assert port_kv.content_hash(b"", ()) == ref_kv.content_hash(b"", ())
    for bt in (0, 16, 128):
        assert port_kv.prefix_chain(tokens, bt) == \
            ref_kv.prefix_chain(tokens, bt)
    assert port_kv.prefix_chain([]) == ref_kv.prefix_chain([]) == []


def test_publish_refuses_device_tensor():
    with pytest.raises(TypeError, match="RmaBuffer"):
        port_kv.publish(1, torch.empty(16, dtype=torch.uint8, device="meta"))


def test_block_from_port_rmabuffer_fetched_alike(node):
    addr, pages, reg, metas, clients = node
    assert metas[1].generation == 1 and metas[2].node == addr
    assert port_kv.store_count() == ref_kv.store_count() == 2
    assert port_kv.registry_count() == 2
    assert port_kv.store_bytes_used() == 2 * BB
    assert reg.renew(1, lease_ms=600000) == 1
    assert vars(reg.lookup(2)) | {"lease_left_ms": 0} == \
        vars(metas[2]) | {"lease_left_ms": 0}
    for i in (1, 2):
        got = {name: c.fetch(i) for name, c in clients.items()}
        assert got["port"] == got["reference"] == _pattern(BB, i).tobytes()
    for c in clients.values():
        assert (c.cache_hits, c.cache_misses) == (0, 2)


@pytest.mark.parametrize("land", ["port_rmabuffer", "cpu_tensor"])
def test_one_sided_landing(node, land):
    """Over shm a block lands in a port RmaBuffer one-sided (rma_rx_msgs
    moves); a uint8 CPU tensor takes the landing too; the reference's
    client landing in its own RmaBuffer sees the same bytes."""
    addr, pages, reg, metas, clients = node
    want = _pattern(BB, 2)
    rx0 = _rx()
    if land == "port_rmabuffer":
        with port.RmaBuffer(BB) as buf:
            assert clients["port"].fetch(2, resp_buf=buf) == BB
            got = buf.tensor.numpy().copy()
        assert _rx() > rx0
    else:
        buf = torch.zeros(BB, dtype=torch.uint8)
        assert clients["port"].fetch(2, resp_buf=buf) == BB
        got = buf.numpy()
    assert np.array_equal(got, want)
    with ref.RmaBuffer(BB) as buf:
        assert clients["reference"].fetch(2, resp_buf=buf.view) == BB
        assert np.array_equal(np.frombuffer(buf.view, dtype=np.uint8), want)


def test_small_block_lands_in_caller_buffers(node):
    """A 4 KiB block lands in a uint8 CPU tensor and in a bytearray."""
    addr, pages, reg, metas, clients = node
    small = port.RmaBuffer(4096)
    try:
        small.tensor.copy_(torch.from_numpy(_pattern(4096, 9)))
        reg.register(port_kv.publish(7, small, lease_ms=600000, node=addr),
                     lease_ms=600000)
        for resp in (torch.zeros(4096, dtype=torch.uint8), bytearray(4096)):
            assert clients["port"].fetch(7, resp_buf=resp) == 4096
            assert bytes(resp if isinstance(resp, bytearray)
                         else resp.numpy()) == _pattern(4096, 9).tobytes()
    finally:
        port_kv.reset()
        small.free()


def test_stale_generation_reresolves_with_equal_telemetry(node):
    addr, pages, reg, metas, clients = node
    for c in clients.values():
        assert c.fetch(1) == _pattern(BB, 1).tobytes()
    port_kv.withdraw(1)
    pages.tensor[:BB].copy_(torch.from_numpy(_pattern(BB, 7)))
    m2 = port_kv.publish(1, pages, length=BB, lease_ms=600000, node=addr)
    assert m2.generation == 2
    reg.register(m2, lease_ms=600000)
    for c in clients.values():
        assert c.fetch(1) == _pattern(BB, 7).tobytes()
        assert c.lookup(1).generation == 2
    tele = {name: (c.cache_hits, c.cache_misses, c.invalidations,
                   c.node_reresolves, c.channels_evicted)
            for name, c in clients.items()}
    assert tele["port"] == tele["reference"] == (2, 2, 1, 0, 0)


def test_miss_and_exists_errors_alike(node):
    addr, pages, reg, metas, clients = node
    codes = {}
    for name, mod in PKGS.items():
        kvm = mod.kv
        with pytest.raises(kvm.KvMissError) as miss:
            clients[name].fetch(99)
        with pytest.raises(kvm.KvMissError):
            kvm.withdraw(99)
        with pytest.raises(kvm.KvMissError):
            kvm.renew(99)
        codes[name] = miss.value.code
        assert isinstance(miss.value, mod.RpcError)
    with pytest.raises(port_kv.KvExistsError) as exists:
        reg.register(metas[1], lease_ms=600000)
    with pytest.raises(port_kv.KvExistsError):
        port_kv.publish(1, pages, length=BB, node=addr)
    with pytest.raises(port_kv.KvMissError):
        reg.lookup(99)
    assert codes["port"] == codes["reference"] == 2101
    assert exists.value.code == 2103
    assert port_kv._codes() == ref_kv._codes()


def test_prefix_publish_match_fetch_alike(node):
    """Prefix blocks published by the port from CPU tensors are matched and
    fetched alike by both packages' clients."""
    addr, pages, reg, metas, clients = node
    bt, nbytes = 16, 64 << 10
    tokens = list(range(1000, 1000 + 3 * bt + 5))  # 3 full blocks + tail
    keys = port_kv.prefix_chain(tokens, bt)
    assert len(keys) == 3
    blocks = []
    for d, key in enumerate(keys):
        data = torch.from_numpy(_pattern(nbytes, d + 20))
        span = tokens[d * bt:(d + 1) * bt]
        meta, fresh = port_kv.prefix_publish(key, d, data, span,
                                             lease_ms=600000, node=addr)
        assert fresh and meta.hash == ref_kv.content_hash(
            data.numpy().tobytes(), span)
        assert meta.length == nbytes and meta.key == key
        assert reg.put_prefix(meta, lease_ms=600000) == (meta.generation,
                                                         True)
        again, fresh = port_kv.prefix_publish(key, d, data, span,
                                              lease_ms=600000, node=addr)
        assert not fresh and again.hash == meta.hash
        blocks.append(data.numpy().tobytes())
    assert port_kv.prefix_store_count() == ref_kv.prefix_store_count() == 3
    assert port_kv.prefix_registry_count() == 3
    assert port_kv.prefix_hot_bytes() + port_kv.prefix_cold_bytes() >= \
        3 * nbytes
    assert port_kv.prefix_counters() == ref_kv.prefix_counters()
    groups = {name: c.match_prefix(tokens, bt) for name, c in clients.items()}
    assert [[vars(r) | {"lease_left_ms": 0} for r in g]
            for g in groups["port"]] == [
        [vars(r) | {"lease_left_ms": 0} for r in g]
        for g in groups["reference"]]
    assert len(groups["port"]) == 3
    assert port_kv.KvClient.prefix_hint(groups["port"]) == addr
    for c in clients.values():
        assert c.fetch_prefix(tokens, bt) == blocks
    with pytest.raises(ValueError, match="empty"):
        port_kv.prefix_publish(keys[0], 0, torch.empty(0), tokens[:bt])
    port_kv.prefix_withdraw(groups["port"][0][0].hash)
    with pytest.raises(port_kv.KvMissError):
        port_kv.prefix_withdraw(groups["port"][0][0].hash)


class _View:
    """A response the runtime returned as a view (not landed in place)."""

    def __init__(self, data: bytes):
        self.data, self.released = data, False

    def view(self):
        return memoryview(self.data)

    def release(self):
        self.released = True


class _Pipe:
    def __init__(self, completion):
        self.completion, self.submitted = completion, None

    def submit(self, method, reqs, resp_bufs, timeout_ms):
        self.submitted = (method, reqs, resp_bufs)
        return [1]

    def poll(self, max_n, timeout_ms):
        return [self.completion]

    def close(self):
        pass


class _Channel:
    def __init__(self, completion):
        self.pipe = _Pipe(completion)

    def pipeline(self):
        return self.pipe


@pytest.mark.parametrize("kind", ["bytearray", "cpu_tensor", "rmabuffer"])
def test_copy_path_degradation_writes_through_landing_bytes(kind):
    """Where the runtime hands back a view instead of landing in place,
    `_fetch_into` copies it into the landing buffer by the rule of
    `batch._landing_bytes` — the reference's memoryview copy, for tensors
    and RmaBuffers too."""
    payload = _pattern(1000, 4).tobytes()
    resp = {"bytearray": lambda: bytearray(1024),
            "cpu_tensor": lambda: torch.zeros(1024, dtype=torch.uint8),
            "rmabuffer": lambda: port.RmaBuffer(1024)}[kind]()
    view = _View(payload)
    c = port.Completion(token=1, status=0, error="", resp_len=1000,
                        in_caller_buffer=False, data=view)
    ch = _Channel(c)
    cli = port_kv.KvClient.__new__(port_kv.KvClient)
    cli._timeout_ms = 1000
    assert cli._fetch_into(ch, b"req", resp) == 1000
    assert ch.pipe.submitted == (port_kv.FETCH_METHOD, [b"req"], [resp])
    assert view.released
    got = bytes(port.batch._landing_bytes(resp)[:1000])
    assert got == payload
    if kind == "bytearray":  # the reference's own copy, same bytes
        want = bytearray(1024)
        rc = ref.Completion(token=1, status=0, error="", resp_len=1000,
                            in_caller_buffer=False, data=_View(payload))
        rcli = ref_kv.KvClient.__new__(ref_kv.KvClient)
        rcli._timeout_ms = 1000
        assert rcli._fetch_into(_Channel(rc), b"req", want) == 1000
        assert bytes(want) == bytes(resp)
    if kind == "rmabuffer":
        resp.free()
