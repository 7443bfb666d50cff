"""Port parity: brpc_tpu_torch.rpc.collective against brpc_tpu.rpc.collective.

Four in-process members per package (a Server with the collective
handlers and a Group each), both packages over the same libtpurpc.so; the
same data goes through the port's fleet and the reference's, and the
results are held byte-exact against numpy and against each other.  Every
member thread is joined under a timeout, so a wedge fails its test."""

import threading
import time

import numpy as np
import pytest
import torch

import brpc_tpu.rpc as ref
import brpc_tpu_torch.rpc as port
from brpc_tpu.rpc import collective as ref_coll
from brpc_tpu_torch.rpc import collective as port_coll

N = 4
SHARD = 64 << 10
JOIN_S = 60
PKGS = {"reference": ref, "port": port}


class Fleet:
    def __init__(self, mod, n=N, timeout_ms=20000):
        self.mod = mod
        self.servers = []
        for _ in range(n):
            s = mod.Server()
            s.enable_collective()
            s.start(0)
            self.servers.append(s)
        self.members = [f"127.0.0.1:{s.port}" for s in self.servers]
        self.groups = [mod.collective.Group(self.members, r,
                                            timeout_ms=timeout_ms)
                       for r in range(n)]
        self.n = n
        self.seq = 0

    def run_all(self, fn):
        """fn(group, rank, seq) on every member at once; raises the first
        member error, or TimeoutError for a member still running."""
        self.seq += 1
        errs = [None] * self.n

        def go(r):
            try:
                fn(self.groups[r], r, self.seq)
            except Exception as e:  # noqa: BLE001 — raised below
                errs[r] = e

        threads = [threading.Thread(target=go, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + JOIN_S
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0))
        if any(t.is_alive() for t in threads):
            raise TimeoutError("collective member wedged")
        for e in errs:
            if e is not None:
                raise e

    def close(self):
        for g in self.groups:
            g.close()
        for s in self.servers:
            s.stop()


@pytest.fixture(scope="module")
def fleets():
    made = {name: Fleet(mod) for name, mod in PKGS.items()}
    yield made
    for f in made.values():
        f.close()


def _quiesced() -> bool:
    deadline = time.monotonic() + 5
    while port_coll.sessions_live() and time.monotonic() < deadline:
        time.sleep(0.02)
    return port_coll.sessions_live() == 0


def _bufs(pkg, kind, size):
    """N buffers of `size` bytes: RmaBuffers, or (port only) CPU tensors."""
    if kind == "rma":
        return [PKGS[pkg].RmaBuffer(size) for _ in range(N)]
    return [torch.zeros(size, dtype=torch.uint8) for _ in range(N)]


def _np(buf) -> np.ndarray:
    if isinstance(buf, torch.Tensor):
        return buf.numpy()
    return np.frombuffer(buf.view, dtype=np.uint8)


def _free(bufs):
    for b in bufs:
        if hasattr(b, "free"):
            b.free()


OPS = {
    # op: (send bytes per rank, recv bytes per rank)
    "all_gather": (SHARD, N * SHARD),
    "reduce_scatter": (N * SHARD, SHARD),
    "all_to_all": (N * SHARD, N * SHARD),
}


def _send_data(op: str) -> list[np.ndarray]:
    rng = np.random.default_rng(13)
    return [rng.integers(0, 256, size=OPS[op][0], dtype=np.uint8)
            for _ in range(N)]


def _numpy_want(op: str, data: list[np.ndarray]) -> list[np.ndarray]:
    if op == "all_gather":
        return [np.concatenate(data)] * N
    if op == "reduce_scatter":
        total = sum(d.view(np.uint32).astype(np.uint64) for d in data)
        summed = (total % (1 << 32)).astype(np.uint32).view(np.uint8)
        return [summed[r * SHARD:(r + 1) * SHARD] for r in range(N)]
    return [np.concatenate([data[src][d * SHARD:(d + 1) * SHARD]
                            for src in range(N)]) for d in range(N)]


def _run(fleet, op, sends, recvs):
    fleet.run_all(lambda g, r, seq: getattr(g, op)(
        sends[r], recvs[r], shard_bytes=SHARD, run_seq=seq))


@pytest.mark.parametrize("kind", ["rma", "cpu_tensor"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_collective_matches_numpy_and_reference(fleets, op, kind):
    data = _send_data(op)
    want = _numpy_want(op, data)
    got = {}
    for pkg in ("reference", "port"):
        bkind = kind if pkg == "port" else "rma"
        sends = _bufs(pkg, bkind, OPS[op][0])
        recvs = _bufs(pkg, bkind, OPS[op][1])
        try:
            for r in range(N):
                _np(sends[r])[:] = data[r]
            _run(fleets[pkg], op, sends, recvs)
            got[pkg] = [_np(b).copy() for b in recvs]
            if op == "reduce_scatter":  # the ring accumulator is mutated
                assert any(not np.array_equal(_np(sends[r]), data[r])
                           for r in range(N))
        finally:
            _free(sends)
            _free(recvs)
    for r in range(N):
        assert np.array_equal(got["port"][r], want[r]), (op, r)
        assert np.array_equal(got["port"][r], got["reference"][r]), (op, r)
    assert _quiesced()


def test_group_properties_alike(fleets):
    for r in range(N):
        a, b = fleets["port"].groups[r], fleets["reference"].groups[r]
        assert (a.rank, a.size, a.naming_version) == \
            (b.rank, b.size, b.naming_version) == (r, N, 0)


def test_reshard_moves_only_changed_bytes_alike(fleets):
    total = N * SHARD
    q = total // N
    shift = 4 << 10
    src = [(r, r * q, q) for r in range(N)]
    dst = [(0, 0, q + shift)] + [(r, r * q + shift, q)
                                 for r in range(1, N - 1)] + [
        (N - 1, (N - 1) * q + shift, q - shift)]
    glob = np.random.default_rng(3).integers(0, 256, size=total,
                                             dtype=np.uint8)
    got = {}
    for pkg in ("reference", "port"):
        mod = PKGS[pkg]
        sends = [mod.RmaBuffer(ln) for _, _, ln in src]
        recvs = [mod.RmaBuffer(ln) for _, _, ln in dst]
        try:
            for (_, off, ln), b in zip(src, sends):
                _np(b)[:] = glob[off:off + ln]
            fleets[pkg].run_all(lambda g, r, seq: g.reshard(
                src, dst, total, sends[r], recvs[r], run_seq=seq))
            got[pkg] = [_np(b).copy() for b in recvs]
        finally:
            _free(sends)
            _free(recvs)
    for (_, off, ln), p, r in zip(dst, got["port"], got["reference"]):
        assert np.array_equal(p, glob[off:off + ln])
        assert np.array_equal(p, r)


def test_plan_reshard_and_pack_ranges_equal(fleets):
    total = 1 << 20
    q = total // 4
    src = [(r, r * q, q) for r in range(4)]
    shift = 64 << 10
    dst = [(0, 0, q + shift), (1, q + shift, q), (2, 2 * q + shift, q),
           (3, 3 * q + shift, q - shift)]
    assert port_coll.pack_ranges(src + dst) == ref_coll.pack_ranges(src + dst)
    assert port_coll._RANGE_WIRE.format == ref_coll._RANGE_WIRE.format
    for s, d in ((src, dst), (src, src)):
        assert port_coll.plan_reshard_bytes(s, d, total, 4) == \
            ref_coll.plan_reshard_bytes(s, d, total, 4)
    plan = port_coll.plan_reshard_bytes(src, dst, total, 4)
    assert plan["bytes_moved"] == 3 * shift < plan["naive_bytes"]
    with pytest.raises(ValueError):
        port_coll.plan_reshard_bytes(src, src[:2], total, 4)
    ch = port.Channel(fleets["port"].members[0], timeout_ms=10000)
    try:
        wire = port_coll.ReshardClient(ch).plan(src, dst, total, 4)
    finally:
        ch.close()
    assert {k: wire[k] for k in plan} == plan and wire["transfers"] > 0
    members = fleets["port"].members
    for rank in range(4):
        assert port_coll.ReshardClient.execute_request(
            91, members, rank, src, dst, total, 500, 600) == \
            ref_coll.ReshardClient.execute_request(
                91, members, rank, src, dst, total, 500, 600)


def test_wire_structs_equal():
    for name in ("_PUT_WIRE", "_RESHARD_WIRE", "_RANGE_WIRE", "_PLAN_WIRE"):
        a, b = getattr(port_coll, name), getattr(ref_coll, name)
        assert (a.format, a.size) == (b.format, b.size), name
    assert (port_coll.ALL_GATHER, port_coll.REDUCE_SCATTER,
            port_coll.ALL_TO_ALL) == (ref_coll.ALL_GATHER,
                                      ref_coll.REDUCE_SCATTER,
                                      ref_coll.ALL_TO_ALL)


def test_typed_errors_same_family_and_code(fleets):
    assert port_coll._codes() == ref_coll._codes() == (2121, 2122, 2123)
    for code, cls in zip((2121, 2122, 2123),
                         ("CollAbortError", "CollEpochError",
                          "CollMismatchError")):
        e = port_coll._coll_error(code, "x")
        assert type(e).__name__ == type(ref_coll._coll_error(
            code, "x")).__name__ == cls
        assert isinstance(e, port_coll.CollError)
        assert isinstance(e, port.RpcError)
    assert type(port_coll._coll_error(7, "x")) is port_coll.CollError
    codes = {}
    for pkg, mod in PKGS.items():
        small = mod.RmaBuffer(1 << 16)
        try:
            with pytest.raises(mod.collective.CollMismatchError) as ei:
                fleets[pkg].groups[0].all_gather(small, small,
                                                 shard_bytes=1 << 16,
                                                 run_seq=10 ** 6)
            codes[pkg] = ei.value.code
        finally:
            small.free()
    assert codes["port"] == codes["reference"] == 2123
    assert _quiesced()


def test_buffers_the_port_refuses():
    with pytest.raises(TypeError, match="RmaBuffer"):
        port_coll._buf_addr_len(torch.empty(8, device="meta"))
    with pytest.raises(TypeError, match="contiguous"):
        port_coll._buf_addr_len(torch.zeros(4, 4).T)
    with pytest.raises(TypeError):
        port_coll._buf_addr_len(memoryview(bytearray(8)).toreadonly())
    t = torch.zeros(10, dtype=torch.int32)
    assert port_coll._buf_addr_len(t) == (t.data_ptr(), 40)
    raw = b"abc"
    assert port_coll._buf_addr_len(raw)[1] == ref_coll._buf_addr_len(raw)[1]
    buf = bytearray(16)
    assert port_coll._buf_addr_len(buf) == ref_coll._buf_addr_len(buf)


def test_ready_map_contract_alike():
    got = {}
    for pkg, mod in PKGS.items():
        buf = mod.RmaBuffer(256 << 10)
        try:
            live0 = mod.collective.ready_maps_live()
            m = mod.collective.ReadyMap(buf, granularity=64 << 10)
            assert m.handle != 0 and m.nbytes == 256 << 10
            errs = []
            for off, ln in ((1, 64 << 10), (0, 512 << 10),
                            (0, (64 << 10) + 1)):
                with pytest.raises(ValueError) as ei:
                    m.stamp(off, ln)
                errs.append(str(ei.value))
            m.stamp(0, 64 << 10)
            m.stamp(0, 64 << 10)  # monotonic: a restamp is a no-op
            m.stamp(64 << 10, 192 << 10)  # reaches the buffer end
            assert mod.collective.ready_maps_live() == live0 + 1
            m.close()
            assert m.handle == 0
            assert mod.collective.ready_maps_live() == live0
            with pytest.raises(ValueError, match="creation failed"):
                mod.collective.ReadyMap(b"")
            got[pkg] = errs
        finally:
            buf.free()
    assert got["port"] == got["reference"]
    t = torch.zeros(128 << 10, dtype=torch.uint8)
    with port_coll.ReadyMap(t, granularity=64 << 10) as m:
        m.stamp(0, 128 << 10)
    assert port.get_flag("trpc_coll_overlap") == "false"


def test_overlapped_reduce_scatter_stamped_by_torch_producer(fleets):
    """A torch producer thread per member fills its send buffer piece by
    piece and stamps each piece after writing it, while the member's
    reduce_scatter already runs with trpc_coll_overlap on: byte-exact with
    the plain (unstamped, overlap off) run, with readiness triggers."""
    fleet = fleets["port"]
    words = SHARD // 4

    def piece(r, p):
        base = torch.arange(words, dtype=torch.int64) * 2654435761
        v = (base + r * 1000003 + p * 101 + 1) & 0xFFFFFFFF
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    def fill(send, r):
        for p in range(N):
            send.tensor[p * SHARD:(p + 1) * SHARD].copy_(
                piece(r, p).view(torch.uint8))

    sends = [port.RmaBuffer(N * SHARD) for _ in range(N)]
    recvs = [port.RmaBuffer(SHARD) for _ in range(N)]
    try:
        for r in range(N):
            fill(sends[r], r)
        _run(fleet, "reduce_scatter", sends, recvs)
        golden = [b.tensor.clone() for b in recvs]
        for b in sends:
            b.tensor.zero_()
        for b in recvs:
            b.tensor.zero_()

        port.set_flag("trpc_coll_overlap", "true")
        trig0 = port.observe.Vars.dump().get("coll_ready_triggers_total", 0)
        maps = [port_coll.ReadyMap(sends[r], granularity=SHARD)
                for r in range(N)]

        def member(g, r, seq):
            def producer():
                for p in range(N):
                    sends[r].tensor[p * SHARD:(p + 1) * SHARD].copy_(
                        piece(r, p).view(torch.uint8))
                    maps[r].stamp(p * SHARD, SHARD)
                    time.sleep(0.002)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            g.reduce_scatter(sends[r], recvs[r], shard_bytes=SHARD,
                             run_seq=seq, ready=maps[r])
            t.join(JOIN_S)
            assert not t.is_alive(), "producer wedged"

        try:
            fleet.run_all(member)
        finally:
            port.set_flag("trpc_coll_overlap", "false")
            for m in maps:
                m.close()
        trig = port.observe.Vars.dump().get("coll_ready_triggers_total", 0)
        assert trig > trig0
        for r in range(N):
            assert torch.equal(recvs[r].tensor, golden[r]), r
        want = _numpy_want("reduce_scatter", [
            torch.cat([piece(r, p) for p in range(N)]).view(
                torch.uint8).numpy() for r in range(N)])
        for r in range(N):
            assert np.array_equal(golden[r].numpy(), want[r])
        assert _quiesced() and port_coll.ready_maps_live() == 0
    finally:
        _free(sends)
        _free(recvs)


def test_rma_scavenge_and_sessions_probe():
    assert isinstance(port_coll.rma_scavenge(), int)
    assert port_coll.sessions_live() == ref_coll.sessions_live()
