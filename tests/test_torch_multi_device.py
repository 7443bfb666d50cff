"""The port's multi-device plane on the CPU: peer-to-device mapping and its
validation, K2's launch plan per source device, the cross-card bound, and
every program that runs on the Fabric with its devices given in list form
(one entry per peer), against the JAX package on the conftest's 8-device
CPU mesh.  Data movement and integer results are bit-exact; float results
sum small integers, so they are exact too; ring attention holds the
dryrun's 1e-5.  On the CPU every peer's device is the one CPU device; the
CUDA paths (per-peer streams, one K2 launch per card) run on the card in
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from brpc_tpu.channels import ParallelChannel as JParallel
from brpc_tpu.channels import PartitionChannel as JPartition
from brpc_tpu.channels import SelectiveChannel as JSelective
from brpc_tpu.models.echo import make_full_dataplane_step as jax_full_step
from brpc_tpu.models.echo import make_nton_exchange as jax_nton
from brpc_tpu.models.echo import make_ring_exchange as jax_ring_exchange
from brpc_tpu.models.ring_attention import ring_attention as jax_ring_attn
from brpc_tpu.ops.ring_kernel import ring_all_gather_pallas
from brpc_tpu.parallel.fabric import Fabric as JFabric
from brpc_tpu.parallel.fabric import P as JP
from brpc_tpu.streaming import stream_echo as jax_stream_echo
from brpc_tpu.transport.ici import IciTransport as JIci
from brpc_tpu_torch import tensor_from_numpy
from brpc_tpu_torch.channels import (ParallelChannel, PartitionChannel,
                                     SelectiveChannel)
from brpc_tpu_torch.graft_entry import dryrun_multichip
from brpc_tpu_torch.models.echo import (make_full_dataplane_step,
                                        make_nton_exchange,
                                        make_ring_exchange)
from brpc_tpu_torch.models.ring_attention import (attention_reference,
                                                  ring_attention)
from brpc_tpu_torch.ops import ring_kernel, roofline
from brpc_tpu_torch.ops.ring_kernel import (plan_gather, plan_launches,
                                            ring_all_gather_kernel)
from brpc_tpu_torch.parallel import Fabric, P
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.parallel.fabric import current
from brpc_tpu_torch.streaming import stream_echo
from brpc_tpu_torch.transport import IciTransport

N = 8
TIMEOUT_S = 60
MIB = 1 << 20
CPUS = ["cpu"] * N


def _fab(shape=(N,), names=("link",)):
    return Fabric.auto(shape, names, devices=CPUS, timeout_s=TIMEOUT_S)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _t(arr) -> torch.Tensor:
    return tensor_from_numpy(arr, "cpu")


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


# -- peers and devices ------------------------------------------------------

def test_devices_map_to_peers_row_major_with_repeats():
    cards = [0, 0, 1, 1, 2, 2, 3, 3]
    fab = Fabric.auto((2, 4), ("dp", "link"),
                      devices=[f"cuda:{i}" for i in cards])
    assert fab.devices == tuple(torch.device("cuda", i) for i in cards)
    assert fab.device == torch.device("cuda", 0)
    # Peer (dp=1, link=2) is flat rank 6, on the device listed sixth.
    assert fab.devices[fab.rank_of((1, 2))] == torch.device("cuda", 3)
    assert [fab.devices[r] for r in fab.group(5, "dp")] == [
        torch.device("cuda", 0), torch.device("cuda", 2)]


def test_one_device_is_shared_by_every_peer():
    fab = Fabric.auto((2, 4), ("dp", "link"), devices="cpu")
    assert fab.devices == (torch.device("cpu"),) * N
    assert fab.streams == ()  # no streams off CUDA
    listed = Fabric.auto(axis_names=("dp", "link"), devices=CPUS)
    assert listed.shape == {"dp": 1, "link": N}
    assert listed.devices == fab.devices


def test_cuda_without_an_index_is_the_current_card():
    fab = Fabric.auto((2,), ("link",), devices="cuda")
    assert fab.devices == (torch.device("cuda", 0),) * 2


@pytest.mark.parametrize("devices", [
    ["cpu", "cuda:0"], ["cuda:0", "cpu"], ["cuda:1", "meta"],
    ["cpu", "cpu", "meta", "cpu"]])
def test_a_mix_of_device_types_raises(devices):
    with pytest.raises(ValueError, match="one type"):
        Fabric.auto(axis_names=("link",), devices=devices)
    with pytest.raises(ValueError, match="one type"):
        Fabric((len(devices),), ("link",), devices)


def test_device_count_must_match_the_mesh():
    with pytest.raises(ValueError, match="device count"):
        Fabric.auto((2, 4), ("dp", "link"), devices=["cuda:0"] * 4)
    with pytest.raises(ValueError, match="device count"):
        Fabric((4,), ("link",), ["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh shape"):
        Fabric.auto(axis_names=("link",), devices="cpu")


def test_no_devices_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fabric.auto()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fabric.auto((2,), ("link",))


def test_no_devices_lays_one_peer_on_each_card(monkeypatch):
    """As the reference lays one peer on each of jax.devices(); with a
    shape, every peer on the GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    fab = Fabric.auto()
    assert fab.shape == {"link": 4}
    assert fab.devices == tuple(torch.device("cuda", i) for i in range(4))
    shared = Fabric.auto((2, 2), ("dp", "link"))
    assert shared.devices == (torch.device("cuda", 0),) * 4


def test_shards_land_in_each_peers_device_memory():
    fab = Fabric.auto(axis_names=("link",), devices=["meta"] * 4)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    shards = [fab.shard(x, P("link"), r) for r in range(4)]
    assert all(s.device.type == "meta" and s.shape == (2, 3)
               for s in shards)
    cpu = Fabric.auto(axis_names=("link",), devices=["cpu"] * 4)
    view = cpu.shard(x, P("link"), 2)
    assert view.data_ptr() == x[4:6].data_ptr()  # a view where x lies


def test_each_body_runs_on_its_peers_device():
    fab = _fab((2, 4), ("dp", "link"))
    seen = []

    def body(x):
        ctx = current()
        seen.append((ctx.rank, ctx.device, ctx.stream,
                     coll.axis_index("link").device, x.device))
        return x

    fab.spmd(body, in_specs=P(("dp", "link")), out_specs=P(("dp", "link")))(
        torch.zeros(N))
    assert sorted(r for r, *_ in seen) == list(range(N))
    assert all(d == torch.device("cpu") and s is None and a == d and x == d
               for _, d, s, a, x in seen)


def test_group_call_hands_values_and_streams_in_axis_order():
    fab = _fab((2, 4), ("dp", "link"))
    calls = []

    def fn(vals, streams):
        calls.append(([int(v) for v in vals], streams))
        return [v * 10 for v in vals]

    out = fab.spmd(lambda x: coll.group_call(x, "link", fn),
                   in_specs=P(("dp", "link")), out_specs=P(("dp", "link")))(
        torch.arange(N))
    assert sorted(calls) == [([0, 1, 2, 3], [None] * 4),
                             ([4, 5, 6, 7], [None] * 4)]
    assert out.tolist() == [10 * r for r in range(N)]


# -- K2's launch plan per source device --------------------------------------

def _addrs(n, size):
    """Chunk j at j * size, output r at (n + r) * n * size: aligned."""
    return ([j * size for j in range(n)],
            [(n + r) * n * size for r in range(n)])


@pytest.mark.parametrize("devices,want", [
    ([0, 1, 2, 3], [(0, (0,)), (1, (1,)), (2, (2,)), (3, (3,))]),
    ([0, 0, 1, 1], [(0, (0, 1)), (1, (2, 3))]),
    ([1, 1, 0, 0], [(1, (0, 1)), (0, (2, 3))]),
    ([0, 1, 0, 1, 0, 1, 0, 1], [(0, (0, 2, 4, 6)), (1, (1, 3, 5, 7))]),
    ([2] * 4, [(2, (0, 1, 2, 3))]),
])
def test_one_launch_per_source_device(devices, want):
    n, size = len(devices), 8 * MIB
    src, out = _addrs(n, size)
    plans = plan_launches(size, devices, src, out, lambda d: 132)
    assert [(p.device, p.sources) for p in plans] == want
    tiles = -(-size // plans[0].tile_bytes)
    for p in plans:
        assert p.units == len(p.sources) * tiles
        assert 1 <= p.grid <= p.units


def test_one_card_is_one_launch_as_plan_gather():
    n, size = 8, 8 * MIB
    src, out = _addrs(n, size)
    (plan,) = plan_launches(size, [0] * n, src, out, lambda d: 132)
    single = plan_gather(size, n, src + out, 132)
    assert plan == single
    assert (plan.path, plan.width, plan.tile_bytes, plan.units,
            plan.grid) == ("bulk", 16, 32768, 2048, 132)


@pytest.mark.parametrize("devices", [[0, 1, 2, 3], [0, 0, 1, 1], [0] * 4])
def test_outputs_on_other_cards_take_the_same_paths(devices):
    """Bulk stores reach another card's output through its NVLink mapping,
    so where the outputs lie does not change a launch's path."""
    n, size = len(devices), 8 * MIB
    src, out = _addrs(n, size)
    for p in plan_launches(size, devices, src, out, lambda d: 132):
        want = plan_gather(size, n, [src[j] for j in p.sources] + out, 132,
                           sources=p.sources, device=p.device)
        assert p == want
        assert (p.path, p.width, p.tile_bytes, p.grid) == (
            "bulk", 16, 32768, min(132, p.units))


@pytest.mark.parametrize("size,addr_step,want_width", [
    (30, 30, 2),          # a (3, 5) bf16 chunk: 2-byte stores
    (12, 12, 4),          # a (3, 1) f32 chunk
    (48, 8, 8),           # 8-byte aligned pointers
    (4096, 4096, 16),     # whole 16-byte vectors: the bulk path
])
def test_each_launch_takes_the_widest_width_of_its_own_sources(
        size, addr_step, want_width):
    devices = [0, 1]
    src = [(2 * j + 1) * addr_step for j in range(2)]  # odd multiples
    out = [4096 * (r + 1) for r in range(2)]
    plans = plan_launches(size, devices, src, out, lambda d: 132)
    path = "bulk" if want_width == 16 else "ragged"
    assert [(p.path, p.width) for p in plans] == [(path, want_width)] * 2
    assert all(size % p.width == 0 and p.tile_bytes % p.width == 0
               for p in plans)


def test_a_launch_ignores_the_alignment_of_other_devices_sources():
    # Source 1 (device 1) is 8-byte aligned; device 0's launch never reads
    # it, so it keeps the bulk path.
    src, out = [0, 8], [4096, 8192]
    plans = plan_launches(4096, [0, 1], src, out, lambda d: 132)
    assert [(p.device, p.width) for p in plans] == [(0, 16), (1, 8)]


def test_each_launch_takes_its_devices_sm_count():
    src, out = _addrs(4, 64 * MIB)
    sms = {0: 132, 1: 114}
    plans = plan_launches(64 * MIB, [0, 0, 1, 1], src, out, sms.get)
    assert [p.grid for p in plans] == [132, 114]


@pytest.mark.parametrize("rc,match", [
    (-1, "cuda:1 cannot access cuda:3 as a peer"),
    (217, "enabling peer access among .* failed: cudaError 217"),
])
def test_a_pair_without_peer_access_raises(monkeypatch, rc, match):
    """The C entry reports the first pair that cannot reach the other; the
    wrapper raises naming it, with no fallback through host copies."""

    class Lib:
        @staticmethod
        def brpc_ring_enable_peers(devs, k, bad):
            assert list(devs[:k]) == [0, 1, 2, 3]
            bad[0], bad[1] = 1, 3
            return rc

    monkeypatch.setattr(ring_kernel, "_lib", Lib)
    with pytest.raises(RuntimeError, match=match):
        ring_kernel.enable_peers.__wrapped__((0, 1, 2, 3))


# -- the cross-card bound ----------------------------------------------------

@pytest.mark.parametrize("n,chunk,want_ms", [
    # n = 4, C = 8 MiB: NVLink egress (n-1)*C = 25,165,824 B at 450 GB/s
    # (HBM (1+n)*C = 41,943,040 B at 3350 GB/s is 0.0125 ms).
    (4, 8 * MIB, 3 * 8 * MIB / 450e9 * 1e3),
    # n = 8: 58,720,256 B at 450 GB/s, 0.1305 ms.
    (8, 8 * MIB, 7 * 8 * MIB / 450e9 * 1e3),
    # n = 2: (n-1)*C = C at 450 GB/s beats 3*C at 3350 GB/s.
    (2, 1 * MIB, MIB / 450e9 * 1e3),
])
def test_cross_card_bound(n, chunk, want_ms):
    got = roofline.gather_cross_card_bound_ms(n, chunk, 3350.0, 450.0)
    assert got == pytest.approx(want_ms, rel=1e-12)
    # NVLink's 450 GB/s is below every HBM's 3350, so it bounds.
    assert got >= (1 + n) * chunk / 3350e9 * 1e3


def test_cross_card_bound_values_and_table():
    assert roofline.gather_cross_card_bound_ms(
        4, 8 * MIB, 3350, 450) == pytest.approx(0.0559, abs=1e-4)
    assert roofline.gather_cross_card_bound_ms(
        8, 8 * MIB, 3350, 450) == pytest.approx(0.1305, abs=1e-4)
    # The one-card bound at n = 8, 8 MiB, for comparison: (n + n^2) * C.
    assert roofline.gather_bound_ms(8, 8 * MIB, 3350) == pytest.approx(
        0.1803, abs=1e-4)
    assert roofline.nvlink_peak_gbps("NVIDIA H100 80GB HBM3") == 450.0
    assert roofline.nvlink_peak_gbps("a card of no table") is None


# -- every program on the fabric, devices in list form, against JAX ----------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_dryrun_multichip_with_one_device_per_peer(n):
    dryrun_multichip(n, device=["cpu"] * n)


def test_dryrun_multichip_needs_one_device_per_peer():
    with pytest.raises(ValueError, match="7 devices for 8 peers"):
        dryrun_multichip(8, device=["cpu"] * 7)


COLLECTIVES = {
    "axis_index": (lambda x: lax.axis_index("link")[None, None] + x,
                   lambda x: coll.axis_index("link")[None, None] + x),
    "ppermute": (lambda x: lax.ppermute(x, "link", [(0, 3), (3, 1)]),
                 lambda x: coll.ppermute(x, "link", [(0, 3), (3, 1)])),
    "psum": (lambda x: lax.psum(x, "dp"), lambda x: coll.psum(x, "dp")),
    "pmax": (lambda x: lax.pmax(x, "link"), lambda x: coll.pmax(x, "link")),
    "all_gather": (lambda x: lax.all_gather(x, "link", tiled=True),
                   lambda x: coll.all_gather(x, "link", tiled=True)),
    "psum_scatter": (lambda x: lax.psum_scatter(x, "link", tiled=True),
                     lambda x: coll.psum_scatter(x, "link", tiled=True)),
    "all_to_all": (lambda x: lax.all_to_all(x, "link", 0, 0, tiled=True),
                   lambda x: coll.all_to_all(x, "link", 0, 0, tiled=True)),
}


@pytest.mark.parametrize("op", sorted(COLLECTIVES))
def test_collectives_match_lax(op):
    jbody, tbody = COLLECTIVES[op]
    jfab = JFabric.auto((2, 4), ("dp", "link"))
    every = ("dp", "link")
    arr = np.random.default_rng(11).integers(
        -1000, 1000, size=(N * 4, 3)).astype(np.int32)
    want = np.asarray(jax.jit(jfab.spmd(jbody, in_specs=JP(every),
                                        out_specs=JP(every)))(
        jnp.asarray(arr)))
    got = _fab((2, 4), every).spmd(tbody, in_specs=P(every),
                                   out_specs=P(every))(_t(arr))
    np.testing.assert_array_equal(_np(got), want)


def test_ici_transport_matches_jax():
    jring, ring = JFabric.auto((N,), ("link",)), _fab()
    arr = _u32((N * N, 4), seed=12)
    jt, tt = JIci(jring, "link"), IciTransport(ring, "link")
    np.testing.assert_array_equal(
        _np(tt.jit_echo()(_t(arr))),
        np.asarray(jt.jit_echo()(jnp.asarray(arr))))
    np.testing.assert_array_equal(
        _np(tt.jit_all_to_all()(_t(arr))),
        np.asarray(jt.jit_all_to_all()(jnp.asarray(arr))))
    ints = arr.view(np.int32)
    for name in ("put", "all_gather", "reduce_scatter"):
        jfn = jax.jit(jring.spmd(getattr(jt, name), in_specs=JP("link"),
                                 out_specs=JP("link")))
        tfn = ring.spmd(getattr(tt, name), in_specs=P("link"),
                        out_specs=P("link"))
        np.testing.assert_array_equal(
            _np(tfn(_t(ints))), np.asarray(jfn(jnp.asarray(ints))), name)


def test_exchanges_match_jax():
    jring, ring = JFabric.auto((N,), ("link",)), _fab()
    rows = _u32((N * N, 16), seed=13)
    want_recv, want_sums = jax_nton(jring, "link")(jnp.asarray(rows))
    recv, sums = make_nton_exchange(ring, "link")(_t(rows))
    np.testing.assert_array_equal(_np(recv), np.asarray(want_recv))
    np.testing.assert_array_equal(_np(sums), np.asarray(want_sums))
    want_buf, want_carry = jax_ring_exchange(jring, "link")(
        jnp.asarray(rows))
    buf, carry = make_ring_exchange(ring, "link")(_t(rows))
    np.testing.assert_array_equal(_np(buf), np.asarray(want_buf))
    np.testing.assert_array_equal(_np(carry), np.asarray(want_carry))


@pytest.mark.parametrize("mesh", [(2, 4), (1, 8)])
def test_dataplane_step_matches_jax(mesh):
    jfab = JFabric.auto(mesh, ("dp", "link"))
    payload = np.random.default_rng(14).integers(
        -100, 100, size=(16, 4)).astype(np.float32)
    want_resp, want_csum = jax_full_step(jfab, "dp", "link")(
        jnp.asarray(payload))
    resp, csum = make_full_dataplane_step(_fab(mesh, ("dp", "link")), "dp",
                                          "link")(_t(payload))
    np.testing.assert_array_equal(_np(resp), np.asarray(want_resp))
    np.testing.assert_array_equal(_np(csum), np.asarray(want_csum))


def test_stream_echo_matches_jax():
    jring = JFabric.auto((N,), ("link",))
    chunks = _u32((4, N * 16), seed=15)
    zeros = np.zeros((N,), np.uint32)
    want_tot, want_per = jax_stream_echo(jring, "link", 4)(
        jnp.asarray(chunks), jnp.asarray(zeros))
    tot, per = stream_echo(_fab(), "link", 4)(_t(chunks), _t(zeros))
    np.testing.assert_array_equal(_np(tot), np.asarray(want_tot))
    np.testing.assert_array_equal(_np(per), np.asarray(want_per))


def _handler(i, req):
    return req * (i + 1)  # i: the peer's int32 index; f32 in both


@pytest.mark.parametrize("kind", ["parallel_sum", "parallel_gather",
                                  "partition_concat", "selective"])
def test_combo_channels_match_jax(kind):
    jring, ring = JFabric.auto((N,), ("link",)), _fab()
    req = np.random.default_rng(16).integers(
        -100, 100, size=(N * 2, 3)).astype(np.float32)
    if kind == "selective":
        want = JSelective(jring, "link").call(_handler, jnp.asarray(req), 5)
        got = SelectiveChannel(ring, "link").call(_handler, _t(req), 5)
    else:
        jcls, tcls, merger = {
            "parallel_sum": (JParallel, ParallelChannel, "sum"),
            "parallel_gather": (JParallel, ParallelChannel, "gather"),
            "partition_concat": (JPartition, PartitionChannel, "concat"),
        }[kind]
        want = jcls(jring, "link", response_merger=merger).call(
            _handler, jnp.asarray(req))
        got = tcls(ring, "link", response_merger=merger).call(_handler,
                                                              _t(req))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(causal):
    jring = JFabric.auto((N,), ("link",))
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((2, N * 8, 8)).astype(np.float32)
               for _ in range(3))
    shard = jring.sharding(None, "link", None)
    jout = np.asarray(jax_ring_attn(jring, "link", causal=causal)(
        *(jax.device_put(x, shard) for x in (q, k, v))))
    tq, tk, tv = (_t(x) for x in (q, k, v))
    out = ring_attention(_fab(), "link", causal=causal)(tq, tk, tv)
    ref = attention_reference(causal=causal)(tq, tk, tv)
    np.testing.assert_allclose(_np(out), jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_kernel_matches_pallas_interpret(dtype):
    jring = JFabric.auto((N,), ("link",))
    arr = np.random.default_rng(18).standard_normal((N * 8, 128)).astype(
        np.float32)
    jarr = jnp.asarray(arr, dtype=getattr(jnp, dtype))
    want = np.asarray(ring_all_gather_pallas(jring, "link", interpret=True)(
        jarr).astype(jnp.float32))
    got = ring_all_gather_kernel(_fab(), "link")(
        _t(arr).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(_np(got), want)
