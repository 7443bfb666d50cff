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
        # Several launches are fenced: a bulk unit is a (destination,
        # tile) pair, n of them a tile; one launch keeps (source, tile).
        fan = n if len(plans) > 1 else 1
        assert p.fenced == (len(plans) > 1)
        assert p.units == len(p.sources) * tiles * fan
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
    so where the outputs lie does not change a launch's path, width or
    tile; launches on several cards are fenced, with a CTA for every
    kStages of their (destination, tile) units, up to one per SM."""
    n, size = len(devices), 8 * MIB
    src, out = _addrs(n, size)
    plans = plan_launches(size, devices, src, out, lambda d: 132)
    fenced = len(plans) > 1
    for p in plans:
        want = plan_gather(size, n, [src[j] for j in p.sources] + out, 132,
                           sources=p.sources, device=p.device, fenced=fenced)
        assert p == want
        assert (p.path, p.width, p.tile_bytes, p.fenced) == (
            "bulk", 16, 32768, fenced)
        assert p.grid == (min(132, p.units // 4) if fenced
                          else min(132, p.units))


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


# -- K2's fenced launches: the cross-card plan, co-residence, flags -----------

STAGES = 4  # kStages of csrc/ring_kernel.cu


@pytest.mark.parametrize("cards,mib", [(4, 8), (4, 32), (2, 8), (8, 8)])
def test_cross_card_plan_fills_every_ctas_ring(cards, mib):
    """One peer on each card: every CTA of every launch gets at least
    kStages (destination, tile) units at 8 MiB chunks, and the grid never
    exceeds the units or the card's SMs."""
    n, size = cards, mib * MIB
    src, out = _addrs(n, size)
    plans = plan_launches(size, list(range(cards)), src, out, lambda d: 132)
    assert len(plans) == cards
    for p in plans:
        assert p.fenced and p.path == "bulk"
        assert p.units == n * (size // p.tile_bytes)
        assert 1 <= p.grid <= min(p.units, 132)
        assert p.units // p.grid >= STAGES


def test_cross_card_plan_of_4_x_8_mib():
    src, out = _addrs(4, 8 * MIB)
    plans = plan_launches(8 * MIB, [0, 1, 2, 3], src, out, lambda d: 132)
    assert {(p.width, p.tile_bytes, p.units, p.grid) for p in plans} == {
        (16, 32768, 1024, 132)}


@pytest.mark.parametrize("size,addr_step,width", [
    (30, 30, 2), (12, 12, 4), (64 * 1024 + 1, 64 * 1024 + 1, 1)])
def test_cross_card_plan_keeps_the_ragged_path(size, addr_step, width):
    """Chunks that bulk copies cannot take keep the ragged path across
    cards: (source, tile) units stored to every output, as on one card."""
    src = [(2 * j + 1) * addr_step for j in range(4)]
    out = [4096 * (r + 1) for r in range(4)]
    plans = plan_launches(size, [0, 1, 2, 3], src, out, lambda d: 132)
    for p in plans:
        one = plan_gather(size, 4, [src[j] for j in p.sources] + out, 132,
                          sources=p.sources, device=p.device)
        assert (p.path, p.width, p.fenced) == ("ragged", width, True)
        assert (p.tile_bytes, p.units, p.grid) == (
            one.tile_bytes, one.units, one.grid)
        assert 1 <= p.grid <= p.units


def test_launch_groups_on_one_card_split_its_sms():
    """Fenced launches on streams of one card (one group a stream) share
    its SMs evenly, so that every launch is resident at once."""
    n, size = 2, 8 * MIB
    src, out = _addrs(n, size)
    plans = plan_launches(size, [0, 0], src, out, lambda d: 132,
                          groups=[0, 1])
    assert [(p.sources, p.grid, p.fenced) for p in plans] == [
        ((0,), 66, True), ((1,), 66, True)]
    assert all(p.units == 2 * 256 for p in plans)
    ring_kernel.check_coresident(plans, lambda d: 132, lambda d, w: 1)
    eight = plan_launches(size, [0] * 8, *_addrs(8, size), lambda d: 132,
                          groups=list(range(8)))
    assert [p.grid for p in eight] == [16] * 8
    ring_kernel.check_coresident(eight, lambda d: 132, lambda d, w: 1)


def test_a_group_spanning_devices_raises():
    src, out = _addrs(2, 4096)
    with pytest.raises(ValueError, match="spans devices"):
        plan_launches(4096, [0, 1], src, out, lambda d: 132, groups=[0, 0])


def test_more_launches_than_sms_raise_before_any_launch():
    src, out = _addrs(4, 4096)
    with pytest.raises(RuntimeError, match="cannot all be resident"):
        plan_launches(4096, [0] * 4, src, out, lambda d: 3,
                      groups=[0, 1, 2, 3])


@pytest.mark.parametrize("grids,per_sm,sms,fits", [
    ((66, 66), 1, 132, True),     # the one-card check: two bulk halves
    ((132, 132), 1, 132, False),  # two whole-card grids on one card
    ((67, 66), 1, 132, False),
    ((528, 528), 8, 132, True),   # ragged: 8 CTAs an SM
    ((529, 528), 8, 132, False),
    ((66, 66), 0, 132, False),    # the kernel fits no SM at all
])
def test_coresidence_of_launches_sharing_a_card(grids, per_sm, sms, fits):
    plans = [ring_kernel.GatherPlan(16, 32768, 4096, g, device=0,
                                    sources=(j,), fenced=True)
             for j, g in enumerate(grids)]
    check = lambda: ring_kernel.check_coresident(  # noqa: E731
        plans, lambda d: sms, lambda d, w: per_sm)
    if fits:
        check()
    else:
        with pytest.raises(RuntimeError):
            check()


def test_launches_alone_on_their_cards_need_no_coresidence():
    plans = [ring_kernel.GatherPlan(16, 32768, 4096, 132, device=d,
                                    sources=(d,), fenced=True)
             for d in range(4)]
    ring_kernel.check_coresident(plans, lambda d: 132, lambda d, w: 0)


def test_one_flag_buffer_per_device_set(monkeypatch):
    """Fenced launches keep one zeroed flag block per launch for each set
    of launch devices and streams, allocated once; peer access is enabled
    for a set that spans cards.  Another stream set over the same devices
    (or the same streams in another order) gets blocks of its own, so a
    block is only ever used from its one stream."""
    made, peers = [], []

    def zeroed(d):
        made.append(d)
        return torch.zeros(640, dtype=torch.uint8)

    monkeypatch.setattr(ring_kernel, "_zeroed_flags", zeroed)
    monkeypatch.setattr(ring_kernel, "enable_peers", peers.append)
    cached = ring_kernel.barrier_flags.__wrapped__
    monkeypatch.setattr(ring_kernel, "barrier_flags",
                        __import__("functools").cache(cached))
    cards = ((0, 11), (1, 12), (2, 13), (3, 14))
    four = ring_kernel.barrier_flags(cards)
    assert ring_kernel.barrier_flags(cards) is four
    assert len(four) == 4 and made == [0, 1, 2, 3]
    assert peers == [(0, 1, 2, 3)]
    pair = ring_kernel.barrier_flags(((0, 21), (0, 22)))
    assert len(pair) == 2 and pair[0] is not pair[1]
    assert made == [0, 1, 2, 3, 0, 0] and peers == [(0, 1, 2, 3)]
    assert all(int(f.sum()) == 0 for f in four + pair)
    ring_kernel.barrier_flags(cards[::-1])  # another order: another set
    assert len(made) == 10 and peers[-1] == (0, 1, 2, 3)
    other = ring_kernel.barrier_flags(((0, 31), (1, 32), (2, 33), (3, 34)))
    assert len(made) == 14 and not set(map(id, other)) & set(map(id, four))
    ring_kernel.barrier_flags(((0, 22), (0, 21)))  # the pair swapped
    assert len(made) == 16


@pytest.mark.parametrize("before,launches,want_waits,want_last", [
    # A gather repeated on its streams waits for nothing.
    ({0: ("a",), 1: ("b",)}, [(0, "a"), (1, "b")], [],
     {0: ("a",), 1: ("b",)}),
    # Another stream set over the same cards: each launch waits for the
    # previous gather's launch on its own card.
    ({0: ("a",), 1: ("b",)}, [(0, "c"), (1, "d")], [(0, "a"), (1, "b")],
     {0: ("c",), 1: ("d",)}),
    # Partly shared: only the card whose stream changed waits.
    ({0: ("a",), 1: ("b",)}, [(0, "a"), (1, "d")], [(1, "b")],
     {0: ("a",), 1: ("d",)}),
    # Launches sharing one card: one on a new stream waits for the first
    # launch of the previous gather there; one on a stream of that gather
    # (in any place) follows it on its stream already.
    ({0: ("a", "b")}, [(0, "c"), (0, "d")], [(0, "a"), (1, "a")],
     {0: ("c", "d")}),
    ({0: ("a", "b")}, [(0, "b"), (0, "c")], [(1, "a")], {0: ("b", "c")}),
    ({0: ("a", "b")}, [(0, "b"), (0, "a")], [], {0: ("b", "a")}),
    ({0: ("a", "b")}, [(0, "a"), (0, "b")], [], {0: ("a", "b")}),
    # A card no earlier gather used waits for nothing; others keep theirs.
    ({0: ("a",), 3: ("z",)}, [(1, "b"), (2, "c")], [],
     {0: ("a",), 1: ("b",), 2: ("c",), 3: ("z",)}),
])
def test_fenced_gathers_take_turns_on_each_card(before, launches,
                                                want_waits, want_last):
    """Two fenced gathers over the same cards never compete for a card:
    a launch that does not follow the previous fenced gather there on its
    own stream waits for that gather on its card."""
    last = dict(before)
    assert ring_kernel.fenced_turns(last, launches) == want_waits
    assert last == want_last


def test_fenced_gather_rejects_cpu_chunks():
    chunks = [torch.zeros(2, 4) for _ in range(2)]
    with pytest.raises(RuntimeError, match="cuda tensors only"):
        ring_kernel.ring_all_gather_fenced(chunks, [None, None])


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
