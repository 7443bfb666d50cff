"""Port parity: the combo channels and balancers of brpc_tpu_torch against
brpc_tpu — the cases of tests/test_channels.py (and the channel sweeps of
tests/test_shapes_sweep.py), each run through both packages on the same
numpy-seeded requests, plus the balancers' picks for the same seeds.
Handlers see only their shard on both sides (shard_map there, one thread
per peer here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.channels import ConsistentHash as JConsistentHash
from brpc_tpu.channels import DynamicPartitionChannel as JDynamic
from brpc_tpu.channels import ParallelChannel as JParallel
from brpc_tpu.channels import PartitionChannel as JPartition
from brpc_tpu.channels import RandomBalancer as JRandom
from brpc_tpu.channels import RoundRobin as JRoundRobin
from brpc_tpu.channels import SelectiveChannel as JSelective
from brpc_tpu.channels import WeightedRandom as JWeighted
from brpc_tpu.channels.balancer import EwmaP2C as JEwmaP2C
from brpc_tpu.parallel.fabric import Fabric as JFabric
from brpc_tpu_torch import tensor_from_numpy
from brpc_tpu_torch.channels import (ConsistentHash, DynamicPartitionChannel,
                                     EwmaP2C, ParallelChannel,
                                     PartitionChannel, RandomBalancer,
                                     RoundRobin, SelectiveChannel,
                                     WeightedRandom)
from brpc_tpu_torch.parallel import Fabric
from brpc_tpu_torch.parallel import collectives as coll

N = 8
TIMEOUT_S = 60


@pytest.fixture(scope="module")
def fabrics():
    return (JFabric.auto((N,), ("link",)),
            Fabric.auto((N,), ("link",), devices="cpu", timeout_s=TIMEOUT_S))


def _np(t):
    if isinstance(t, (tuple, list)):
        return [_np(x) for x in t]
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _t(arr):
    return tensor_from_numpy(arr, "cpu")


def _req(shape, seed=0):
    return np.random.default_rng(seed).integers(
        -100, 100, size=shape).astype(np.float32)


@pytest.mark.parametrize("merger", ["gather", "concat", "sum", "max", "min",
                                    "none"])
def test_parallel_channel_mergers_match_jax(fabrics, merger):
    jfab, fab = fabrics
    req = _req((4,))
    want = JParallel(jfab, "link", response_merger=merger).call(
        lambda i, r: r * (i.astype(r.dtype) - 3.0), jnp.asarray(req))
    got = ParallelChannel(fab, "link", response_merger=merger).call(
        lambda i, r: r * (i.to(r.dtype) - 3.0), _t(req))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_parallel_channel_gather(fabrics):
    _, fab = fabrics
    ch = ParallelChannel(fab, "link", response_merger="gather")
    out = ch.call(lambda i, req: req + i.to(req.dtype), torch.zeros(4))
    assert out.shape == (8, 4)
    np.testing.assert_array_equal(out[:, 0].numpy(), np.arange(8))


def test_parallel_channel_sum_merger(fabrics):
    _, fab = fabrics
    ch = ParallelChannel(fab, "link", response_merger="sum")
    out = ch.call(lambda i, req: req * 0 + 1.0, torch.zeros(3))
    np.testing.assert_array_equal(out.numpy(), np.full((3,), 8.0))


def test_parallel_channel_call_mapper_matches_jax(fabrics):
    jfab, fab = fabrics
    reqs = _req((8,), seed=1)
    want = JParallel(jfab, "link", call_mapper=lambda i, r: r[i],
                     response_merger="gather").call(lambda i, s: s * 2,
                                                    jnp.asarray(reqs))
    got = ParallelChannel(fab, "link", call_mapper=lambda i, r: r[i],
                          response_merger="gather").call(lambda i, s: s * 2,
                                                         _t(reqs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), reqs * 2)


def test_parallel_channel_callable_merger_matches_jax(fabrics):
    jfab, fab = fabrics
    from jax import lax
    from jax.sharding import PartitionSpec as JP

    from brpc_tpu_torch.parallel import P

    req = _req((16,), seed=2)
    want = JParallel(jfab, "link",
                     response_merger=lambda r, a: lax.psum_scatter(
                         r, a, tiled=True), out_spec=JP("link")).call(
        lambda i, r: r + i.astype(r.dtype), jnp.asarray(req))
    got = ParallelChannel(fab, "link",
                          response_merger=lambda r, a: coll.psum_scatter(
                              r, a, tiled=True), out_spec=P("link")).call(
        lambda i, r: r + i.to(r.dtype), _t(req))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("merger", ["concat", "none", "sum"])
def test_partition_channel_matches_jax(fabrics, merger):
    jfab, fab = fabrics
    req = _req((16, 1), seed=3)
    want = JPartition(jfab, "link", response_merger=merger).call(
        lambda i, part: part + 100.0 * i.astype(part.dtype),
        jnp.asarray(req))
    got = PartitionChannel(fab, "link", response_merger=merger).call(
        lambda i, part: part + 100.0 * i.to(part.dtype), _t(req))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_partition_channel(fabrics):
    _, fab = fabrics
    req = torch.arange(16.0).reshape(16, 1)
    out = PartitionChannel(fab, "link", response_merger="concat").call(
        lambda i, part: part + 100.0, req)
    np.testing.assert_array_equal(out.numpy(), req.numpy() + 100.0)


def test_partition_non_divisible_rows_rejected(fabrics):
    _, fab = fabrics
    ch = PartitionChannel(fab, "link")
    with pytest.raises(ValueError, match="split evenly"):
        ch.call(lambda i, shard: shard + 1, torch.ones(10, 64))


def test_selective_channel_matches_jax(fabrics):
    jfab, fab = fabrics
    jbound = JSelective(jfab, "link").bind(
        lambda i, req: req + i.astype(req.dtype))
    bound = SelectiveChannel(fab, "link").bind(
        lambda i, req: req + i.to(req.dtype))
    req = _req((2,), seed=4)
    for chosen in (0, 3, 7):
        got = bound(_t(req), chosen)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jbound(jnp.asarray(req), chosen)))
        np.testing.assert_array_equal(got.numpy(), req + chosen)


def test_selective_channel_pytree_response(fabrics):
    jfab, fab = fabrics
    ch = SelectiveChannel(fab, "link")

    def handler(i, req):
        return req + i.to(req.dtype), torch.sum(req)

    bound = ch.bind(handler)
    resp, s = bound(torch.ones(2), 5)
    np.testing.assert_array_equal(resp.numpy(), np.full((2,), 6.0))
    # Each peer sums only its own request, as under shard_map.
    assert float(s) == 2.0
    jresp, js = JSelective(jfab, "link").bind(
        lambda i, req: (req + i.astype(req.dtype), jnp.sum(req)))(
        jnp.ones((2,), jnp.float32), 5)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(jresp))
    assert float(s) == float(js)
    assert ch.bind(handler) is bound  # the bound program is reused


def test_selective_channel_where_select_survives_nan(fabrics):
    """A non-chosen peer answering inf/nan must not poison the reply."""
    _, fab = fabrics

    def handler(i, req):
        bad = torch.full_like(req, float("nan"))
        return torch.where(i == 2, req + 1.0, bad)

    out = SelectiveChannel(fab, "link").call(handler, torch.zeros(3), 2)
    np.testing.assert_array_equal(out.numpy(), np.ones(3))


def test_bound_cache_is_bounded(fabrics):
    _, fab = fabrics
    ch = ParallelChannel(fab, "link")
    handlers = [lambda i, r, k=k: r + k for k in range(70)]
    for h in handlers:
        ch.bind(h)
    assert len(ch._bound._cache) <= ch._bound.kMax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
@pytest.mark.parametrize("cols", [1, 128, 4096])
def test_parallel_sum_sweep_matches_jax(fabrics, dtype, cols):
    jfab, fab = fabrics
    zeros = np.zeros((cols,), np.float32)
    jreq = jnp.asarray(zeros, dtype=getattr(jnp, dtype))
    want = JParallel(jfab, "link", response_merger="sum").call(
        lambda i, r: r + jnp.ones_like(r), jreq)
    got = ParallelChannel(fab, "link", response_merger="sum").call(
        lambda i, r: r + torch.ones_like(r), _t(np.asarray(jreq)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32)
                                  if dtype == "bfloat16" else np.asarray(want))


@pytest.mark.parametrize("rows,cols", [(8, 4096), (24, 1024), (16, 131072)])
def test_partition_identity_sweep_matches_jax(fabrics, rows, cols):
    jfab, fab = fabrics
    base = (np.arange(rows * cols) % 251).reshape(rows, cols).astype(
        np.int32)
    want = JPartition(jfab, "link").call(lambda i, s: s * 2,
                                         jnp.asarray(base))
    got = PartitionChannel(fab, "link").call(lambda i, s: s * 2, _t(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_parallel_gather_large_mixed_dtype(fabrics, dtype):
    _, fab = fabrics
    cols = 262144
    out = ParallelChannel(fab, "link", response_merger="gather").call(
        lambda i, r: r + i.to(r.dtype),
        torch.zeros(cols, dtype=getattr(torch, dtype))).float().numpy()
    assert out.shape == (N, cols)
    np.testing.assert_array_equal(out[:, 0], np.arange(N))
    np.testing.assert_array_equal(out[:, -1], np.arange(N))


def test_dynamic_partition_channel_matches_jax():
    jdyn = JDynamic([
        JPartition(JFabric.auto((4,), ("link",), devices=jax.devices()[:4]),
                   "link"),
        JPartition(JFabric.auto((8,), ("link",)), "link")])
    dyn = DynamicPartitionChannel([
        PartitionChannel(Fabric.auto((n,), ("link",), devices="cpu",
                                     timeout_s=TIMEOUT_S), "link")
        for n in (4, 8)])
    x = _req((8, 4), seed=5)
    for _ in range(12):  # one full weight cycle (4 + 8)
        js, jout = jdyn.call(lambda i, s: s * 2.0, jnp.asarray(x))
        ts, tout = dyn.call(lambda i, s: s * 2.0, _t(x))
        assert ts == js
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert dyn.counts == jdyn.counts == (4, 8)
    dyn.set_weights([0, 1])
    for _ in range(5):
        assert dyn.call(lambda i, s: s * 2.0, _t(x))[0] == 1
    with pytest.raises(ValueError):
        dyn.set_weights([0, 0])
    with pytest.raises(ValueError):
        DynamicPartitionChannel([])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_balancer_picks_match_reference(seed):
    def picks(b, k=200, key=False):
        return [b.pick(f"key{i}") if key else b.pick() for i in range(k)]

    assert picks(RoundRobin(5)) == picks(JRoundRobin(5))
    assert picks(RandomBalancer(6, seed=seed)) == \
        picks(JRandom(6, seed=seed))
    w = [0.5, 0, 2.0, 1.0]
    assert picks(WeightedRandom(w, seed=seed)) == \
        picks(JWeighted(w, seed=seed))
    assert picks(ConsistentHash(8), key=True) == \
        picks(JConsistentHash(8), key=True)
    ours, theirs = EwmaP2C(4, seed=seed), JEwmaP2C(4, seed=seed)
    for b in (ours, theirs):
        for peer, lat in ((0, 10.0), (1, 3.0), (2, 10.0)):
            b.feedback(peer, lat)
    assert picks(ours) == picks(theirs)
    assert ours.lat == theirs.lat


def test_balancers():
    rr = RoundRobin(4)
    assert [rr.pick() for _ in range(6)] == [0, 1, 2, 3, 0, 1]
    rb = RandomBalancer(4, seed=1)
    assert all(0 <= rb.pick() < 4 for _ in range(50))
    wr = WeightedRandom([0, 0, 1.0], seed=1)
    assert all(wr.pick() == 2 for _ in range(20))
    ch = ConsistentHash(8)
    picks = [ch.pick(f"key{i}") for i in range(100)]
    assert all(0 <= p < 8 for p in picks)
    assert ch.pick("stable") == ch.pick("stable")
    assert len(set(picks)) > 4
    p2c = EwmaP2C(4, seed=2)
    for peer in (0, 1, 2):
        p2c.feedback(peer, 10.0)
    assert [p2c.pick() for _ in range(100)].count(3) > 25
