"""Port parity: the torch Fabric's collectives against `jax.lax` inside the
reference `Fabric.spmd`, on the conftest's 8-device CPU mesh and on 8
logical CPU peers, on the same numpy-seeded inputs.  Data movement and
integer results are bit-exact; float reductions use integer-valued floats,
so they are exact too.  Every spmd call runs under the fabric's rendezvous
timeout, so a broken peer fails the test instead of hanging it."""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax import lax

from brpc_tpu.parallel.fabric import Fabric as JFabric
from brpc_tpu.parallel.fabric import P as JP
from brpc_tpu_torch import tensor_from_numpy
from brpc_tpu_torch.parallel import Fabric, P
from brpc_tpu_torch.parallel import collectives as coll

TIMEOUT_S = 60

MESHES = {"ring8": ((8,), ("link",)), "dp2xlink4": ((2, 4), ("dp", "link"))}
# (mesh, axis) cases: every axis of each mesh.
AXES = [("ring8", "link"), ("dp2xlink4", "link"), ("dp2xlink4", "dp")]


def _fabrics(mesh):
    shape, names = MESHES[mesh]
    return (JFabric.auto(shape, names),
            Fabric.auto(shape, names, devices="cpu", timeout_s=TIMEOUT_S))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _data(dtype: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "uint32":
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    ints = rng.integers(-1000, 1000, size=shape)
    return ints.astype(np.int32 if dtype == "int32" else np.float32)


def _group(mesh, axis) -> int:
    shape, names = MESHES[mesh]
    return dict(zip(names, shape))[axis]


def _both(mesh, jax_body, torch_body, arr):
    """Runs each body once per peer over `arr` split along dim 0 over every
    mesh axis, and returns (jax result, port result) as numpy."""
    jfab, tfab = _fabrics(mesh)
    every = MESHES[mesh][1]
    jfn = jax.jit(jfab.spmd(jax_body, in_specs=JP(every), out_specs=JP(every)))
    tfn = tfab.spmd(torch_body, in_specs=P(every), out_specs=P(every))
    want = np.asarray(jfn(jax.numpy.asarray(arr)))
    got = _np(tfn(tensor_from_numpy(arr, "cpu")))
    return want, got


def _shift_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


@pytest.mark.parametrize("mesh,axis", AXES)
def test_axis_index_matches_lax(mesh, axis):
    arr = np.zeros((8, 1), np.int32)
    want, got = _both(mesh, lambda x: lax.axis_index(axis)[None, None] + x,
                      lambda x: coll.axis_index(axis)[None, None] + x, arr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint32"])
@pytest.mark.parametrize("mesh,axis", AXES)
def test_ppermute_matches_lax(mesh, axis, dtype):
    n = _group(mesh, axis)
    # A partial permutation: peer 0 receives nothing and gets zeros.
    perm = [(i, i + 1) for i in range(n - 1)]
    arr = _data(dtype, (8 * 4, 3))
    for p in (_shift_perm(n), perm):
        want, got = _both(mesh, lambda x, p=p: lax.ppermute(x, axis, p),
                          lambda x, p=p: coll.ppermute(x, axis, p), arr)
        np.testing.assert_array_equal(got, want)


REDUCTIONS = {
    "psum": (lax.psum, coll.psum),
    "pmax": (lax.pmax, coll.pmax),
    "pmin": (lax.pmin, coll.pmin),
}


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint32"])
@pytest.mark.parametrize("op", sorted(REDUCTIONS))
@pytest.mark.parametrize("mesh,axis", AXES)
def test_reductions_match_lax(mesh, axis, op, dtype):
    jop, top = REDUCTIONS[op]
    arr = _data(dtype, (8 * 4, 5), seed=1)
    want, got = _both(mesh, lambda x: jop(x, axis), lambda x: top(x, axis),
                      arr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gather_axis", [0, 1])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", ["int32", "float32", "uint32"])
@pytest.mark.parametrize("mesh,axis", AXES)
def test_all_gather_matches_lax(mesh, axis, dtype, tiled, gather_axis):
    arr = _data(dtype, (8 * 2, 3), seed=2)

    def jbody(x):
        return lax.all_gather(x, axis, axis=gather_axis,
                              tiled=tiled).reshape(-1, 3)

    def tbody(x):
        return coll.all_gather(x, axis, axis=gather_axis,
                               tiled=tiled).reshape(-1, 3)

    want, got = _both(mesh, jbody, tbody, arr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("mesh,axis", AXES)
def test_psum_scatter_matches_lax(mesh, axis, dtype, tiled):
    n = _group(mesh, axis)
    arr = _data(dtype, (8 * 8, 3), seed=3)

    def jbody(x):
        x = x if tiled else x.reshape(n, -1)
        return lax.psum_scatter(x, axis, tiled=tiled).reshape(-1, 3)

    def tbody(x):
        x = x if tiled else x.reshape(n, -1)
        return coll.psum_scatter(x, axis, tiled=tiled).reshape(-1, 3)

    want, got = _both(mesh, jbody, tbody, arr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint32"])
@pytest.mark.parametrize("mesh,axis", AXES)
def test_all_to_all_tiled_matches_lax(mesh, axis, dtype):
    arr = _data(dtype, (8 * 8, 3), seed=4)
    want, got = _both(
        mesh, lambda x: lax.all_to_all(x, axis, 0, 0, tiled=True),
        lambda x: coll.all_to_all(x, axis, 0, 0, tiled=True), arr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh,axis", AXES)
def test_all_to_all_untiled_matches_lax(mesh, axis):
    n = _group(mesh, axis)
    arr = _data("int32", (8 * 8, 6), seed=5)

    def jbody(x):
        return lax.all_to_all(x.reshape(n, -1), axis, 0, 1).reshape(8, 6)

    def tbody(x):
        return coll.all_to_all(x.reshape(n, -1), axis, 0, 1).reshape(8, 6)

    want, got = _both(mesh, jbody, tbody, arr)
    np.testing.assert_array_equal(got, want)


def test_replicated_output_is_peer_zeros_value():
    fab = Fabric.auto((2, 4), ("dp", "link"), devices="cpu",
                      timeout_s=TIMEOUT_S)
    out = fab.spmd(lambda x: x + coll.axis_index(("dp", "link")),
                   in_specs=P(), out_specs=P())(torch.zeros(3,
                                                            dtype=torch.int32))
    assert out.tolist() == [0, 0, 0]


def test_specs_split_and_assemble():
    fab = Fabric.auto((2, 4), ("dp", "link"), devices="cpu",
                      timeout_s=TIMEOUT_S)
    x = torch.arange(8 * 6).reshape(8, 6)
    # Rows over link, columns over dp; the output returns as it came.
    out = fab.spmd(lambda s: s.clone(), in_specs=P("link", "dp"),
                   out_specs=P("link", "dp"))(x)
    assert torch.equal(out, x)
    shards = [fab.shard(x, P("link", "dp"), r) for r in range(8)]
    assert all(s.shape == (2, 3) for s in shards)
    assert torch.equal(shards[fab.rank_of((1, 2))], x[4:6, 3:6])
    with pytest.raises(ValueError, match="does not split evenly"):
        fab.put(torch.zeros(10, 2), "link")


def test_fabric_topology_and_construction_errors():
    fab = Fabric.auto((2, 4), ("dp", "link"), devices="cpu")
    assert fab.axis_names == ("dp", "link") and fab.size == 8
    assert fab.axis_size("link") == 4 and fab.axis_size("dp") == 2
    assert fab.group(5, "link") == [4, 5, 6, 7]
    assert fab.group(5, "dp") == [1, 5]
    ring = Fabric.auto(axis_names=("link",), devices=["cpu"] * 3)
    assert ring.shape == {"link": 3}
    with pytest.raises(ValueError, match="device count"):
        Fabric.auto((2, 2), ("dp", "link"), devices=["cpu"] * 3)
    # Peers may lie on several devices of one type, never on a mix of
    # types (a CPU peer beside a card's).
    with pytest.raises(ValueError, match="one type"):
        Fabric.auto((2,), ("link",), devices=["cpu", "meta"])
    assert fab.sharding(None, "link").spec == P(None, "link")
    assert fab.replicated().spec == P()


def test_collective_outside_spmd_raises():
    with pytest.raises(RuntimeError, match="only inside"):
        coll.psum(torch.zeros(1), "link")


def test_spmd_does_not_nest():
    fab = Fabric.auto((2,), ("link",), devices="cpu", timeout_s=TIMEOUT_S)
    inner = fab.spmd(lambda x: x, in_specs=P(), out_specs=P())
    with pytest.raises(RuntimeError, match="does not nest"):
        fab.spmd(lambda x: inner(x), in_specs=P(), out_specs=P())(
            torch.zeros(1))


def test_raising_peer_fails_spmd_without_hang():
    fab = Fabric.auto((8,), ("link",), devices="cpu", timeout_s=TIMEOUT_S)

    def body(x):
        if int(coll.axis_index("link")) == 5:
            raise KeyError("peer 5 failed")
        return coll.psum(x, "link")

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="peer 5 failed"):
        fab.spmd(body, in_specs=P("link"), out_specs=P())(torch.zeros(8))
    # The other peers left their rendezvous at once (aborted barrier).
    assert time.monotonic() - t0 < TIMEOUT_S / 2
    for t in threading.enumerate():
        if t.name.startswith("peer-"):
            t.join(10)
            assert not t.is_alive(), t.name


def test_peer_that_skips_a_collective_times_out():
    fab = Fabric.auto((4,), ("link",), devices="cpu", timeout_s=1.0)

    def body(x):
        if int(coll.axis_index("link")) == 0:
            return x
        return coll.psum(x, "link")

    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        fab.spmd(body, in_specs=P("link"), out_specs=P("link"))(
            torch.zeros(4))
    assert time.monotonic() - t0 < 10


def test_many_peers_stress_rendezvous():
    """More peers than cores, a short switch interval, and many rounds: a
    lost or reordered deposit would break the exact integer sums."""
    n, rounds = 16, 50
    fab = Fabric.auto((n,), ("link",), devices="cpu", timeout_s=TIMEOUT_S)

    def body(x):
        acc = x.clone()
        for k in range(rounds):
            acc = coll.psum(acc + k, "link") % 1000003
            acc = coll.ppermute(acc, "link", _shift_perm(n))
        return acc

    x = torch.arange(n, dtype=torch.int64)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = fab.spmd(body, in_specs=P("link"), out_specs=P("link"))(x)
    finally:
        sys.setswitchinterval(old)
    want = x.clone()
    for k in range(rounds):
        total = int((want + k).sum()) % 1000003
        want = torch.full_like(want, total)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mesh,axis", AXES)
def test_check_vma_false_runs_in_both_packages(mesh, axis):
    """The reference's `spmd(..., check_vma=False)` keyword is accepted by
    the port, and both give the same psum."""
    arr = _data("int32", (8, 3), seed=3)
    jfab, tfab = _fabrics(mesh)
    every = MESHES[mesh][1]
    jfn = jax.jit(jfab.spmd(lambda x: lax.psum(x, axis), JP(every),
                            JP(every), check_vma=False))
    tfn = tfab.spmd(lambda x: coll.psum(x, axis), P(every), P(every),
                    check_vma=False)
    want = np.asarray(jfn(jax.numpy.asarray(arr)))
    got = _np(tfn(tensor_from_numpy(arr, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("check_vma", [False, True])
def test_check_vma_true_passes_a_true_replica(check_vma):
    """A psum over every axis is the same on every peer: P() holds it
    under either setting, and the value is the global sum."""
    fab = Fabric.auto((2, 4), ("dp", "link"), devices="cpu",
                      timeout_s=TIMEOUT_S)
    x = torch.arange(8 * 2, dtype=torch.int32).reshape(8, 2)
    got = fab.spmd(lambda v: coll.psum(v, ("dp", "link")),
                   P(("dp", "link")), P(), check_vma=check_vma)(x)
    assert torch.equal(got, x.reshape(8, 1, 2).sum(0, dtype=torch.int32))


@pytest.mark.parametrize("out_spec,varies_on", [
    (P(), "link"), (P(), "dp"), (P("dp"), "link"),
    ((P("link"), P()), "dp")])
def test_check_vma_true_raises_on_a_replica_that_differs(out_spec,
                                                         varies_on):
    """An output declared replicated along an axis whose peers disagree
    raises under check_vma=True and is peer 0's row under False."""
    fab = Fabric.auto((2, 4), ("dp", "link"), devices="cpu",
                      timeout_s=TIMEOUT_S)

    def body(v):
        out = v + coll.axis_index(varies_on).to(v.dtype)
        return (v, out) if isinstance(out_spec, tuple) else out

    x = torch.zeros(8, 2, dtype=torch.int32)
    in_spec = P(("dp", "link"))
    with pytest.raises(ValueError, match="check_vma"):
        fab.spmd(body, in_spec, out_spec, check_vma=True)(x)
    fab.spmd(body, in_spec, out_spec, check_vma=False)(x)
