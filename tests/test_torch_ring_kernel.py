"""Port parity: the ring all-gather (K2).  On the CPU the wrapper runs its
plain version (the reference kernel's hop schedule), which is held
bit-exact against the reference's Pallas kernel under the TPU interpreter
(as tests/test_kernels.py runs it) and against the collective reference,
on chunks of any size.  The launch plan (path, width, tile, grid) is plain
Python and is tested here.  The CUDA kernel itself runs only on a card:
chip_smoke.py holds it against the plain version there, every peer's copy,
bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops.ring_kernel import ring_all_gather_pallas
from brpc_tpu.ops.ring_kernel import \
    ring_all_gather_reference as jax_ring_reference
from brpc_tpu.parallel.fabric import Fabric as JFabric
from brpc_tpu_torch import tensor_from_numpy
from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.ops.ring_kernel import (WRAPPER, ring_all_gather,
                                            ring_all_gather_kernel,
                                            ring_all_gather_plain,
                                            ring_all_gather_reference,
                                            plan_gather)
from brpc_tpu_torch.parallel import Fabric

TIMEOUT_S = 60
MIB = 1 << 20


def _ring(n):
    return Fabric.auto((n,), ("link",), devices="cpu", timeout_s=TIMEOUT_S)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes, so NaN payloads compare bit for bit."""
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_schedule_matches_pallas_interpret(n):
    jfab = JFabric.auto((n,), ("link",), devices=jax.devices()[:n])
    rows, cols = 8 * n, 128
    arr = np.random.default_rng(n).standard_normal((rows, cols)).astype(
        np.float32)
    want = np.asarray(ring_all_gather_pallas(jfab, "link", interpret=True)(
        jnp.asarray(arr)))
    got = ring_all_gather_kernel(_ring(n), "link")(tensor_from_numpy(
        arr, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ring_all_gather_reference(_ring(n), "link")(
            tensor_from_numpy(arr, "cpu")).numpy(),
        np.asarray(jax_ring_reference(jfab, "link")(jnp.asarray(arr))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint32"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_every_peer_gets_every_chunk(n, dtype):
    rng = np.random.default_rng(10 + n)
    raw = rng.integers(0, 1 << 32, size=(n, 4, 8), dtype=np.uint32)
    if dtype == "bfloat16":  # random bits, NaN patterns included
        chunks = [torch.from_numpy(c.view(np.int16)).view(torch.bfloat16)
                  for c in raw]
    else:
        chunks = [torch.from_numpy(c.view(np.int32)).view(
            getattr(torch, dtype)) for c in raw]
    outs = ring_all_gather(chunks)
    whole = np.concatenate([_bits(c).reshape(4, -1) for c in chunks])
    assert len(outs) == n
    for out in outs:
        assert out.dtype == chunks[0].dtype and out.shape[0] == 4 * n
        np.testing.assert_array_equal(_bits(out).reshape(4 * n, -1), whole)
    assert len({o.data_ptr() for o in outs}) == n  # each peer its own copy


def test_plain_schedule_is_the_wrappers_cpu_path():
    chunks = [torch.full((2, 4), float(i)) for i in range(4)]
    before = _kernels.launches[WRAPPER]
    outs = ring_all_gather(chunks)
    assert _kernels.launches[WRAPPER] == before  # no kernel on the CPU
    for a, b in zip(outs, ring_all_gather_plain(chunks)):
        assert torch.equal(a, b)


def test_ring_gather_rejects_one_peer_and_2d_mesh():
    with pytest.raises(RuntimeError, match="at least 2"):
        ring_all_gather_kernel(_ring(1), "link")
    mesh = Fabric.auto((2, 4), ("dp", "link"), devices="cpu")
    with pytest.raises(RuntimeError, match="1-D mesh"):
        ring_all_gather_kernel(mesh, "link")
    with pytest.raises(RuntimeError, match="at least 2"):
        ring_all_gather([torch.zeros(2, 2)])


def test_wrapper_checks_its_inputs():
    with pytest.raises(ValueError, match="one shape"):
        ring_all_gather([torch.zeros(2, 2), torch.zeros(3, 2)])
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        ring_all_gather([torch.empty(2, 4, device="meta")] * 2)


@pytest.mark.parametrize("chunk_bytes,n,addrs,sms,want", [
    # the smoke's full width: 8 MiB f32 chunks, bulk path, one CTA per SM
    (8 << 20, 8, [k << 23 for k in range(16)], 132, (16, 32768, 2048, 132)),
    # the dryrun's 8 x 128 f32 chunk: one tile a source
    (4096, 8, [k * 4096 for k in range(16)], 132, (16, 4096, 8, 8)),
    # a (3, 5) bf16 chunk narrowed out of its global: 2-byte copies
    (30, 2, [0, 30, 512, 1024], 132, (2, 30, 2, 2)),
    # a (3, 1) f32 chunk: 4-byte copies
    (12, 4, [12 * k for k in range(4)] + [512 * k for k in range(4)],
     132, (4, 12, 4, 4)),
    # a 16-byte chunk at an odd byte offset: 1-byte copies
    (16, 2, [1, 17, 512, 1024], 132, (1, 16, 2, 2)),
    # 8-byte aligned pointers to a chunk of 16-byte multiples
    (48, 3, [8, 56, 104, 512, 1024, 1536], 132, (8, 48, 3, 3)),
    # a large ragged chunk: 16 KiB units, 8 CTAs on each of 16 SMs
    (3 * MIB + 2, 4, [0, 3 * MIB + 2, 6 * MIB + 4, 9 * MIB + 6],
     16, (2, 16384, 4 * 193, 8 * 16)),
])
def test_plan_chooses_width_tile_and_grid(chunk_bytes, n, addrs, sms, want):
    plan = plan_gather(chunk_bytes, n, addrs, sms)
    assert (plan.width, plan.tile_bytes, plan.units, plan.grid) == want
    assert chunk_bytes % plan.width == 0 and plan.tile_bytes % plan.width == 0
    assert all(a % plan.width == 0 for a in addrs)
    assert 1 <= plan.grid <= plan.units


@pytest.mark.parametrize("chunk_bytes", [16, 30, 4096, 8 << 20, 3 * MIB + 2])
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_grid_never_exceeds_the_units(chunk_bytes, sms):
    for n in (2, 8, 64):
        plan = plan_gather(chunk_bytes, n, [0], sms)
        assert plan.units == n * -(-chunk_bytes // plan.tile_bytes)
        assert 1 <= plan.grid <= min(plan.units, 8 * sms)


@pytest.mark.parametrize("chunk_bytes", [4096, 8 << 20, 32 << 20])
@pytest.mark.parametrize("n,sms", [(2, 132), (4, 132), (8, 132), (2, 66)])
def test_fenced_bulk_plan_has_a_unit_per_destination(chunk_bytes, n, sms):
    """A fenced bulk launch of one source stores each tile to one output a
    unit: n units a tile, a CTA for at least kStages of them where there
    are enough (one CTA at the least), never more CTAs than SMs."""
    plan = plan_gather(chunk_bytes, n, [0], sms, sources=(0,), fenced=True)
    tiles = -(-chunk_bytes // plan.tile_bytes)
    assert (plan.path, plan.fenced) == ("bulk", True)
    assert plan.units == n * tiles
    assert 1 <= plan.grid <= min(plan.units, sms)
    if plan.units >= 4 * sms:
        assert plan.grid == sms
    assert plan.grid == 1 or plan.units // plan.grid >= 4


@pytest.mark.parametrize("chunk_bytes,addrs", [
    (30, [2, 32]), (3 * MIB + 2, [0, 3 * MIB + 2]), (16, [1, 17])])
def test_fenced_ragged_plan_is_the_ragged_plan(chunk_bytes, addrs):
    one = plan_gather(chunk_bytes, 2, addrs, 132, sources=(0,))
    fenced = plan_gather(chunk_bytes, 2, addrs, 132, sources=(0,),
                         fenced=True)
    assert fenced.path == "ragged" and fenced.fenced
    assert (fenced.width, fenced.tile_bytes, fenced.units, fenced.grid) == (
        one.width, one.tile_bytes, one.units, one.grid)


def test_plan_rejects_more_than_64_peers():
    with pytest.raises(RuntimeError, match="2 to 64 peers"):
        plan_gather(4096, 65, [0], 132)
    with pytest.raises(RuntimeError, match="2 to 64 peers"):
        plan_gather(4096, 1, [0], 132)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [2, 3])
def test_chunks_of_any_size_match_pallas_interpret(n, dtype):
    """(3, 5) chunks (30 bytes in bf16, 60 in f32: no whole number of
    16-byte vectors, narrowed at offsets that are not 16-byte aligned) go
    through the port as through the reference's Pallas kernel."""
    jfab = JFabric.auto((n,), ("link",), devices=jax.devices()[:n])
    arr = np.random.default_rng(20 + n).standard_normal((3 * n, 5)).astype(
        np.float32)
    jarr = jnp.asarray(arr, dtype=getattr(jnp, dtype))
    want = np.asarray(ring_all_gather_pallas(jfab, "link", interpret=True)(
        jarr).astype(jnp.float32))
    global_ = tensor_from_numpy(arr, "cpu").to(getattr(torch, dtype))
    got = ring_all_gather_kernel(_ring(n), "link")(global_)
    assert got.dtype == global_.dtype and got.shape == (3 * n, 5)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(_bits(got), _bits(global_))
    np.testing.assert_array_equal(
        _bits(ring_all_gather_reference(_ring(n), "link")(global_)),
        _bits(got))
    np.testing.assert_array_equal(
        np.asarray(jax_ring_reference(jfab, "link")(jarr).astype(
            jnp.float32)), want)
    chunk_bytes = 3 * 5 * global_.element_size()
    plan = plan_gather(chunk_bytes, n,
                       [global_.data_ptr() + r * chunk_bytes
                        for r in range(n)], 132)
    assert plan.width == (2 if dtype == "bfloat16" else 4)
