"""Port parity: the ring all-gather (K2).  On the CPU the wrapper runs the
kernel's plain schedule, which is held bit-exact against the reference's
Pallas kernel under the TPU interpreter (as tests/test_kernels.py runs it)
and against the collective reference.  The CUDA kernel itself runs only on
a card: chip_smoke.py holds it against the plain schedule there, every
peer's copy, bit-exact."""

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
                                            stripes_for)
from brpc_tpu_torch.parallel import Fabric

TIMEOUT_S = 60


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


@pytest.mark.parametrize("chunk_bytes,n,ctas,want", [
    (8 << 20, 8, 1056, 64),   # the smoke's full width: 64 stripes of 128 KiB
    (4096, 8, 1056, 64),      # the dryrun's 8 x 128 f32 chunk
    (48, 2, 1056, 3),         # three vectors: three stripes of one
    (16, 4, 1056, 1),
    (8 << 20, 8, 200, 16),    # 25 CTAs a peer; 16 divides the vectors
])
def test_stripes_split_chunks_into_whole_vectors(chunk_bytes, n, ctas, want):
    s = stripes_for(chunk_bytes, n, ctas)
    assert s == want
    assert chunk_bytes % (16 * s) == 0 and n * s <= ctas


def test_stripes_reject_partial_vectors_and_oversized_grids():
    with pytest.raises(ValueError, match="16-byte vectors"):
        stripes_for(30, 2, 1056)  # e.g. a (3, 5) bf16 chunk
    with pytest.raises(RuntimeError, match="co-resident"):
        stripes_for(4096, 8, 4)
