"""Port parity: ring attention of brpc_tpu_torch against the reference's
ring attention on the 8-device CPU mesh, and each against its own
full-softmax oracle, on the same numpy-seeded q/k/v — with the reference's
tolerances (tests/test_ring_attention.py): f32 2e-5, bf16 2e-2, the long
sweep 1e-4, and the causal future-independence check."""

import jax
import numpy as np
import pytest
import torch

from brpc_tpu.models.ring_attention import \
    attention_reference as jax_attention_reference
from brpc_tpu.models.ring_attention import ring_attention as jax_ring
from brpc_tpu.parallel.fabric import Fabric as JFabric
from brpc_tpu_torch import tensor_from_numpy
from brpc_tpu_torch.models.ring_attention import (attention_reference,
                                                  ring_attention)
from brpc_tpu_torch.parallel import Fabric

TIMEOUT_S = 60


@pytest.fixture(scope="module")
def fabrics():
    return (JFabric.auto((8,), ("link",)),
            Fabric.auto((8,), ("link",), devices="cpu", timeout_s=TIMEOUT_S))


def _qkv(shape, seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32).astype(
        dtype) for _ in range(3)]


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _run_both(fabrics, q, k, v, causal):
    jfab, fab = fabrics
    shard = jfab.sharding(None, "link", None)
    jq, jk, jv = (jax.device_put(x, shard) for x in (q, k, v))
    jout = jax_ring(jfab, "link", causal=causal)(jq, jk, jv)
    tq, tk, tv = (tensor_from_numpy(x, "cpu") for x in (q, k, v))
    out = ring_attention(fab, "link", causal=causal)(tq, tk, tv)
    ref = attention_reference(causal=causal)(tq, tk, tv)
    return _f32(out), _f32(ref), _f32(jout)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_ring_matches_full_attention_and_jax(fabrics, causal, dtype, tol):
    np_dtype = np.float32 if dtype == "float32" else jax.numpy.bfloat16
    q, k, v = _qkv((4, 8 * 16, 8), seed=42 if causal else 7, dtype=np_dtype)
    out, ref, jout = _run_both(fabrics, q, k, v, causal)
    assert out.shape == (4, 128, 8)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(out, jout, atol=tol, rtol=tol)
    want = _f32(jax_attention_reference(causal=causal)(q, k, v))
    np.testing.assert_allclose(ref, want, atol=tol, rtol=tol)


def test_ring_attention_long_sequence_sweep(fabrics):
    q, k, v = _qkv((2, 8 * 64, 32), seed=3, scale=4.0)
    v = v / 4.0
    out, ref, jout = _run_both(fabrics, q, k, v, causal=True)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out, jout, atol=1e-4, rtol=1e-4)


def test_causal_first_block_ignores_future(fabrics):
    _, fab = fabrics
    q, k, v = (tensor_from_numpy(x, "cpu") for x in _qkv((1, 64, 4), seed=9))
    ring = ring_attention(fab, "link", causal=True)
    base = ring(q, k, v).numpy()
    k2, v2 = k.clone(), v.clone()
    k2[:, 8:, :] += 100.0
    v2[:, 8:, :] -= 50.0
    poked = ring(q, k2, v2).numpy()
    np.testing.assert_allclose(base[:, :8, :], poked[:, :8, :], atol=1e-6)
    assert not np.allclose(base[:, 8:, :], poked[:, 8:, :])


def test_ring_attention_keeps_reference_constants():
    from brpc_tpu.models import ring_attention as jax_mod
    from brpc_tpu_torch.models import ring_attention as mod

    assert mod._NEG_INF == jax_mod._NEG_INF == -1e30
