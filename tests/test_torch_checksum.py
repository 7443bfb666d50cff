"""Port parity: brpc_tpu_torch.ops.checksum against brpc_tpu.ops.checksum,
bit-exact, on the same numpy-seeded payloads: integer lanes that wrap and
floating lanes that saturate."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke

from brpc_tpu.ops.checksum import fletcher32 as jax_fletcher32
from brpc_tpu.ops.checksum import sum32 as jax_sum32
from brpc_tpu_torch import payload_from_numpy, tensor_from_numpy
from brpc_tpu_torch.ops.checksum import as_u32, fletcher32, sum32


def _payload(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + n)
    if kind == "u8":
        return rng.integers(0, 1 << 8, size=n, dtype=np.uint8)
    if kind == "u32":
        return rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    return np.full(n, 0xFFFFFFFF, dtype=np.uint32)  # forces the wrap


# Odd and aligned lengths; fletcher lengths above 65,536 lanes make the
# reference's uint32 v*idx products wrap.
CASES = [
    ("u8", 1), ("u8", 1023), ("u8", 4096),
    ("u32", 0), ("u32", 1), ("u32", 1001), ("u32", 131072),
    ("u32", 70001), ("u32", 262147),
    ("ones", 7), ("ones", 65536), ("ones", 100003),
]


@pytest.mark.parametrize("kind,n", CASES)
def test_sum32_matches_jax(kind, n):
    arr = _payload(kind, n)
    want = int(jax_sum32(jnp.asarray(arr)))
    got = sum32(payload_from_numpy(arr, "cpu"))
    assert got.dtype == torch.uint32 and got.dim() == 0
    assert int(got) == want
    # The payload's own dtype (uint8 lanes widen like astype(uint32)).
    assert int(sum32(torch.from_numpy(arr))) == want


@pytest.mark.parametrize("kind,n", CASES)
def test_fletcher32_matches_jax(kind, n):
    arr = _payload(kind, n)
    want = np.asarray(jax_fletcher32(jnp.asarray(arr)))
    got = fletcher32(payload_from_numpy(arr, "cpu"))
    assert got.dtype == torch.uint32 and tuple(got.shape) == (2,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fletcher32(torch.from_numpy(arr)).numpy(), want)


def test_fletcher32_sees_reordering():
    arr = np.arange(1, 9, dtype=np.uint32)
    swapped = arr.copy()
    swapped[[0, 1]] = swapped[[1, 0]]
    a = fletcher32(payload_from_numpy(arr, "cpu"))
    b = fletcher32(payload_from_numpy(swapped, "cpu"))
    assert int(a[0]) == int(b[0]) and int(a[1]) != int(b[1])


def test_payload_from_numpy_converts_like_astype():
    arr = np.array([-1, 0, 7], dtype=np.int64)
    t = payload_from_numpy(arr, "cpu")
    assert t.dtype == torch.uint32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), arr.astype(np.uint32))


# -- floating lanes saturate as astype(jnp.uint32) does ------------------

def _float_array(values, name: str) -> np.ndarray:
    dt = ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)
    with np.errstate(over="ignore"):
        return np.array(values, np.float64).astype(dt)


# The motivating inputs, then every class of lane: in range, negative,
# fractional, 2^32, the largest f32 below it, above it, +-inf, NaN.
FLOAT_CASES = [
    ("float32", [-1.0]), ("float32", [1e10]), ("float32", [np.inf]),
    ("float32", [2.0 ** 32, 4294967040.0]),
    ("float16", [-3.0, 7.5, 65504.0]), ("bfloat16", [-2.0, 3.0, 5e9]),
] + [(name, [0.0, 1.0, 123456.75, -1.0, -0.5, 2.7, -0.0, 2.0 ** 32,
             4294967040.0, 5e9, 1e30, np.inf, -np.inf, np.nan, -np.nan])
     for name in ("float32", "float16", "bfloat16", "float64")]


@pytest.mark.parametrize("name,values", FLOAT_CASES)
def test_float_lanes_saturate_like_jax(name, values):
    arr = _float_array(values, name)
    t = tensor_from_numpy(arr, "cpu")
    assert int(sum32(t)) == int(jax_sum32(jnp.asarray(arr)))
    np.testing.assert_array_equal(fletcher32(t).numpy(),
                                  np.asarray(jax_fletcher32(jnp.asarray(arr))))
    np.testing.assert_array_equal(
        as_u32(t).numpy(), np.asarray(jnp.asarray(arr).astype(jnp.uint32)))


def test_float64_lanes_round_to_float32_first():
    # 4294967295.0 is below 2^32 in float64 but rounds to 2^32 in float32.
    t = torch.tensor([4294967295.0, 16777217.0], dtype=torch.float64)
    want = jax_sum32(jnp.asarray(np.array([4294967295.0, 16777217.0])))
    assert int(sum32(t)) == int(want) == (4294967295 + 16777216) & 0xFFFFFFFF


def test_float_lanes_over_many_lanes_match_jax():
    rng = np.random.default_rng(11)
    arr = (rng.standard_normal(70001) * 3e9).astype(np.float32)
    t = tensor_from_numpy(arr, "cpu")
    assert int(sum32(t)) == int(jax_sum32(jnp.asarray(arr)))
    np.testing.assert_array_equal(fletcher32(t).numpy(),
                                  np.asarray(jax_fletcher32(jnp.asarray(arr))))


def test_payload_from_numpy_saturates_floats_like_jax():
    arr = np.array([-1.0, 2.7, 1e10, np.nan, np.inf, 7.0], np.float32)
    np.testing.assert_array_equal(
        payload_from_numpy(arr, "cpu").numpy(),
        np.asarray(jnp.asarray(arr).astype(jnp.uint32)))


@pytest.mark.parametrize("name", sorted(chip_smoke.FLOAT_CHECKSUMS))
def test_chip_smoke_float_constants_are_the_references(name):
    """The constants chip_smoke.py holds the card's float checksums to are
    the JAX functions' results on the same edge payloads, and the port's
    on the CPU."""
    t = chip_smoke.float_edges(name, "cpu")
    arr = (t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
           if name == "bfloat16" else t.numpy())
    want_sum, want_fletcher = chip_smoke.FLOAT_CHECKSUMS[name]
    assert int(jax_sum32(jnp.asarray(arr))) == int(sum32(t)) == want_sum
    assert tuple(int(v) for v in np.asarray(
        jax_fletcher32(jnp.asarray(arr)))) == want_fletcher
    assert tuple(fletcher32(t).tolist()) == want_fletcher
