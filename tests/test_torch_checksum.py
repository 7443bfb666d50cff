"""Port parity: brpc_tpu_torch.ops.checksum against brpc_tpu.ops.checksum,
bit-exact, on the same numpy-seeded payloads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops.checksum import fletcher32 as jax_fletcher32
from brpc_tpu.ops.checksum import sum32 as jax_sum32
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.ops.checksum import fletcher32, sum32


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
