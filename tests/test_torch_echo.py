"""Port parity: the echo kernel wrapper, the echo step and the graft entry
of brpc_tpu_torch against brpc_tpu, bit-exact, on the same numpy-seeded
payloads.  The JAX kernel runs in Pallas interpret mode, as its own tests
run it; the port takes its plain version for CPU tensors.  The kernel itself
runs only on a CUDA card: chip_smoke.py holds it against the plain version
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from brpc_tpu.models.echo import single_chip_echo_step as jax_step
from brpc_tpu.ops.echo_kernel import echo_fused as jax_echo_fused
from brpc_tpu.ops.echo_kernel import echo_reference as jax_echo_reference
from brpc_tpu_torch import payload_from_numpy, tensor_from_numpy
from brpc_tpu_torch.graft_entry import entry
from brpc_tpu_torch.models.echo import single_chip_echo_step
from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.ops.echo_kernel import (_BLOCK, WRAPPER, copy_offset,
                                            echo_fused, echo_reference,
                                            phase_split)
from brpc_tpu_torch.ops.roofline import hbm_peak_gbps


def _payload(kind: str, n: int) -> np.ndarray:
    if kind == "arange":
        return np.arange(n, dtype=np.uint32)
    if kind == "random":
        return np.random.default_rng(7).integers(
            0, 1 << 32, size=n, dtype=np.uint32)
    return np.full(n, 0xFFFFFFFF, dtype=np.uint32)


KINDS = ["arange", "random", "ones"]


def test_echo_fused_matches_jax_interpret():
    arr = _payload("random", 2 * _BLOCK)
    want_copy, want_sum = jax_echo_fused(jnp.asarray(arr), interpret=True)
    copy, csum = echo_fused(payload_from_numpy(arr, "cpu"))
    np.testing.assert_array_equal(copy.numpy(), np.asarray(want_copy))
    assert int(csum) == int(want_sum)


@pytest.mark.parametrize("kind", KINDS)
def test_echo_reference_matches_jax(kind):
    arr = _payload(kind, 2 * _BLOCK)
    want_copy, want_sum = jax_echo_reference(jnp.asarray(arr))
    copy, csum = echo_reference(payload_from_numpy(arr, "cpu"))
    np.testing.assert_array_equal(copy.numpy(), np.asarray(want_copy))
    assert csum.dtype == torch.uint32 and int(csum) == int(want_sum)
    fused_copy, fused_sum = echo_fused(payload_from_numpy(arr, "cpu"))
    assert torch.equal(fused_copy, copy) and int(fused_sum) == int(csum)


def test_echo_fused_rows_cols_match_jax_interpret():
    arr = _payload("random", 3 * 8 * 128)
    want_copy, want_sum = jax_echo_fused(jnp.asarray(arr), interpret=True,
                                         rows=8, cols=128)
    copy, csum = echo_fused(payload_from_numpy(arr, "cpu"), rows=8, cols=128)
    np.testing.assert_array_equal(copy.numpy(), np.asarray(want_copy))
    assert int(csum) == int(want_sum)


@pytest.mark.parametrize("lanes,rows,cols", [
    (100, 16, 8192),          # the reference's unaligned case
    (3 * 8 * 128, 16, 8192),  # aligned for (8, 128), not the default
    (_BLOCK + 4, 16, 8192),
])
def test_echo_fused_rejects_unaligned(lanes, rows, cols):
    p = torch.zeros(lanes, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(AssertionError):
        echo_fused(p, rows=rows, cols=cols)
    with pytest.raises(AssertionError):
        jax_echo_fused(jnp.zeros((lanes,), jnp.uint32), interpret=True,
                       rows=rows, cols=cols)


def test_echo_fused_cpu_does_not_count_launches():
    before = _kernels.launches[WRAPPER]
    echo_fused(torch.zeros(_BLOCK, dtype=torch.int32).view(torch.uint32))
    assert _kernels.launches[WRAPPER] == before


def test_echo_fused_refuses_other_devices():
    p = torch.empty(_BLOCK, dtype=torch.uint32, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        echo_fused(p)


@pytest.mark.parametrize("kind", KINDS)
def test_single_chip_echo_step_matches_jax(kind):
    arr = _payload(kind, 4099)
    want_resp, want_sum = jax_step(jnp.asarray(arr))
    resp, csum = single_chip_echo_step(payload_from_numpy(arr, "cpu"))
    np.testing.assert_array_equal(resp.numpy(), np.asarray(want_resp))
    assert int(csum) == int(want_sum)


def test_graft_entry_matches_reference():
    fn, (payload,) = entry(device="cpu")
    ref_fn, (ref_payload,) = __graft_entry__.entry()
    np.testing.assert_array_equal(payload.numpy(), np.asarray(ref_payload))
    resp, csum = fn(payload)
    want_resp, want_sum = jax.jit(ref_fn)(ref_payload)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(want_resp))
    assert int(csum) == int(want_sum)


def test_entry_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        payload_from_numpy(np.arange(4, dtype=np.uint32))


def test_kernel_build_requires_nvcc(monkeypatch):
    from torch.utils import cpp_extension

    monkeypatch.setattr(_kernels.shutil, "which", lambda _name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build("echo_kernel")


def test_kernel_build_requires_gpu(monkeypatch):
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _kernels.build("echo_kernel")


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0),
    ("TPU v5 lite", None),
])
def test_roofline_table(name, want):
    assert hbm_peak_gbps(name) == want


# -- floating payloads through the echo step ------------------------------

@pytest.mark.parametrize("dtype,scale", [(np.float16, 1e4), (np.float32, 3e9),
                                         (np.float32, 1.0)])
def test_single_chip_echo_step_float_matches_jax(dtype, scale):
    arr = (np.random.default_rng(8).standard_normal(4099) * scale).astype(
        dtype)
    want_resp, want_sum = jax_step(jnp.asarray(arr))
    resp, csum = single_chip_echo_step(tensor_from_numpy(arr, "cpu"))
    assert resp.dtype == getattr(torch, np.dtype(dtype).name)
    np.testing.assert_array_equal(resp.numpy(), np.asarray(want_resp))
    assert csum.dtype == torch.uint32 and int(csum) == int(want_sum)


# -- K1 on views: the host-side split, and the CPU wrapper ----------------

@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_phase_split_and_copy_offset(offset):
    """A payload at byte `offset` past a 16-byte boundary: K1 moves
    (16 - offset) % 16 / 4 head lanes as scalars; a copy allocated 3 lanes
    over, at copy_offset, shares the payload's phase; any other lane of
    that allocation takes the ragged path."""
    base = 0x7F0000001000
    n = 131072
    head = (16 - offset) % 16 // 4
    assert phase_split(base + offset, base + 64 + offset, n) == (
        head, (n - head) // 4 * 4, (n - head) % 4)
    for alloc in (base, base + 256):
        off = copy_offset(base + offset, alloc)
        assert off == offset // 4
        for lane in range(4):
            split = phase_split(base + offset, alloc + 4 * lane, n)
            assert (split is not None) == (lane == off)


def test_phase_split_small_and_misaligned():
    assert phase_split(4, 4, 2) == (2, 0, 0)  # fewer lanes than the head
    assert phase_split(16, 32, 7) == (0, 4, 3)
    with pytest.raises(ValueError):
        phase_split(2, 2, 8)


@pytest.mark.parametrize("view", ["offset_4", "stride_2"])
def test_echo_fused_cpu_on_views_matches_jax(view):
    """`x[1:1 + 131072]` and a stride-2 view: the reference slices a fresh
    array; the port's wrapper takes the view as it is."""
    arr = _payload("random", 2 * _BLOCK + 1)
    x = payload_from_numpy(arr, "cpu")
    if view == "offset_4":
        sl, p = arr[1:1 + _BLOCK], x[1:1 + _BLOCK]
    else:
        sl, p = arr[:2 * _BLOCK:2], x[:2 * _BLOCK:2]
    assert not p.is_contiguous() or p.data_ptr() % 16 == 4
    want_copy, want_sum = jax_echo_fused(jnp.asarray(sl), interpret=True)
    copy, csum = echo_fused(p)
    np.testing.assert_array_equal(copy.numpy(), np.asarray(want_copy))
    assert int(csum) == int(want_sum)
