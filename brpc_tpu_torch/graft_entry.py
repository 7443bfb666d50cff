"""Entry points of the port — mirror __graft_entry__.py.

`entry(device=None)` returns the single-chip echo step and its payload, a
2^16-lane uint32 arange on the device (the GPU unless device="cpu").

`dryrun_multichip(n_devices, device=None)` runs the full sharded data-plane
step over a mesh of `n_devices` peers, with the reference's legs, shapes
and mesh choice (__graft_entry__.py:96-169), and checks each leg's result.
`device` follows `Fabric.auto`'s rules: one device shared by every peer
(the GPU when None), or a sequence of `n_devices` devices, one per peer
(one card each, as the reference takes `jax.devices()[:n]`, or repeats).
"""

from __future__ import annotations

import numpy as np
import torch

from brpc_tpu_torch import resolve_device
from brpc_tpu_torch.models.echo import single_chip_echo_step


def entry(device=None):
    dev = resolve_device(device)
    payload = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    return single_chip_echo_step, (payload.view(torch.uint32),)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Raises on the first leg whose result is wrong."""
    from brpc_tpu_torch.models.echo import (  # noqa: PLC0415
        make_full_dataplane_step, make_nton_exchange)
    from brpc_tpu_torch.models.ring_attention import (  # noqa: PLC0415
        attention_reference, ring_attention)
    from brpc_tpu_torch.ops.ring_kernel import (  # noqa: PLC0415
        ring_all_gather_kernel, ring_all_gather_reference)
    from brpc_tpu_torch.parallel import Fabric  # noqa: PLC0415

    n = int(n_devices)
    if device is None or isinstance(device, (str, torch.device)):
        devices = [resolve_device(device)] * n
    else:
        devices = list(device)
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} peers")
    if n >= 4 and n % 2 == 0:
        shape = (2, n // 2)
    else:
        shape = (1, n)
    fabric = Fabric.auto(shape, ("dp", "link"), devices=devices)
    dev = fabric.device  # where globals are put and outputs assembled
    n_link = fabric.axis_size("link")
    n_dp = fabric.axis_size("dp")

    # Composite fan-out + partition + stream-echo step (tiny shapes).
    step = make_full_dataplane_step(fabric, "dp", "link")
    payload = fabric.put(torch.ones((n_link * 8, 16), dtype=torch.float32),
                         "link", None)
    resp, csum = step(payload)
    scale = n_dp * (n_dp + 1) / 2  # handlers scale by rep+1, psum over dp
    _check(resp.shape == payload.shape, "step response shape")
    _check(bool(torch.equal(resp, payload * scale)), "step response values")
    _check(float(csum[0]) == scale * payload.numel(), "step checksum")

    # N-to-N exchange (rdma_performance analogue).
    ring = Fabric.auto((n,), ("link",), devices=devices)
    ex = make_nton_exchange(ring, "link")
    rows = np.arange(n * n * 32, dtype=np.uint32).reshape(n * n, 32)
    local = ring.put(torch.from_numpy(rows.view(np.int32)), "link").view(
        torch.uint32)
    recv, sums = ex(local)
    _check(recv.shape == local.shape, "exchange shape")
    want = rows.reshape(n, n, 32).transpose(1, 0, 2).reshape(n * n, 32)
    got = recv.view(torch.int32).cpu().numpy().view(np.uint32)
    _check(np.array_equal(got, want), "exchange rows")
    per_peer = want.reshape(n, -1).astype(np.uint64).sum(axis=1) % (1 << 32)
    _check(np.array_equal(sums.view(torch.int32).cpu().numpy().view(
        np.uint32), per_peer.astype(np.uint32)), "exchange checksums")

    # The ring all-gather kernel (K2) against the collective reference.
    if n >= 2:
        rows, cols = 8 * n, 128
        chunks = ring.put(torch.arange(rows * cols, dtype=torch.float32)
                          .reshape(rows, cols), "link")
        want = ring_all_gather_reference(ring, "link")(chunks)
        got = ring_all_gather_kernel(ring, "link")(chunks)
        _check(bool(torch.equal(got, want)), "ring all-gather")

    # Sequence-parallel ring attention against full attention.
    if n >= 2:
        bh, seq, d = 2, n * 8, 8
        base = torch.arange(bh * seq * d, dtype=torch.float32)
        q = torch.sin(base).reshape(bh, seq, d).to(dev)
        k = torch.cos(base).reshape(bh, seq, d).to(dev)
        v = torch.sin(0.5 * base).reshape(bh, seq, d).to(dev)
        out = ring_attention(ring, "link", causal=True)(q, k, v)
        want_attn = attention_reference(causal=True)(q, k, v)
        err = float((out - want_attn).abs().max())
        _check(bool(torch.allclose(out, want_attn, atol=1e-5, rtol=1e-5)),
               f"ring attention max err {err} (atol = rtol = 1e-5)")
