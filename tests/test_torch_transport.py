"""Port parity: IciTransport, the multi-device echo steps and streaming of
brpc_tpu_torch against brpc_tpu, on the same numpy-seeded inputs — the
cases of tests/test_transport.py and the chunk sweeps of
tests/test_shapes_sweep.py.  Every result is data movement or integer
arithmetic (the float step sums small integers), so all are bit-exact.
The port's peers are CPU threads under a rendezvous timeout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models.echo import make_full_dataplane_step as jax_full_step
from brpc_tpu.models.echo import make_nton_exchange as jax_nton
from brpc_tpu.models.echo import make_ring_exchange as jax_ring
from brpc_tpu.parallel.fabric import Fabric as JFabric
from brpc_tpu.parallel.fabric import P as JP
from brpc_tpu.streaming import ring_stream as jax_ring_stream
from brpc_tpu.streaming import stream_echo as jax_stream_echo
from brpc_tpu.transport.ici import IciTransport as JIci
from brpc_tpu_torch import tensor_from_numpy
from brpc_tpu_torch.models.echo import (make_full_dataplane_step,
                                        make_nton_exchange,
                                        make_ring_exchange)
from brpc_tpu_torch.parallel import Fabric, P
from brpc_tpu_torch.streaming import ring_stream, stream_echo
from brpc_tpu_torch.transport import IciTransport

N = 8
TIMEOUT_S = 60


@pytest.fixture(scope="module")
def rings():
    return (JFabric.auto((N,), ("link",)),
            Fabric.auto((N,), ("link",), devices="cpu", timeout_s=TIMEOUT_S))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _t(arr) -> torch.Tensor:
    return tensor_from_numpy(arr, "cpu")


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


@pytest.mark.parametrize("kind", ["arange", "random"])
def test_ici_echo_roundtrip_matches_jax(rings, kind):
    jring, ring = rings
    arr = (np.arange(64, dtype=np.float32) if kind == "arange" else
           np.random.default_rng(1).standard_normal(64).astype(np.float32))
    want = np.asarray(JIci(jring, "link").jit_echo()(jnp.asarray(arr)))
    got = IciTransport(ring, "link").jit_echo()(_t(arr))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), arr)


def test_transport_collectives_match_jax(rings):
    jring, ring = rings
    arr = _u32((N * N, 4), seed=2)
    jt, tt = JIci(jring, "link"), IciTransport(ring, "link")
    np.testing.assert_array_equal(
        _np(tt.jit_all_to_all()(_t(arr))),
        np.asarray(jt.jit_all_to_all()(jnp.asarray(arr))))
    every = JP("link")
    for name in ("all_gather", "reduce_scatter", "put"):
        jfn = jax.jit(jring.spmd(getattr(jt, name), in_specs=every,
                                 out_specs=every))
        tfn = ring.spmd(getattr(tt, name), in_specs=P("link"),
                        out_specs=P("link"))
        ints = arr.view(np.int32)  # psum_scatter of int32 wraps alike
        np.testing.assert_array_equal(
            _np(tfn(_t(ints))), np.asarray(jfn(jnp.asarray(ints))), name)


def test_reduce_scatter_rejects_other_ops(rings):
    with pytest.raises(ValueError, match="op='sum'"):
        IciTransport(rings[1], "link").reduce_scatter(torch.zeros(8), "max")


def test_all_to_all_exchange_matches_jax(rings):
    jring, ring = rings
    rows = np.zeros((N * N, 4), np.uint32)
    for i in range(N):
        for j in range(N):
            rows[i * N + j, :] = i * 100 + j
    want_recv, want_sums = jax_nton(jring, "link")(jnp.asarray(rows))
    recv, sums = make_nton_exchange(ring, "link")(_t(rows))
    np.testing.assert_array_equal(_np(recv), np.asarray(want_recv))
    np.testing.assert_array_equal(_np(sums), np.asarray(want_sums))
    assert sums.dtype == torch.uint32 and sums.shape == (N,)


def test_ring_exchange_visits_all_chunks_matches_jax(rings):
    jring, ring = rings
    ones = np.ones((8, 16), np.uint32)
    want_buf, want_sums = jax_ring(jring, "link")(jnp.asarray(ones))
    buf, sums = make_ring_exchange(ring, "link")(_t(ones))
    np.testing.assert_array_equal(_np(buf), np.asarray(want_buf))
    np.testing.assert_array_equal(_np(sums), np.asarray(want_sums))
    np.testing.assert_array_equal(_np(sums), np.full((8,), 128, np.uint32))


def test_ring_exchange_on_hop_outputs_match_jax(rings):
    jring, ring = rings
    arr = _u32((N * 2, 3), seed=3).astype(np.int32)

    def jbody(x):
        _, c, outs = JIci(jring, "link").ring_exchange(
            x, on_hop=lambda c, ch, hop: (c + ch[0, 0], ch[1] * hop))
        return c[None], outs

    def tbody(x):
        _, c, outs = IciTransport(ring, "link").ring_exchange(
            x, on_hop=lambda c, ch, hop: (c + ch[0, 0], ch[1] * hop))
        return c[None], outs

    jfn = jax.jit(jring.spmd(jbody, in_specs=JP("link"),
                             out_specs=(JP("link"), JP(None, "link"))))
    tfn = ring.spmd(tbody, in_specs=P("link"),
                    out_specs=(P("link"), P(None, "link")))
    (jc, jouts), (tc, touts) = jfn(jnp.asarray(arr)), tfn(_t(arr))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(touts), np.asarray(jouts))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
def test_stream_echo_matches_jax(rings, dtype):
    jring, ring = rings
    chunks = np.random.default_rng(4).integers(
        0, np.iinfo(dtype).max, size=(4, N, 16), dtype=dtype, endpoint=True)
    zeros = np.zeros((N,), np.uint32)
    want_tot, want_per = jax_stream_echo(jring, "link", 4)(
        jnp.asarray(chunks), jnp.asarray(zeros))
    tot, per = stream_echo(ring, "link", 4)(_t(chunks), _t(zeros))
    np.testing.assert_array_equal(_np(tot), np.asarray(want_tot))
    np.testing.assert_array_equal(_np(per), np.asarray(want_per))
    assert per.shape == (4, N)


def test_stream_echo_float_chunks_match_jax(rings):
    """f32 chunks: negative, fractional and out-of-range lanes saturate in
    each chunk's sum32 as the reference's astype(uint32) does."""
    jring, ring = rings
    chunks = (np.random.default_rng(9).standard_normal((4, N * 16))
              * 3e9).astype(np.float32)
    chunks[0, :4] = [np.nan, np.inf, -np.inf, 2.7]
    zeros = np.zeros((N,), np.uint32)
    want_tot, want_per = jax_stream_echo(jring, "link", 4)(
        jnp.asarray(chunks), jnp.asarray(zeros))
    tot, per = stream_echo(ring, "link", 4)(_t(chunks), _t(zeros))
    np.testing.assert_array_equal(_np(tot), np.asarray(want_tot))
    np.testing.assert_array_equal(_np(per), np.asarray(want_per))


def test_stream_echo_ones(rings):
    _, ring = rings
    tot, per = stream_echo(ring, "link", 4)(
        torch.ones((4, 8, 16), dtype=torch.uint8),
        torch.zeros((8,), dtype=torch.int32).view(torch.uint32))
    np.testing.assert_array_equal(_np(tot), np.full((8,), 64, np.uint32))
    np.testing.assert_array_equal(_np(per), np.full((4, 8), 16, np.uint32))


def test_ring_stream_custom_chunk_fn_matches_jax(rings):
    jring, ring = rings
    chunks = np.random.default_rng(5).integers(
        -50, 50, size=(3, N * 2, 4)).astype(np.float32)
    carry0 = np.zeros((), np.float32)

    want_c, want_o = jax_ring_stream(
        jring, "link", lambda c, ch: (c + jnp.sum(ch), jnp.max(ch)[None]),
        shift=3)(jnp.asarray(chunks), jnp.asarray(carry0))
    got_c, got_o = ring_stream(
        ring, "link", lambda c, ch: (c + ch.sum(), ch.max()[None]),
        shift=3)(
        _t(chunks), _t(carry0))
    np.testing.assert_array_equal(_np(got_c), np.asarray(want_c))
    np.testing.assert_array_equal(_np(got_o), np.asarray(want_o))


@pytest.mark.parametrize("mesh", [(2, 4), (1, 8)])
def test_full_dataplane_step_matches_jax(mesh):
    jfab = JFabric.auto(mesh, ("dp", "link"))
    fab = Fabric.auto(mesh, ("dp", "link"), devices="cpu",
                      timeout_s=TIMEOUT_S)
    payload = np.random.default_rng(6).integers(
        -100, 100, size=(8, 4)).astype(np.float32)
    want_resp, want_csum = jax_full_step(jfab, "dp", "link")(
        jnp.asarray(payload))
    resp, csum = make_full_dataplane_step(fab, "dp", "link")(_t(payload))
    np.testing.assert_array_equal(_np(resp), np.asarray(want_resp))
    np.testing.assert_array_equal(_np(csum), np.asarray(want_csum))


def test_full_dataplane_step_ones():
    fab = Fabric.auto((2, 4), ("dp", "link"), devices="cpu",
                      timeout_s=TIMEOUT_S)
    resp, csum = make_full_dataplane_step(fab, "dp", "link")(
        torch.ones((8, 4)))
    np.testing.assert_array_equal(_np(resp), np.full((8, 4), 3.0))
    assert float(csum[0]) == 3.0 * 8 * 4


@pytest.mark.parametrize("chunk", [4, 1024, 65536])
def test_nton_exchange_sweep_matches_jax(rings, chunk):
    jring, ring = rings
    rows = _u32((N * N, chunk), seed=chunk)
    want_recv, want_sums = jax_nton(jring, "link")(jnp.asarray(rows))
    recv, sums = make_nton_exchange(ring, "link")(_t(rows))
    np.testing.assert_array_equal(_np(recv), np.asarray(want_recv))
    np.testing.assert_array_equal(_np(sums), np.asarray(want_sums))
    expect = rows.reshape(N, N, chunk).transpose(1, 0, 2).reshape(
        N * N, chunk)
    np.testing.assert_array_equal(_np(recv), expect)


@pytest.mark.parametrize("chunk", [8, 2048])
def test_ring_exchange_rotation_and_carry_matches_jax(rings, chunk):
    jring, ring = rings
    rows = (np.arange(N * N * chunk, dtype=np.uint64) * 2654435761
            % (1 << 32)).astype(np.uint32).reshape(N * N, chunk)
    want_buf, want_carry = jax_ring(jring, "link")(jnp.asarray(rows))
    buf, carry = make_ring_exchange(ring, "link")(_t(rows))
    np.testing.assert_array_equal(_np(buf), np.asarray(want_buf))
    np.testing.assert_array_equal(_np(carry), np.asarray(want_carry))
    total = rows.astype(np.uint64).sum() % (1 << 32)
    np.testing.assert_array_equal(_np(carry).astype(np.uint64),
                                  np.full(N, total))
