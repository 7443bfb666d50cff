"""Port parity across dtypes: the port's device functions against the
reference's on the same numpy-seeded inputs, for every dtype the reference
takes — bool, uint8, int8, uint16, int16, int32, uint32, int64 (which
`jnp.asarray` narrows to int32), float16, bfloat16, float32 and float64
(narrowed to float32).  Each payload starts with the edge values 0, -1, the
type's min and max, +-inf, NaN, 2^32, 4294967040.0, -0.5 and 2.7 (as the
type holds them), then seeded random lanes.

Integer results, result types and the bytes a function moves are
bit-exact.  Float sums are held to rtol = atol = 1e-4, the reference tests'
own tolerance for float32 results (tests/test_ring_attention.py:59); NaN
must meet NaN.  Multi-device functions run on the conftest's 8-device CPU
mesh and on 8 logical CPU peers of the port's Fabric."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import lax

from brpc_tpu.models.echo import make_nton_exchange as jax_nton
from brpc_tpu.models.echo import single_chip_echo_step as jax_step
from brpc_tpu.ops.checksum import fletcher32 as jax_fletcher32
from brpc_tpu.ops.checksum import sum32 as jax_sum32
from brpc_tpu.ops.echo_kernel import echo_fused as jax_echo_fused
from brpc_tpu.ops.echo_kernel import echo_reference as jax_echo_reference
from brpc_tpu.parallel.fabric import Fabric as JFabric
from brpc_tpu.parallel.fabric import P as JP
from brpc_tpu.streaming import stream_echo as jax_stream_echo
from brpc_tpu.transport.ici import IciTransport as JIci
from brpc_tpu_torch import tensor_from_numpy
from brpc_tpu_torch.models.echo import make_nton_exchange, single_chip_echo_step
from brpc_tpu_torch.ops.checksum import fletcher32, sum32
from brpc_tpu_torch.ops.echo_kernel import echo_fused, echo_reference
from brpc_tpu_torch.parallel import Fabric, P
from brpc_tpu_torch.parallel import collectives as coll
from brpc_tpu_torch.streaming import stream_echo
from brpc_tpu_torch.transport import IciTransport

N = 8
TIMEOUT_S = 60
TOL = 1e-4  # tests/test_ring_attention.py:59

DTYPES = ["bool", "uint8", "int8", "uint16", "int16", "int32", "uint32",
          "int64", "float16", "bfloat16", "float32", "float64"]
FLOATS = {"float16", "bfloat16", "float32", "float64"}
FLOAT_TYPES = (np.dtype("float16"), np.dtype(ml_dtypes.bfloat16),
               np.dtype("float32"))


def _np_dtype(name: str):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _edges(name: str) -> np.ndarray:
    dt = _np_dtype(name)
    if name == "bool":
        return np.array([False, True, True, False])
    if name in FLOATS:
        info = ml_dtypes.finfo(dt) if name == "bfloat16" else np.finfo(dt)
        vals = [0.0, -1.0, float(info.min), float(info.max), np.inf,
                -np.inf, np.nan, 2.0 ** 32, 4294967040.0, -0.5, 2.7, -0.0]
        with np.errstate(over="ignore"):
            return np.array(vals, np.float64).astype(dt)
    info = np.iinfo(dt)
    bits = 8 * dt.itemsize
    # -0.5 and 2.7 as an integer type holds them (truncated); the rest wrap.
    vals = [0, -1, info.min, info.max, 2 ** 32, 4294967040, 0, 2]
    wrapped = [v % (1 << bits) for v in vals]
    if info.min < 0:
        wrapped = [v - (1 << bits) if v > info.max else v for v in wrapped]
    return np.array(wrapped, dt)


def _payload(name: str, lanes: int, seed: int = 0) -> np.ndarray:
    """The edge values, then seeded random lanes of the type: `lanes` in
    all."""
    dt = _np_dtype(name)
    rng = np.random.default_rng(seed + DTYPES.index(name))
    edges = _edges(name)
    rest = lanes - edges.size
    if name == "bool":
        body = rng.integers(0, 2, size=rest).astype(bool)
    elif name in FLOATS:
        scale = 1e3 if name == "float16" else 1e9
        body = (rng.standard_normal(rest) * scale).astype(dt)
    else:
        info = np.iinfo(dt)
        body = rng.integers(info.min, info.max, size=rest, dtype=dt,
                            endpoint=True)
    return np.concatenate([edges, body]).astype(dt)


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    if t.dtype == torch.bfloat16:  # its bits, NaN payloads included
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(got: torch.Tensor, want, float_sum: bool = False) -> None:
    """`got` (port) against `want` (reference): type, shape and bytes
    equal; for a float sum (`float_sum`), values within TOL instead of
    bytes, NaN meeting NaN."""
    want = np.asarray(want)
    got = _to_np(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if float_sum and want.dtype in FLOAT_TYPES:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=TOL,
                                   atol=TOL, equal_nan=True)
    else:
        assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def rings():
    return (JFabric.auto((N,), ("link",)),
            Fabric.auto((N,), ("link",), devices="cpu", timeout_s=TIMEOUT_S))


# -- the ops ---------------------------------------------------------------

@pytest.mark.parametrize("name", DTYPES)
def test_sum32_fletcher32_dtype(name):
    arr = _payload(name, 64)
    _same(sum32(tensor_from_numpy(arr, "cpu")), jax_sum32(jnp.asarray(arr)))
    _same(fletcher32(tensor_from_numpy(arr, "cpu")),
          jax_fletcher32(jnp.asarray(arr)))


@pytest.mark.parametrize("name", DTYPES)
def test_single_chip_echo_step_dtype(name):
    arr = _payload(name, 64)
    want_resp, want_sum = jax_step(jnp.asarray(arr))
    resp, csum = single_chip_echo_step(tensor_from_numpy(arr, "cpu"))
    _same(resp, want_resp)
    _same(csum, want_sum)


@pytest.mark.parametrize("name", DTYPES)
def test_echo_reference_dtype(name):
    arr = _payload(name, 64)
    want_copy, want_sum = jax_echo_reference(jnp.asarray(arr))
    copy, csum = echo_reference(tensor_from_numpy(arr, "cpu"))
    _same(copy, want_copy)
    _same(csum, want_sum)


@pytest.mark.parametrize("name", DTYPES)
def test_echo_fused_cpu_dtype(name):
    arr = _payload(name, 3 * 8 * 128)
    try:
        want = jax_echo_fused(jnp.asarray(arr), interpret=True, rows=8,
                              cols=128)
    except ValueError:  # Pallas refuses to store the type into uint32
        with pytest.raises(TypeError):
            echo_fused(tensor_from_numpy(arr, "cpu"), rows=8, cols=128)
        return
    copy, csum = echo_fused(tensor_from_numpy(arr, "cpu"), rows=8, cols=128)
    _same(copy, want[0])
    _same(csum, want[1])


# -- the fabric ------------------------------------------------------------

@pytest.mark.parametrize("name", DTYPES)
def test_ring_exchange_default_hop_dtype(rings, name):
    jring, ring = rings
    arr = _payload(name, N * 16)

    def jbody(x):
        buf, carry, _ = JIci(jring, "link").ring_exchange(x)
        return buf, carry[None]

    def tbody(x):
        buf, carry, _ = IciTransport(ring, "link").ring_exchange(x)
        return buf, carry[None]

    jfn = jax.jit(jring.spmd(jbody, in_specs=JP("link"),
                             out_specs=(JP("link"), JP("link"))))
    tfn = ring.spmd(tbody, in_specs=P("link"), out_specs=(P("link"),
                                                         P("link")))
    (jbuf, jsum), (buf, tsum) = jfn(jnp.asarray(arr)), tfn(
        tensor_from_numpy(arr, "cpu"))
    _same(buf, jbuf)
    _same(tsum, jsum, float_sum=True)


@pytest.mark.parametrize("name", DTYPES)
def test_stream_echo_dtype(rings, name):
    jring, ring = rings
    chunks = _payload(name, 3 * N * 8).reshape(3, N * 8)
    zeros = np.zeros((N,), np.uint32)
    want_tot, want_per = jax_stream_echo(jring, "link", 3)(
        jnp.asarray(chunks), jnp.asarray(zeros))
    tot, per = stream_echo(ring, "link", 3)(
        tensor_from_numpy(chunks, "cpu"), tensor_from_numpy(zeros, "cpu"))
    _same(tot, want_tot)
    _same(per, want_per)


@pytest.mark.parametrize("name", DTYPES)
def test_nton_exchange_dtype(rings, name):
    jring, ring = rings
    rows = _payload(name, N * N * 4).reshape(N * N, 4)
    want_recv, want_sums = jax_nton(jring, "link")(jnp.asarray(rows))
    recv, sums = make_nton_exchange(ring, "link")(
        tensor_from_numpy(rows, "cpu"))
    _same(recv, want_recv)
    _same(sums, want_sums)


_REDUCTIONS = {"psum": (lax.psum, coll.psum), "pmax": (lax.pmax, coll.pmax),
               "pmin": (lax.pmin, coll.pmin)}


@pytest.mark.parametrize("op", sorted(_REDUCTIONS))
@pytest.mark.parametrize("name", DTYPES)
def test_reduction_dtype(rings, op, name):
    jring, ring = rings
    jop, top = _REDUCTIONS[op]
    arr = _payload(name, N * 16)
    jfn = jax.jit(jring.spmd(lambda x: jop(x, "link"), in_specs=JP("link"),
                             out_specs=JP("link")))
    tfn = ring.spmd(lambda x: top(x, "link"), in_specs=P("link"),
                    out_specs=P("link"))
    _same(tfn(tensor_from_numpy(arr, "cpu")), jfn(jnp.asarray(arr)),
          float_sum=op == "psum")


# Each column is one lane over the 8 peers: where NaN and +-0 stand decides
# what the reference's all-reduce keeps.
_ORDER_COLUMNS = [
    [np.nan, 1, 2, 3, 4, 5, 6, 7], [0, 1, 2, 3, 4, 5, 6, np.nan],
    [0, 1, 2, np.nan, 4, 5, 6, 7], [np.nan] * 8,
    [np.nan, -1, -2, -3, -4, -5, -6, -7], [-0.0] + [0.0] * 7,
    [0.0] * 7 + [-0.0], [0.0] + [-0.0] * 7, [-0.0] * 7 + [0.0],
    [np.inf, -np.inf, 0, 0, 0, 0, 0, np.nan],
]


@pytest.mark.parametrize("op", ["pmax", "pmin"])
@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32"])
def test_extreme_nan_and_signed_zero_order(rings, op, name):
    jring, ring = rings
    jop, top = _REDUCTIONS[op]
    arr = np.array(_ORDER_COLUMNS, np.float64).T.astype(
        _np_dtype(name)).reshape(-1)
    jfn = jax.jit(jring.spmd(lambda x: jop(x, "link"), in_specs=JP("link"),
                             out_specs=JP("link")))
    tfn = ring.spmd(lambda x: top(x, "link"), in_specs=P("link"),
                    out_specs=P("link"))
    _same(tfn(tensor_from_numpy(arr, "cpu")), jfn(jnp.asarray(arr)))


@pytest.mark.parametrize("arr", [
    np.array([2 ** 40 + 5, -1, 2 ** 31, -2 ** 31 - 1], np.int64),
    np.array([2 ** 63, 2 ** 32 + 3, 7], np.uint64),
    np.array([1e300, -1e-50, np.nan, 16777217.0, -0.0], np.float64),
], ids=["int64", "uint64", "float64"])
def test_tensor_from_numpy_narrows_like_jnp_asarray(arr):
    _same(tensor_from_numpy(arr, "cpu"), jnp.asarray(arr))
