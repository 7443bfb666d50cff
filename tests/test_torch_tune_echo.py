"""brpc_tpu_torch.tools.tune_echo (port of tools/tune_echo.py) and K1's
geometry entry, on the CPU.

The timing runs only on the card; here the arithmetic that turns two
chain timings into a marginal cost, goodput and `hbm_frac` is held on
injected timings, the geometry set is held against what csrc compiles in,
and every geometry's result at the sweep's sizes is held against the
plain version and the reference's Pallas kernel in interpret mode.
"""

import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.ops.echo_kernel import echo_fused as jax_echo_fused
from brpc_tpu_torch import payload_from_numpy
from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.ops.echo_kernel import (DEFAULT_GEOMETRY, GEOM_THREADS,
                                            GEOM_UNROLLS, check_geometry,
                                            echo_fused, echo_fused_geom,
                                            echo_fused_into, echo_reference)
from brpc_tpu_torch.tools import tune_echo

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = (REPO / "brpc_tpu_torch" / "csrc" / "echo_kernel.cu").read_text()


@pytest.mark.parametrize("t_short,t_long,chain,want", [
    (10.0, 42.0, (4, 36), 1.0),
    (0.2, 1.8, (4, 36), 0.05),
    (5.0, 5.0, (4, 36), None),      # not slower: nothing to read
    (5.0, 4.0, (4, 36), None),
    (1.0, 3.0, (1, 3), 1.0),
])
def test_marginal_cost_on_injected_timings(t_short, t_long, chain, want):
    got = tune_echo.marginal_ms(t_short, t_long, *chain)
    assert got == pytest.approx(want) if want is not None else got is None


def test_marginal_cost_needs_a_longer_chain():
    with pytest.raises(ValueError):
        tune_echo.marginal_ms(1.0, 2.0, 36, 4)


@pytest.mark.parametrize("nbytes,ms,peak,gbps,frac", [
    (64 << 20, 0.05, 3350.0, 1342.17728, 0.80130),
    (64 << 20, 0.0401, 3350.0, 1673.53, 0.99913),
    (1 << 20, 1.0, 2000.0, 1.048576, 0.0010486),
    (64 << 20, 0.05, None, 1342.17728, None),
])
def test_goodput_and_hbm_frac(nbytes, ms, peak, gbps, frac):
    g = tune_echo.goodput_gbps(nbytes, ms)
    assert g == pytest.approx(gbps, rel=1e-4)
    f = tune_echo.hbm_frac(g, peak)
    assert f == (pytest.approx(frac, rel=1e-3) if frac is not None else None)
    assert tune_echo.goodput_gbps(nbytes, None) is None


def test_geometry_sets_are_well_formed():
    assert len(set(tune_echo.SWEEP)) == len(tune_echo.SWEEP) == \
        len(GEOM_THREADS) * len(GEOM_UNROLLS) * len(tune_echo.BLOCKS_PER_SM)
    assert set(tune_echo.QUICK) <= set(tune_echo.SWEEP)
    assert len(set(tune_echo.QUICK)) == len(tune_echo.QUICK)
    assert tune_echo.QUICK[0] == DEFAULT_GEOMETRY
    for g in tune_echo.SWEEP:
        assert check_geometry(g) == g
    assert tune_echo.SIZES == (1024, 1 << 20, 16 << 20, 64 << 20)
    assert tune_echo.CHAIN == (4, 36)  # the reference's scan lengths


def test_geometries_match_what_the_kernel_compiles():
    """DEFAULT_GEOMETRY is brpc_echo_fused's own, and GEOM_THREADS and
    GEOM_UNROLLS are the cases the geometry entry dispatches."""
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kThreads|kUnroll|kBlocksPerSm) = (\d+);", CSRC)}
    assert DEFAULT_GEOMETRY == (consts["kThreads"], consts["kUnroll"],
                                consts["kBlocksPerSm"])
    entry = CSRC[CSRC.index("brpc_echo_fused_geom"):]
    assert tuple(int(v) for v in re.findall(
        r"case (\d+): *\n? *return launch_unroll", entry)) == GEOM_THREADS
    unrolls = CSRC[CSRC.index("int launch_unroll"):]
    assert tuple(int(v) for v in re.findall(
        r"case (\d+): return launch_geom", unrolls)) == GEOM_UNROLLS


@pytest.mark.parametrize("bad", [(64, 4, 8), (256, 3, 8), (256, 4, 0),
                                 (2048, 4, 1)])
def test_check_geometry_refuses_what_is_not_compiled(bad):
    with pytest.raises(ValueError):
        check_geometry(bad)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("argv", [[], ["--quick"], ["--json"]])
def test_tool_raises_without_a_card_or_device_cpu(argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_echo.main(argv)


def _payload(nbytes: int, seed: int):
    arr = np.random.default_rng(seed).integers(
        0, 1 << 32, size=nbytes // 4, dtype=np.uint32)
    return arr, payload_from_numpy(arr, "cpu")


@pytest.mark.parametrize("nbytes", tune_echo.SIZES)
def test_echo_fused_matches_reference_and_pallas_at_each_size(nbytes):
    """At the sweep's sizes and their tiles ((1, 256) at 1 KiB), the port's
    K1 wrapper, its geometry entry and the Pallas kernel (interpret mode)
    agree bit for bit."""
    arr, p = _payload(nbytes, nbytes)
    rows, cols = (1, 256) if nbytes == 1024 else (16, 8192)
    copy, csum = echo_fused(p, rows, cols)
    ref_copy, ref_sum = echo_reference(p)
    assert torch.equal(copy.view(torch.int32), ref_copy.view(torch.int32))
    assert int(csum.view(torch.int32)) == int(ref_sum.view(torch.int32))
    want = int(arr.sum(dtype=np.uint64)) & 0xFFFFFFFF
    assert int(csum.view(torch.int32)) & 0xFFFFFFFF == want
    if nbytes <= 1 << 20:  # the interpreter is slow above that
        j_copy, j_sum = jax_echo_fused(jnp.asarray(arr), rows=rows,
                                       cols=cols, interpret=True)
        np.testing.assert_array_equal(np.asarray(j_copy), arr)
        assert int(j_sum) == want
    for g in tune_echo.QUICK:
        gcopy, gsum = echo_fused_geom(p, g)
        assert torch.equal(gcopy.view(torch.int32), copy.view(torch.int32))
        assert int(gsum.view(torch.int32)) == int(csum.view(torch.int32))


def test_echo_fused_into_accumulates_without_zeroing():
    _, p = _payload(4096, 7)
    copy = torch.empty(1024, dtype=torch.int32)
    acc = torch.zeros(1, dtype=torch.int32)
    one = int(echo_reference(p)[1].view(torch.int32)) & 0xFFFFFFFF
    _kernels.reset_launches()
    echo_fused_into(p, copy, acc)
    echo_fused_into(p, copy, acc, DEFAULT_GEOMETRY)
    assert int(acc) & 0xFFFFFFFF == (2 * one) & 0xFFFFFFFF
    assert torch.equal(copy, p.view(torch.int32))
    assert not _kernels.launches  # CPU tensors launch nothing
    with pytest.raises(ValueError):
        echo_fused_into(p, copy, acc, (100, 4, 8))


def test_cpu_sweep_checks_every_geometry_and_times_none(capsys):
    assert tune_echo.main(["--device", "cpu", "--json", "--quick"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["exact"] for r in out["rows"]] == [True] * len(tune_echo.QUICK)
    assert [r["default"] for r in out["rows"]] == \
        [True] + [False] * (len(tune_echo.QUICK) - 1)
    assert out["failed"] == [] and out["best"] is None
    assert all(r["ms"] is None for r in out["rows"])
    assert out["k1_default"] is None


def test_a_failing_geometry_is_reported_not_skipped(monkeypatch, capsys):
    def broken(payload, geometry):
        copy, csum = echo_reference(payload)
        if geometry == (512, 4, 4):
            copy = copy.view(torch.int32).clone()
            copy[0] ^= 1
            copy = copy.view(torch.uint32)
        return copy, csum

    monkeypatch.setattr(tune_echo, "echo_fused_geom", broken)
    assert tune_echo.main(["--device", "cpu", "--quick"]) == 1
    out = capsys.readouterr().out
    assert "# FAILED:" in out and '"blocks_per_sm": 4' in out
