"""Port parity: the pipeline-parallel step (brpc_tpu_torch.tools.
pipeline_step) and its microbatch producer (brpc_tpu_torch.ops.lcg)
against tools/pipeline_step.py.

The producer's plain version is held bit-exact against the reference's
jitted jnp loop on the reference's own seeds; the step runs on the CPU at
a small size (its pieces then come from the plain version) and its
gathered buffers are held against the u32 sums of the jnp loop's pieces.
The LCG kernel itself runs only on the card (chip_smoke.py)."""

import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops import _kernels
from brpc_tpu_torch.ops import lcg as lcg_mod
from brpc_tpu_torch.ops.lcg import (WRAPPER, affine, lcg, lcg_jump,
                                    lcg_plain, piece_base)
from brpc_tpu_torch.rpc import collective, fault, get_flag
from brpc_tpu_torch.tools import pipeline_step as port_ps

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "_ref_pipeline_step", REPO / "tools" / "pipeline_step.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("iters", [1, 8, 64, 1000])
def test_plain_lcg_matches_jitted_jnp_loop(iters):
    kernel = REF._make_kernel(iters)
    words = 4096
    for rank, m, p in ((0, 0, 0), (3, 7, 3), (1, 2, 0)):
        want = np.asarray(kernel(REF._piece_seed(rank, m, p, words)))
        base = piece_base(rank, m, p)
        assert np.array_equal(_u32(lcg_plain(words, base, iters, "cpu")),
                              want)
        assert np.array_equal(_u32(lcg(words, base, iters, "cpu")), want)
        assert np.array_equal(
            _u32(lcg_jump(words, torch.tensor([base]), iters)[0]), want)


def test_piece_base_is_the_reference_seed():
    for rank, m, p in ((0, 0, 0), (3, 7, 3), (4000, 1, 2)):
        seed = REF._piece_seed(rank, m, p, 3)
        assert int(seed[0]) == piece_base(rank, m, p)


@pytest.mark.parametrize("iters", [0, 1, 2, 3, 1000, 4097])
def test_affine_composes_the_steps(iters):
    a, b = affine(iters)
    v = 123456789
    for _ in range(iters):
        v = (v * lcg_mod.MUL + lcg_mod.ADD) & lcg_mod.MASK
    assert (a * 123456789 + b) & lcg_mod.MASK == v
    a2, b2 = affine(2 * iters)  # two halves compose to the whole
    assert (a2, b2) == ((a * a) & lcg_mod.MASK, (a * b + b) & lcg_mod.MASK)


def test_lcg_jump_batches_bases():
    bases = torch.tensor([piece_base(r, m, p) for r in range(2)
                          for m in range(2) for p in range(3)])
    got = lcg_jump(256, bases, 37)
    for i, base in enumerate(bases.tolist()):
        assert torch.equal(got[i].view(torch.int32),
                           lcg_plain(256, base, 37, "cpu").view(torch.int32))


def test_lcg_argument_contract():
    with pytest.raises(ValueError):
        lcg(0, 1, 1, "cpu")
    with pytest.raises(ValueError):
        lcg(4, 1 << 32, 1, "cpu")
    with pytest.raises(ValueError):
        lcg_plain(4, 1, -1, "cpu")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        lcg(4, 1, 1, "meta")
    before = _kernels.launches[WRAPPER]
    lcg(64, 1, 3, "cpu")
    assert _kernels.launches[WRAPPER] == before  # the plain version ran


def test_lcg_cuda_request_without_a_build_raises(monkeypatch):
    """A CUDA request never falls back to the plain version: without nvcc
    the build raises before any output is made."""
    from torch.utils import cpp_extension

    lcg_mod._entry.cache_clear()
    monkeypatch.setattr(_kernels.shutil, "which", lambda _name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    before = _kernels.launches[WRAPPER]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lcg(64, 1, 3, "cuda")
    assert _kernels.launches[WRAPPER] == before
    lcg_mod._entry.cache_clear()


def test_run_pipeline_cpu_is_exact_and_quiescent():
    gathered = []
    row = port_ps.run_pipeline(
        members=4, shard_kb=16, microbatches=2, link_delay_ms=0,
        device="cpu",
        on_gathered=lambda bufs: gathered.extend(
            [[t.clone() for t in per] for per in bufs]))
    assert row["byte_exact"] is True
    assert row["ready_triggers"] > 0
    assert row["sessions_live"] == 0 and row["ready_maps_live"] == 0
    assert (row["members"], row["microbatches"], row["shard_bytes"],
            row["link_delay_ms"]) == (4, 2, 16 << 10, 0)
    assert row["compute_iters"] >= 8
    assert collective.ready_maps_live() == 0
    assert get_flag("trpc_coll_overlap") == "false"
    assert fault.get_schedule() == ""
    # Every member gathers the u32 sum over members of the pieces the
    # reference's jnp loop makes at the calibrated iters.
    n, words, iters = 4, (16 << 10) // 4, row["compute_iters"]
    kernel = REF._make_kernel(iters)
    for m in range(2):
        want = np.concatenate([
            sum(np.asarray(kernel(REF._piece_seed(r, m, p, words))).astype(
                np.uint64) for r in range(n)).astype(np.uint32)
            for p in range(n)])
        for r in range(n):
            assert np.array_equal(gathered[r][m].numpy().view(np.uint32),
                                  want), (r, m)


def test_row_has_the_reference_keys():
    """The port's row carries exactly the keys of the reference's row (read
    from the reference's source, which builds it as one dict literal)."""
    import ast

    tree = ast.parse((REPO / "tools" / "pipeline_step.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_pipeline")
    want = {k.value for n in ast.walk(fn) if isinstance(n, ast.Dict)
            for k in n.keys if isinstance(k, ast.Constant)}
    assert "overlap_efficiency" in want
    row = port_ps.run_pipeline(members=2, shard_kb=8, microbatches=1,
                               link_delay_ms=0, device="cpu")
    assert set(row) == want


def test_run_pipeline_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ps.run_pipeline(members=2, shard_kb=8, microbatches=1,
                             link_delay_ms=0)


def test_module_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.tools.pipeline_step",
         "--json", "--device", "cpu", "--members", "2", "--shard-kb", "8",
         "--microbatches", "1", "--link-delay-ms", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["workload"] == "pipeline_overlap" and row["byte_exact"]


@pytest.mark.parametrize("ratios,runs", [
    ((0.8,), 1),               # on target at once
    ((2.0, 0.7), 2),           # too much compute, then on target
    ((0.1, 0.3, 0.5), 3),      # never on target: the last run's iters stand
    ((3.0, 3.0, 3.0), 3),
    ((1e-4, 0.5), 2),          # the rescale hits the 2^20 cap
])
def test_calibrate_returns_the_iters_of_the_last_baseline(ratios, runs):
    """The overlapped run is held to the last baseline's bytes, so it must
    compute with the iters that baseline ran with, on target or not."""
    seen = []

    def baseline(iters):
        seen.append(iters)
        return ratios[len(seen) - 1]

    got = port_ps.calibrate(baseline, 1000)
    assert len(seen) == runs
    assert got == seen[-1]
    assert all(8 <= i <= 1 << 20 for i in seen)


@pytest.mark.parametrize("ratios,want", [
    ((0.1,), [1 << 20]),                                   # more wanted
    ((1.5, 0.8), [1 << 20, int((1 << 20) * 0.8 / 1.5)]),   # scale down
])
def test_calibrate_at_the_cap_stops_only_when_more_is_wanted(ratios, want):
    seen = []

    def baseline(iters):
        seen.append(iters)
        return ratios[len(seen) - 1]

    assert port_ps.calibrate(baseline, 1 << 20) == want[-1]
    assert seen == want


@pytest.mark.parametrize("hi_s,lo_s,want", [
    (0.010, 0.004, (0.010 - 0.004) / 64),   # the marginal of 64 iters
    (0.004, 0.010, 0.004 / 128),            # noise: the longer probe's mean
    (0.005, 0.005, 0.005 / 128),
])
def test_per_iter_cost_never_reaches_zero(hi_s, lo_s, want):
    """A loaded host can time the 128-iteration probe no slower than the
    64-iteration one; the cost then falls back to an upper bound instead
    of 0, which would aim the first baseline at the 2^20 cap."""
    got = port_ps.per_iter_cost(hi_s, lo_s, 128, 64)
    assert got == pytest.approx(want) and got > 0
