"""Launch-geometry sweep for K1, the fused echo kernel — port of
tools/tune_echo.py.

The reference sweeps the Pallas kernel's tile (rows x cols) and times a
`lax.scan` chain of echoes at two lengths, so the constant cost of the
host fetch cancels in the marginal cost.  On the card the tile is only
the caller's alignment contract; what shapes K1's speed is its launch
geometry: threads per block, uint4 loads in flight per thread, and full
blocks per SM.  This sweeps those through the kernel's geometry entry
(`brpc_echo_fused_geom`, csrc/echo_kernel.cu), and leaves K1's own entry
(`brpc_echo_fused`) and its geometry as they are.

Timing is the device's alone: K1 on preallocated payload, copy and
accumulator buffers, captured in two CUDA graphs of 4 and 36 launches
(the reference's two chain lengths); each graph's replay is timed with
CUDA events, and the marginal cost per launch is their difference over
32.  Goodput is payload bytes over that time, and `hbm_frac` the bytes
the pass moves (read once, written once: 2 x goodput) over the card's
published rate in `ops/roofline.py`, as the reference reports them.

Every geometry is first held bit-exact against `echo_reference` at
1 KiB (the batch path's (1, 256) tile), 1, 16 and 64 MiB; a geometry that
fails is reported as failed (and the run exits 1), never skipped.

Run on the GPU:  python -m brpc_tpu_torch.tools.tune_echo [--quick] [--json]
On the CPU:      python -m brpc_tpu_torch.tools.tune_echo --device cpu
                 (checks only: the plain version has no geometry to time)
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys

import numpy as np
import torch

from brpc_tpu_torch import payload_from_numpy, resolve_device
from brpc_tpu_torch.ops.echo_kernel import (DEFAULT_GEOMETRY, GEOM_THREADS,
                                            GEOM_UNROLLS, echo_fused_geom,
                                            echo_fused_into, echo_reference)
from brpc_tpu_torch.ops.roofline import hbm_peak_gbps

MIB = 1 << 20
#: Payload sizes every geometry is held exact at (bytes).
SIZES = (1024, 1 * MIB, 16 * MIB, 64 * MIB)
TIMED_BYTES = 64 * MIB
CHAIN = (4, 36)   # launches per graph: the reference's two scan lengths
REPS = 5
BLOCKS_PER_SM = (1, 2, 4, 8, 16)
#: The whole compiled set.
SWEEP = [tuple(g) for g in itertools.product(GEOM_THREADS, GEOM_UNROLLS,
                                             BLOCKS_PER_SM)]
#: A short set around the default, for a quick run.
QUICK = [DEFAULT_GEOMETRY, (128, 4, 16), (512, 4, 4), (1024, 4, 2),
         (256, 2, 8), (256, 8, 8), (256, 4, 4), (512, 8, 2)]


def marginal_ms(t_short_ms: float, t_long_ms: float, n_short: int = CHAIN[0],
                n_long: int = CHAIN[1]) -> float | None:
    """Milliseconds per launch between two chains: what the longer chain
    costs more, over its extra launches.  None when the longer chain was
    not slower (no marginal cost to read), as the reference skips it."""
    if n_long <= n_short:
        raise ValueError("the long chain must have more launches")
    if t_long_ms <= t_short_ms:
        return None
    return (t_long_ms - t_short_ms) / (n_long - n_short)


def goodput_gbps(nbytes: int, ms: float | None) -> float | None:
    return None if not ms else nbytes / (ms * 1e-3) / 1e9


def hbm_frac(goodput: float | None, peak_gbps: float | None) -> float | None:
    """Device-memory bytes moved (one read and one write pass: 2 x the
    goodput) over the card's peak."""
    if goodput is None or not peak_gbps:
        return None
    return 2 * goodput / peak_gbps


def device_ms(launch, chain=CHAIN, reps: int = REPS) -> float | None:
    """Marginal milliseconds per `launch()` on the card: two CUDA graphs of
    chain[0] and chain[1] launches, each replay timed with CUDA events,
    the median over `reps` of their marginal cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # one launch outside capture: warm
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for n in chain:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                launch()
        graphs.append(g)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay_ms(g) -> float:
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for g in graphs:
        replay_ms(g)
    got = []
    for _ in range(reps):
        t_short = replay_ms(graphs[0])
        t_long = replay_ms(graphs[1])
        m = marginal_ms(t_short, t_long, *chain)
        if m is not None:
            got.append(m)
    return statistics.median(got) if got else None


def _payload(nbytes: int, dev, seed: int) -> torch.Tensor:
    rand = np.random.default_rng(seed).integers(
        0, 1 << 32, size=nbytes // 4, dtype=np.uint32)
    return payload_from_numpy(rand, dev)


def check_exact(geometry, dev, sizes=SIZES, seed: int = 0) -> str | None:
    """None when the geometry's copy and checksum equal echo_reference's,
    bit for bit, at every size; else what differed."""
    for nbytes in sizes:
        p = _payload(nbytes, dev, seed + nbytes)
        copy, csum = echo_fused_geom(p, geometry)
        ref_copy, ref_sum = echo_reference(p)
        if not torch.equal(copy.view(torch.int32), ref_copy.view(torch.int32)):
            return f"copy differs at {nbytes} bytes"
        got = int(csum.view(torch.int32)) & 0xFFFFFFFF
        want = int(ref_sum.view(torch.int32)) & 0xFFFFFFFF
        if got != want:
            return f"checksum {got:#x} != {want:#x} at {nbytes} bytes"
    return None


def time_k1(dev, geometry=None, nbytes: int = TIMED_BYTES,
            chain=CHAIN, reps: int = REPS) -> float | None:
    """Host-free marginal ms of one K1 launch at `nbytes`: K1's own entry
    with `geometry` None, else the geometry entry at that geometry."""
    lanes = nbytes // 4
    p = torch.arange(lanes, dtype=torch.int32, device=dev).view(torch.uint32)
    copy = torch.empty(lanes, dtype=torch.int32, device=dev)
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    return device_ms(lambda: echo_fused_into(p, copy, acc, geometry),
                     chain, reps)


def sweep(geometries=QUICK, device=None, sizes=SIZES,
          timed_bytes: int = TIMED_BYTES, log=None) -> dict:
    """Checks, then (on the card) times, every geometry.  Returns the rows,
    the best exact geometry by goodput, and K1's own entry timed the same
    way (`k1_default`)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = hbm_peak_gbps(name) if cuda else None
    rows = []
    for geometry in geometries:
        row = {"threads": geometry[0], "unroll": geometry[1],
               "blocks_per_sm": geometry[2],
               "default": tuple(geometry) == DEFAULT_GEOMETRY,
               "exact": False, "failed": None, "ms": None,
               "goodput_gbps": None, "hbm_frac": None}
        try:
            row["failed"] = check_exact(geometry, dev, sizes)
            row["exact"] = row["failed"] is None
            if cuda and row["exact"]:
                row["ms"] = time_k1(dev, geometry, timed_bytes)
                row["goodput_gbps"] = goodput_gbps(timed_bytes, row["ms"])
                row["hbm_frac"] = hbm_frac(row["goodput_gbps"], peak)
        except Exception as e:  # noqa: BLE001 - reported as this row's fault
            row["exact"] = False
            row["failed"] = f"{type(e).__name__}: {e}"
        rows.append(row)
        if log:
            log(json.dumps(row))
    timed = [r for r in rows if r["exact"] and r["goodput_gbps"]]
    best = max(timed, key=lambda r: r["goodput_gbps"]) if timed else None
    k1 = None
    if cuda:
        ms = time_k1(dev, None, timed_bytes)
        gbps = goodput_gbps(timed_bytes, ms)
        k1 = {"geometry": list(DEFAULT_GEOMETRY), "ms": ms,
              "goodput_gbps": gbps, "hbm_frac": hbm_frac(gbps, peak)}
    return {"device": name, "hbm_peak_gbps": peak, "timed_bytes": timed_bytes,
            "chain": list(CHAIN), "rows": rows, "best": best,
            "k1_default": k1,
            "failed": [r for r in rows if not r["exact"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the GPU; --device cpu checks the plain "
                         "version only")
    ap.add_argument("--quick", action="store_true",
                    help=f"the short set of {len(QUICK)} geometries "
                         "instead of the whole compiled set")
    ap.add_argument("--json", action="store_true",
                    help="print the whole result as one JSON line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = sweep(QUICK if args.quick else SWEEP, dev,
                log=None if args.json else print)
    if args.json:
        print(json.dumps(out))
    else:
        print(f"# device: {out['device']} (peak {out['hbm_peak_gbps']} GB/s)")
        print("# K1's own entry:", json.dumps(out["k1_default"]))
        print("# best:", json.dumps(out["best"]))
        for row in out["failed"]:
            print("# FAILED:", json.dumps(row))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
