#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (brpc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

From the root of a checkout it:

1. builds every kernel of the port (nvcc, sm_90a) and the native runtime
   (build/libtpurpc.so) from the sources, in parallel, and prints each
   build time and the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card,
   bit-exact, at the main path's sizes (1, 16 and 64 MiB; arange, seeded
   random and all-0xFFFFFFFF payloads), plus its error contract;
3. runs the single-chip echo step of `graft_entry.entry()` and at 64 MiB;
4. drives the main path — the 64 MiB echo data plane, device → RPC stack →
   device, verified on the device — over tcp, shm and the ici staging leg
   from a CUDA-registered slab, with every kernel launch count reset just
   before and read just after;
5. times each kernel at 64 MiB with CUDA events beside its bound, its plain
   version and PyTorch calls for the same function, and the D2H landing
   and RPC rates.

It prints a `{"kernels": [...]}` line, the card line, and last
`{"ok": true, "device": {...}}`.  It exits non-zero, printing no result,
when there is no CUDA device, when run outside the repository, or when any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

MIB = 1 << 20
SIZES_MIB = (1, 16, 64)
MAIN_BYTES = 64 * MIB
RPC_CALLS = 8
SEED = 0
MASK = 0xFFFFFFFF
# The H100 SXM's 32-bit integer add rate for the operations bound on K1's
# n adds: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12 adds/s.  It
# never binds (the bytes bound is ~40x larger), but it is the other half
# of the bound the kernels line reports.
INT32_ADDS_PER_S = 132 * 64 * 1.98e9


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def u32(t) -> int:
    """A 0-dim uint32 tensor's value (read through its int32 bits)."""
    import torch

    return int(t.view(torch.int32).item()) & MASK


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def payloads(lanes: int, dev):
    """(kind, uint32 payload on dev, expected sum32) for the three kinds."""
    import numpy as np
    import torch

    from brpc_tpu_torch import payload_from_numpy

    rand = np.random.default_rng(SEED).integers(
        0, 1 << 32, size=lanes, dtype=np.uint32)
    yield ("arange",
           torch.arange(lanes, dtype=torch.int32, device=dev).view(
               torch.uint32),
           (lanes * (lanes - 1) // 2) & MASK)
    yield ("random", payload_from_numpy(rand, dev),
           int(rand.sum(dtype=np.uint64)) & MASK)
    yield ("all_ones",
           torch.full((lanes,), -1, dtype=torch.int32, device=dev).view(
               torch.uint32),
           (lanes * MASK) & MASK)


def phase_build(log) -> None:
    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import KERNEL
    from brpc_tpu_torch.rpc import _lib

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        return name, time.perf_counter() - t0, out

    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(timed, f"kernel {KERNEL}",
                            lambda: _kernels.build(KERNEL)),
                pool.submit(timed, "libtpurpc.so", _lib.ensure_built)]
        results = [f.result() for f in futs]
    for name, secs, out in results:
        log(f"build {name}: {secs:.3f} s")
        if name.startswith("kernel"):
            ptxas = out.with_name(out.name + ".log").read_text()
            for line in ptxas.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")


def phase_kernel_vs_plain(dev, log) -> int:
    """K1 against echo_reference on the card; returns the max abs error."""
    import torch

    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import (WRAPPER, echo_fused,
                                                echo_reference)

    max_err = 0
    for mib in SIZES_MIB:
        lanes = mib * MIB // 4
        for kind, p, want in payloads(lanes, dev):
            copy, csum = echo_fused(p)
            ref_copy, ref_sum = echo_reference(p)
            torch.cuda.synchronize()
            diff = (copy.view(torch.int32).to(torch.int64) & MASK) - (
                ref_copy.view(torch.int32).to(torch.int64) & MASK)
            err = max(int(diff.abs().max()), abs(u32(csum) - u32(ref_sum)))
            max_err = max(max_err, err)
            check(err == 0, f"K1 != plain at {mib} MiB {kind} (err {err})")
            check(u32(csum) == want,
                  f"K1 checksum {u32(csum)} != {want} at {mib} MiB {kind}")
            log(f"K1 vs plain {mib:>2} MiB {kind:<8}: bit-exact, "
                f"sum32={u32(csum)}")
    try:
        echo_fused(torch.zeros(100, dtype=torch.int32, device=dev).view(
            torch.uint32))
    except AssertionError:
        pass
    else:
        raise SmokeError("unaligned payload did not raise AssertionError")
    _kernels.reset_launches()
    p = torch.zeros(MIB // 4, dtype=torch.int32, device=dev).view(
        torch.uint32)
    for _ in range(3):
        echo_fused(p)
    echo_reference(p)
    check(_kernels.launches[WRAPPER] == 3,
          f"launch counter {_kernels.launches[WRAPPER]} != 3")
    torch.cuda.synchronize()
    log("K1 contract: AssertionError on unaligned, launch counter exact")
    return max_err


def phase_step(dev, log) -> None:
    import torch

    from brpc_tpu_torch.graft_entry import entry
    from brpc_tpu_torch.models.echo import single_chip_echo_step
    from brpc_tpu_torch.ops.echo_kernel import echo_fused

    fn, (p,) = entry()
    check(p.device.type == "cuda", f"entry() payload on {p.device}")
    resp, csum = fn(p)
    n = p.numel()
    check(u32(csum) == (n * (n - 1) // 2) & MASK, "entry step checksum")
    check(u32(echo_fused(p, rows=8)[1]) == u32(csum),
          "entry step checksum != K1 checksum")
    ri, pi = resp.view(torch.int32), p.view(torch.int32)
    check(int(ri[0]) == n - 1 and torch.equal(ri[1:], pi[:-1]),
          "entry step is not a roll by one lane")
    big = torch.arange(MAIN_BYTES // 4, dtype=torch.int32,
                       device=dev).view(torch.uint32)
    _, csum = single_chip_echo_step(big)
    check(u32(csum) == u32(echo_fused(big)[1]),
          "64 MiB step checksum != K1 checksum")
    torch.cuda.synchronize()
    log(f"step: entry() {n} lanes and 64 MiB checksums match K1")


def phase_main_path(dev, log) -> dict:
    """The echo data plane at 64 MiB over tcp, shm and the ici staging
    leg, verified on the device."""
    import numpy as np
    import torch

    from brpc_tpu_torch import payload_from_numpy
    from brpc_tpu_torch.models.echo import rpc_echo_step
    from brpc_tpu_torch.ops.echo_kernel import echo_fused
    from brpc_tpu_torch.rpc import Channel, Server, zerocopy

    rand = np.random.default_rng(SEED + 1).integers(
        0, 1 << 32, size=MAIN_BYTES // 4, dtype=np.uint32)
    payload = payload_from_numpy(rand, dev)
    want = int(rand.sum(dtype=np.uint64)) & MASK
    out = {"rpc_gbps": {}, "transport": {}}
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    port = srv.start(0)
    try:
        for tr in ("tcp", "shm"):
            ch = Channel(f"127.0.0.1:{port}", timeout_ms=60000,
                         use_shm=tr == "shm")
            try:
                rpc_echo_step(ch, payload)  # connect + warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(RPC_CALLS):
                    back, sent, got = rpc_echo_step(ch, payload)
                    check(u32(sent) == want and u32(got) == want,
                          f"{tr}: echoed checksum {u32(got)} != {want}")
                    check(torch.equal(back.view(torch.int32),
                                      payload.view(torch.int32)),
                          f"{tr}: echoed tensor differs")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                out["transport"][tr] = ch.transport
                out["rpc_gbps"][tr] = MAIN_BYTES * RPC_CALLS / secs / 1e9
            finally:
                ch.close()
            log(f"rpc {tr} ({out['transport'][tr]}): {RPC_CALLS} x 64 MiB "
                f"device->wire->device verified on device, "
                f"{out['rpc_gbps'][tr]} GB/s")
    finally:
        srv.close()

    # The ici leg: the fused pass's copy lands in a CUDA-registered staging
    # slab with one D2H DMA, rides the ici rings as sender-owned
    # descriptors, and the echoed bytes are verified back on the device.
    resp, sent = echo_fused(payload)
    slab = zerocopy.alloc_staging(MAIN_BYTES, device=dev)
    try:
        zerocopy.land(slab, resp)  # warm
        land_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            zerocopy.land(slab, resp)
            land_s.append(time.perf_counter() - t0)
        out["d2h_land_gbps"] = MAIN_BYTES / sorted(land_s)[2] / 1e9
        echoed = torch.empty(MAIN_BYTES, dtype=torch.uint8, pin_memory=True)
        wrs0, b0 = zerocopy.zero_copy_counters()
        gbps, used = zerocopy.bench_echo(slab, "ici", RPC_CALLS, echoed)
        wrs1, b1 = zerocopy.zero_copy_counters()
    finally:
        zerocopy.free_staging(slab)
    back = echoed.view(torch.int32).to(dev).view(torch.uint32)
    _, got = echo_fused(back)
    out["rpc_gbps"]["ici"] = gbps
    out["transport"]["ici"] = used
    out["ici_zero_copy"] = {
        "wrs": wrs1 - wrs0, "bytes": b1 - b0,
        "payload_covered": (b1 - b0) >= MAIN_BYTES * RPC_CALLS}
    out["roundtrip_verified"] = (
        u32(got) == u32(sent) == want
        and torch.equal(back.view(torch.int32), payload.view(torch.int32)))
    check(used == "ici_ring", f"ici leg rode {used!r}")
    check(out["ici_zero_copy"]["payload_covered"],
          f"ici zero-copy bytes {b1 - b0} do not cover the payload")
    check(out["roundtrip_verified"], "ici round trip not verified on device")
    log(f"rpc ici ({used}): payload_covered, roundtrip_verified, "
        f"{gbps} GB/s; D2H landing into the registered slab "
        f"{out['d2h_land_gbps']} GB/s")
    return out


def phase_timing(dev, card: str, log) -> dict:
    import torch

    from brpc_tpu_torch.ops.echo_kernel import echo_fused, echo_reference
    from brpc_tpu_torch.ops.roofline import hbm_peak_gbps

    lanes = MAIN_BYTES // 4
    p = torch.arange(lanes, dtype=torch.int32, device=dev).view(torch.uint32)
    pi = p.view(torch.int32)
    name = torch.cuda.get_device_name(0)
    peak = hbm_peak_gbps(name)
    bytes_moved = 2 * MAIN_BYTES  # each lane read once, written once
    ops_ms = lanes / INT32_ADDS_PER_S * 1e3
    if peak is None:  # no published rate for this card: no bound
        log(f"K1 bound: not computed, {name!r} is not in ops/roofline.py")
        bound_ms = bound_by = None
    else:
        bytes_ms = bytes_moved / (peak * 1e9) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"

    def yardstick():  # PyTorch calls for the same function: copy + sum
        return pi.clone(), torch.sum(pi, dtype=torch.int64) & MASK

    t = {}
    # Turns (plain, kernel, kernel, plain) on one card; mean of the turns.
    for key, fn in (("plain_ms", lambda: echo_reference(p)),
                    ("ms", lambda: echo_fused(p)),
                    ("yardstick_ms", yardstick),
                    ("ms", lambda: echo_fused(p)),
                    ("plain_ms", lambda: echo_reference(p)),
                    ("yardstick_ms", yardstick)):
        t.setdefault(key, []).append(cuda_ms(fn, iters=50))
    t = {k: sum(v) / len(v) for k, v in t.items()}
    out = {"card": card, "device_name": name, "bytes": MAIN_BYTES,
           "ms": t["ms"], "plain_ms": t["plain_ms"],
           "yardstick_ms": t["yardstick_ms"],
           "yardstick": "clone() + torch.sum(dtype=int64) & mask (two calls)",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "hbm_peak_gbps": peak,
           "hbm_frac": bound_ms / t["ms"] if bound_ms else None,
           "kernel_gbps": bytes_moved / (t["ms"] * 1e-3) / 1e9}
    log(f"K1 64 MiB [{card}]: {t['ms']} ms, bound {bound_ms} ms "
        f"({bound_by}, {peak} GB/s from ops/roofline.py), hbm_frac "
        f"{out['hbm_frac']}; plain {t['plain_ms']} ms; yardstick "
        f"{t['yardstick_ms']} ms ({out['yardstick']})")
    return out


def run(out_path: str | None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Modules of this checkout, wherever the script is started from.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import WRAPPER

    def log(msg: str) -> None:
        print(msg, flush=True)

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build(log)
    max_err = phase_kernel_vs_plain(dev, log)
    phase_step(dev, log)

    _kernels.reset_launches()
    main = phase_main_path(dev, log)
    launches = dict(_kernels.launches)
    check(launches.get(WRAPPER, 0) > 0,
          f"main path launched {WRAPPER} no time")
    log(f"main path launches: {launches}")

    timing = phase_timing(dev, card, log)
    timing_line = dict(timing, rpc_gbps=main["rpc_gbps"],
                       transport=main["transport"],
                       d2h_land_gbps=main["d2h_land_gbps"],
                       ici_zero_copy=main["ici_zero_copy"],
                       roundtrip_verified=main["roundtrip_verified"],
                       wall_s=time.perf_counter() - t0)
    log("timing: " + json.dumps(timing_line))
    kernels = {"kernels": [{
        "name": WRAPPER, "route": "cuda",
        "source": "brpc_tpu_torch/csrc/echo_kernel.cu",
        "replaces": "brpc_tpu/ops/echo_kernel.py:26",
        "launches": launches[WRAPPER], "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"timing": timing_line, **kernels}, f, indent=1)
    log(json.dumps(kernels))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results here as JSON")
    args = ap.parse_args()
    # The run drives one card; show torch only that one (the first visible),
    # so the device count it reports is the count it used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if visible is None else visible.split(",")[0])
    try:
        return run(args.out)
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
