#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (brpc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

From the root of a checkout it:

1. builds every kernel of the port (nvcc, sm_90a) and the native runtime
   (build/libtpurpc.so) from the sources, in parallel, and prints each
   build time and the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card,
   bit-exact, at the main path's sizes (1 KiB under the batch path's
   (1, 256) tile, 1, 16 and 64 MiB; arange, seeded random and
   all-0xFFFFFFFF payloads), plus its error contract;
3. runs the single-chip echo step of `graft_entry.entry()` and at 64 MiB;
4. drives the main path — the 64 MiB echo data plane, device → RPC stack →
   device, verified on the device — over tcp, shm and the ici staging leg
   from a CUDA-registered slab, with every kernel launch count reset just
   before and read just after;
5. times each kernel at 64 MiB with CUDA events beside its bound, its plain
   version and PyTorch calls for the same function, and the D2H landing
   and RPC rates;
6. holds the all-gather kernel (K2) against its plain version on the card,
   every peer's copy, bit-exact, at n = 2, 4, 8 (f32 arange, seeded random
   bits with NaN patterns, bf16; 30-byte bf16 chunks, uint8 chunks at odd
   byte offsets, and a (n*3, 5) bf16 global through the fabric), plus its
   error contract and an exact launch count;
7. drives the multi-device path over n = 8 logical peers on the card at the
   reference's headline size (the rdma_performance 64 MiB N-to-N
   exchange), with every launch count reset just before and read just
   after: the N-to-N exchange, K2 on 8 MiB chunks through the fabric, the
   full data-plane step on the 2x4 mesh, the stream echo, causal ring
   attention in f32 and bf16 against full attention, and the port's
   dryrun_multichip(8);
8. times K2 at its main-path shape the way K1 is timed, beside the faster
   of two PyTorch calls for the same gather;
9. drives the pipelined RPC plane from device tensors (`EchoPipeline`,
   `rpc_batch_echo_step` over the batch pipeline), with every launch count
   reset just before and read just after: a 64 MiB payload at depth 8 over
   pooled tcp landing in pinned tensors and over shm landing in
   CUDA-registered RmaBuffers (stamped rma or copy), and a 1 KiB payload
   at depth 256 over one connection; one warm window, then ~1 s of the
   windowed refill loop, each sent checksum held bit-exact against the
   plain version's and every landed response checksummed on the card by
   K1; then the request pins drain to 0, an exhausted deadline_scope raises
   DeadlineExpiredError, and an inference server streams 4 prompts to EOS.

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
PEERS = 8                  # logical peers of the multi-device path
NTON_LANES = 2 * MIB       # uint32 lanes per (peer, destination) row block
RING_CHUNK = (16384, 128)  # f32 rows, cols of each peer's K2 chunk: 8 MiB
STEP_PAYLOAD = (16384, 1024)  # f32 payload of the data-plane step: 64 MiB
STREAM_CHUNKS = 16         # stream echo: chunks of 4 MiB per peer
STREAM_LANES = MIB         # uint32 lanes per peer per chunk
ATTN = (8, 8192, 128)      # ring attention: batch*heads, seq, head_dim
BATCH_DEPTH = 8            # 64 MiB calls in flight on the batch legs
SMALL_BYTES = 1024         # the 1 KiB batch leg (bench.py:183-184) ...
SMALL_DEPTH = 256          # ... at depth 256
BATCH_SECONDS = 1.0        # the windowed refill loop of each batch leg
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
    from brpc_tpu_torch.ops.ring_kernel import KERNEL as RING_KERNEL
    from brpc_tpu_torch.rpc import _lib

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        return name, time.perf_counter() - t0, out

    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = [pool.submit(timed, f"kernel {name}",
                            lambda name=name: _kernels.build(name))
                for name in (KERNEL, RING_KERNEL)]
        futs.append(pool.submit(timed, "libtpurpc.so", _lib.ensure_built))
        results = [f.result() for f in futs]
    for name, secs, out in results:
        log(f"build {name}: {secs:.3f} s")
        if name.startswith("kernel"):
            for line in ptxas_lines(out.with_name(out.name + ".log")):
                log(f"  ptxas: {line}")


def ptxas_lines(path) -> list:
    """One line per kernel function of a `-Xptxas -v` report: its
    registers, static shared memory and spills."""
    lines, fn, spill = [], None, ""
    for line in path.read_text().splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spill = line
        elif "registers" in line and fn:
            lines.append(f"{fn}: {line.split(':', 1)[1].strip()}; {spill}")
            fn, spill = None, ""
    return lines


def phase_kernel_vs_plain(dev, log) -> int:
    """K1 against echo_reference on the card; returns the max abs error."""
    import torch

    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import (WRAPPER, echo_fused,
                                                echo_reference)

    max_err = 0
    shapes = [(SMALL_BYTES, (1, SMALL_BYTES // 4))] + [
        (mib * MIB, (16, 8192)) for mib in SIZES_MIB]
    for nbytes, tile in shapes:
        size = f"{nbytes // MIB} MiB" if nbytes >= MIB else f"{nbytes} B"
        for kind, p, want in payloads(nbytes // 4, dev):
            copy, csum = echo_fused(p, *tile)
            ref_copy, ref_sum = echo_reference(p)
            torch.cuda.synchronize()
            diff = (copy.view(torch.int32).to(torch.int64) & MASK) - (
                ref_copy.view(torch.int32).to(torch.int64) & MASK)
            err = max(int(diff.abs().max()), abs(u32(csum) - u32(ref_sum)))
            max_err = max(max_err, err)
            check(err == 0, f"K1 != plain at {size} {kind} (err {err})")
            check(u32(csum) == want,
                  f"K1 checksum {u32(csum)} != {want} at {size} {kind}")
            log(f"K1 vs plain {size:>6} tile {tile} {kind:<8}: bit-exact, "
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


def _int_bits(t):
    """A tensor's elements as int64 values of their raw bits (so NaN
    payloads compare bit for bit)."""
    import torch

    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return t.contiguous().view(width[t.element_size()]).to(torch.int64)


def _ring_cases(n: int, dev):
    """(kind, per-peer chunks) for K2's check: f32 arange, seeded random
    bits read as f32 (NaN patterns included), bf16 from a seeded normal."""
    import numpy as np
    import torch

    rows, cols = RING_CHUNK
    size = rows * cols
    yield "f32_arange", [
        torch.arange(r * size, (r + 1) * size, dtype=torch.float32,
                     device=dev).view(rows, cols) for r in range(n)]
    rng = np.random.default_rng(SEED + n)
    yield "f32_random_bits", [
        torch.from_numpy(rng.integers(0, 1 << 32, size=(rows, cols),
                                      dtype=np.uint32).view(np.int32)).to(
            dev).view(torch.float32) for _ in range(n)]
    yield "bf16", [
        torch.from_numpy(rng.standard_normal((rows, 2 * cols)).astype(
            np.float32)).to(dev).to(torch.bfloat16) for _ in range(n)]


def _ring_ragged_cases(n: int, dev):
    """(kind, per-peer chunks) of sizes and offsets that are not 16-byte
    multiples: separate (3, 5) bf16 chunks (30 bytes), and uint8 chunks of
    64 KiB + 1 bytes narrowed out of one buffer from byte 1 on (odd
    offsets, 1-byte copies, several tiles a chunk)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 10 + n)
    yield "bf16_30_bytes", [
        torch.from_numpy(rng.integers(-1 << 15, 1 << 15, size=(3, 5),
                                      dtype=np.int16)).to(dev).view(
            torch.bfloat16) for _ in range(n)]
    size = 64 * 1024 + 1
    buf = torch.from_numpy(rng.integers(0, 256, size=1 + n * size,
                                        dtype=np.uint8)).to(dev)
    yield "u8_odd_offset", [buf.narrow(0, 1 + r * size, size)
                            for r in range(n)]


def phase_ring_vs_plain(dev, log) -> int:
    """K2 against its plain version on the card, every peer's copy;
    returns the max abs error (of the raw bits)."""
    import numpy as np
    import torch

    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.ring_kernel import (WRAPPER, plan_gather,
                                                ring_all_gather,
                                                ring_all_gather_kernel,
                                                ring_all_gather_plain,
                                                ring_all_gather_reference)
    from brpc_tpu_torch.parallel import Fabric

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = 0
    for n in (2, 4, 8):
        cases = [*_ring_cases(n, dev), *_ring_ragged_cases(n, dev)]
        for kind, chunks in cases:
            got = ring_all_gather(chunks)
            want = ring_all_gather_plain(chunks)
            whole = torch.cat([_int_bits(c) for c in chunks])
            for peer, (g, w) in enumerate(zip(got, want)):
                err = int((_int_bits(g) - _int_bits(w)).abs().max())
                max_err = max(max_err, err)
                check(err == 0, f"K2 != plain at n={n} {kind} peer {peer}")
                check(torch.equal(_int_bits(g), whole),
                      f"K2 peer {peer} is not the gather at n={n} {kind}")
            plan = plan_gather(chunks[0].numel() * chunks[0].element_size(),
                               n, [c.data_ptr() for c in chunks], sms)
            log(f"K2 vs plain n={n} {kind:<15}: every peer bit-exact "
                f"(width {plan.width}, tile {plan.tile_bytes} B, "
                f"{plan.units} units on {plan.grid} CTAs)")
        # A (n*3, 5) bf16 global through the fabric: chunk r is a view at
        # byte 30*r, so most chunks are not even 4-byte aligned.
        ring = Fabric.auto((n,), ("link",), devices=dev)
        bits = np.random.default_rng(SEED + 20 + n).integers(
            -1 << 15, 1 << 15, size=(n * 3, 5), dtype=np.int16)
        global_ = torch.from_numpy(bits).to(dev).view(torch.bfloat16)
        got = ring_all_gather_kernel(ring, "link")(global_)
        want = ring_all_gather_reference(ring, "link")(global_)
        check(torch.equal(_int_bits(got), _int_bits(want))
              and torch.equal(_int_bits(got), _int_bits(global_)),
              f"K2 via the fabric on a ({n * 3}, 5) bf16 global")
        log(f"K2 via Fabric.spmd n={n} ({n * 3}, 5) bf16: bit-exact against "
            "the all_gather reference")
    bad = [torch.zeros((3, 5), dtype=torch.bfloat16, device=dev)]
    for what, fn in (
            ("one peer", lambda: ring_all_gather(bad)),
            ("65 peers", lambda: ring_all_gather(bad * 65)),
            ("2-D mesh", lambda: ring_all_gather_kernel(
                Fabric.auto((2, 4), ("dp", "link"), devices=dev), "link"))):
        try:
            fn()
        except RuntimeError:
            pass
        else:
            raise SmokeError(f"K2 with {what} did not raise RuntimeError")
    _kernels.reset_launches()
    chunks = [torch.zeros((8, 128), device=dev) for _ in range(4)]
    for _ in range(3):
        ring_all_gather(chunks)
    ring_all_gather_plain(chunks)
    check(_kernels.launches[WRAPPER] == 3,
          f"K2 launch counter {_kernels.launches[WRAPPER]} != 3")
    torch.cuda.synchronize()
    log("K2 contract: RuntimeError for one peer, 65 peers and a 2-D mesh, "
        "launch counter exact")
    return max_err


def _u32_np(t):
    import numpy as np
    import torch

    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def phase_multi_device(dev, log) -> dict:
    """The multi-device path over PEERS logical peers at full width."""
    import numpy as np
    import torch

    from brpc_tpu_torch import tensor_from_numpy
    from brpc_tpu_torch.graft_entry import dryrun_multichip
    from brpc_tpu_torch.models.echo import (make_full_dataplane_step,
                                            make_nton_exchange)
    from brpc_tpu_torch.models.ring_attention import (attention_reference,
                                                      ring_attention)
    from brpc_tpu_torch.ops.ring_kernel import (ring_all_gather_kernel,
                                                ring_all_gather_reference)
    from brpc_tpu_torch.parallel import Fabric
    from brpc_tpu_torch.streaming import stream_echo

    n = PEERS
    out = {}
    ring = Fabric.auto((n,), ("link",), devices=dev)
    rng = np.random.default_rng(SEED + 2)

    # N-to-N exchange: (n, 2 Mi) uint32 per peer, 64 MiB, 512 MiB in all.
    rows = rng.integers(0, 1 << 32, size=(n * n, NTON_LANES), dtype=np.uint32)
    local = tensor_from_numpy(rows, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recv, sums = make_nton_exchange(ring, "link")(local)
    torch.cuda.synchronize()
    out["nton_s"] = time.perf_counter() - t0
    want = rows.reshape(n, n, NTON_LANES).transpose(1, 0, 2).reshape(
        n * n, NTON_LANES)
    check(np.array_equal(_u32_np(recv), want), "N-to-N received blocks")
    per_peer = want.reshape(n, -1).sum(axis=1, dtype=np.uint64) % (1 << 32)
    check(np.array_equal(_u32_np(sums), per_peer.astype(np.uint32)),
          "N-to-N per-peer sum32")
    del recv, local, rows, want
    log(f"N-to-N exchange: {n} peers x 64 MiB, blocks and sum32 match "
        f"numpy, {out['nton_s']} s")

    # K2 through the fabric: an 8 MiB chunk per peer, 64 MiB gathered.
    chunks = tensor_from_numpy(rng.standard_normal(
        (n * RING_CHUNK[0], RING_CHUNK[1])).astype(np.float32), dev)
    got = ring_all_gather_kernel(ring, "link")(chunks)
    want = ring_all_gather_reference(ring, "link")(chunks)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and torch.equal(got, chunks), "K2 through the fabric")
    log(f"K2 via Fabric.spmd: {n} x 8 MiB -> 64 MiB gathered, bit-exact "
        "against the all_gather reference")

    # The full data-plane step on the 2x4 mesh, 64 MiB f32 payload.
    mesh = Fabric.auto((2, n // 2), ("dp", "link"), devices=dev)
    payload = torch.from_numpy(rng.integers(0, 4, size=STEP_PAYLOAD).astype(
        np.float32)).to(dev)
    resp, csum = make_full_dataplane_step(mesh, "dp", "link")(payload)
    check(torch.equal(resp, payload * 3.0), "step response != 3 x payload")
    exact = 3.0 * float(payload.double().sum())
    check(abs(float(csum[0]) - exact) <= 1e-5 * exact,
          f"step checksum {float(csum[0])} vs {exact}")
    del resp, payload
    log("full data-plane step (2x4, 64 MiB f32): response = 3 x payload, "
        f"checksum {float(csum[0])} within 1e-5 of {exact}")

    # Stream echo: 16 chunks of 4 MiB per peer.
    chunks = rng.integers(0, 1 << 32, size=(STREAM_CHUNKS, n * STREAM_LANES),
                          dtype=np.uint32)
    totals, per_chunk = stream_echo(ring, "link", STREAM_CHUNKS)(
        tensor_from_numpy(chunks, dev),
        torch.zeros(n, dtype=torch.int32, device=dev).view(torch.uint32))
    sent = chunks.reshape(STREAM_CHUNKS, n, STREAM_LANES).sum(
        axis=2, dtype=np.uint64) % (1 << 32)
    arrived = np.roll(sent, 1, axis=1).astype(np.uint32)  # from the left
    check(np.array_equal(_u32_np(per_chunk), arrived),
          "stream echo per-chunk sums")
    check(np.array_equal(_u32_np(totals), (arrived.astype(np.uint64).sum(
        axis=0) % (1 << 32)).astype(np.uint32)), "stream echo totals")
    log(f"stream echo: {STREAM_CHUNKS} x 4 MiB per peer, per-chunk sums and "
        "totals match numpy")

    # Causal ring attention against full attention, f32 and bf16.
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 tolerance needs it
    out["attention_max_err"] = {}
    q, k, v = (torch.from_numpy(rng.standard_normal(ATTN).astype(
        np.float32)).to(dev) for _ in range(3))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        got = ring_attention(ring, "link", causal=True)(qq, kk, vv)
        want = attention_reference(causal=True)(qq, kk, vv)
        err = float((got.float() - want.float()).abs().max())
        out["attention_max_err"][str(dtype)] = err
        check(bool(torch.isfinite(got).all()) and got.shape == qq.shape,
              f"ring attention {dtype} output")
        check(bool(torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol)),
              f"ring attention {dtype} max err {err} beyond {tol}")
        log(f"ring attention causal {tuple(ATTN)} {dtype}: max err {err} "
            f"(tolerance {tol})")
        del got, want
    dryrun_multichip(n, device=dev)
    log(f"dryrun_multichip({n}) on the card: every leg checked")
    torch.cuda.synchronize()
    return out


def phase_ring_timing(dev, card: str, log) -> dict:
    import torch

    from brpc_tpu_torch.ops.ring_kernel import (ring_all_gather,
                                                ring_all_gather_plain)
    from brpc_tpu_torch.ops.roofline import hbm_peak_gbps

    n = PEERS
    rows, cols = RING_CHUNK
    chunks = [torch.randn(rows, cols, device=dev) for _ in range(n)]
    stacked = torch.stack(chunks)
    chunk_bytes = rows * cols * 4
    need = (n + n * n) * chunk_bytes  # read n chunks, write n outputs
    peak = hbm_peak_gbps(torch.cuda.get_device_name(0))
    bound_ms = None if peak is None else need / (peak * 1e9) * 1e3
    flat = stacked.view(1, n * rows, cols)
    # One PyTorch call each for the same function; the faster is the
    # yardstick.
    libraries = {
        "stacked.view(1, n*rows, cols).repeat(n, 1, 1)":
            lambda: flat.repeat(n, 1, 1),
        "stacked.view(1, n*rows, cols).expand(n, -1, -1).contiguous()":
            lambda: flat.expand(n, -1, -1).contiguous(),
    }
    turns = [("plain_ms", lambda: ring_all_gather_plain(chunks), 10),
             ("ms", lambda: ring_all_gather(chunks), 20),
             *((name, fn, 20) for name, fn in libraries.items()),
             ("ms", lambda: ring_all_gather(chunks), 20),
             ("plain_ms", lambda: ring_all_gather_plain(chunks), 10),
             *((name, fn, 20) for name, fn in reversed(libraries.items()))]
    t = {}
    for key, fn, iters in turns:
        t.setdefault(key, []).append(cuda_ms(fn, iters=iters))
    t = {k: sum(v) / len(v) for k, v in t.items()}
    library = min(libraries, key=t.get)
    out = {"card": card, "peers": n, "chunk_bytes": chunk_bytes,
           "ms": t["ms"], "plain_ms": t["plain_ms"],
           "library_ms": t[library], "library": library,
           "library_calls_ms": {name: t[name] for name in libraries},
           "bound_ms": bound_ms, "bound_by": "bytes", "bound_bytes": need,
           "hbm_frac": bound_ms / t["ms"] if bound_ms else None,
           "kernel_gbps": need / (t["ms"] * 1e-3) / 1e9}
    log(f"K2 n={n} x 8 MiB [{card}]: {t['ms']} ms, bound {bound_ms} ms "
        f"(bytes, (n+n^2)C); hbm_frac {out['hbm_frac']}; plain "
        f"{t['plain_ms']} ms; library {t[library]} ms ({library}); "
        f"library calls {out['library_calls_ms']}")
    return out


def observe_snapshot() -> dict:
    """The attribution vars of bench.py's batch rows (bench.py:360-393),
    read through the port's observe module; absent ones are left out."""
    from brpc_tpu_torch.rpc import observe

    v = observe.Vars.dump()
    out = {}
    if v.get("socket_inline_write_attempts"):
        out["inline_write_ratio"] = (v.get("socket_inline_write_hits", 0)
                                     / v["socket_inline_write_attempts"])
    for var, key, field in (
            ("messenger_dispatch_batch", "dispatch_batch_p50", "p50_us"),
            ("rpc_server_Echo.Echo", "server_echo_p99_us", "p99_us"),
            ("rpc_client_batch", "client_batch_p99_us", "p99_us")):
        try:
            out[key] = getattr(observe.Latency.read(var), field)
        except KeyError:
            pass
    for name in ("batch_depth", "batch_inflight"):
        if isinstance(v.get(name), (int, float)):
            out[name] = v[name]
    return out


def _batch_leg(ch, payload, depth: int, bufs, tile) -> dict:
    """One warm window (`rpc_batch_echo_step`), then BATCH_SECONDS of the
    windowed refill loop of bench.py:458-479 (poll k, resubmit k) on an
    EchoPipeline.  Each sent checksum (K1's) is held bit-exact against the
    plain version's on the same payload; every landed response is
    checksummed on the card by K1 against it; the first and last are
    compared whole."""
    import torch

    from brpc_tpu_torch.models.echo import EchoPipeline, rpc_batch_echo_step
    from brpc_tpu_torch.ops.echo_kernel import echo_reference

    def same(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    plain_sum = u32(echo_reference(payload)[1])
    echoed, sent, got = rpc_batch_echo_step(ch, payload, depth, bufs,
                                            rows=tile[0], cols=tile[1])
    check(u32(sent) == plain_sum,
          f"warm window: K1's sent checksum {u32(sent)} != plain {plain_sum}")
    check(len(echoed) == depth, f"warm window: {len(echoed)} of {depth}")
    check(all(u32(g) == u32(sent) for g in got),
          "warm window: an echoed checksum differs from the sent one")
    check(same(echoed[0], payload) and same(echoed[-1], payload),
          "warm window: an echoed tensor differs from the payload")
    del echoed
    pipe = EchoPipeline(ch, payload, bufs, rows=tile[0], cols=tile[1])
    sums, first, last, submits, completed = [], None, None, 1, 0
    try:
        check(u32(pipe.sent) == plain_sum and same(pipe.copy, payload),
              "refill loop: K1's copy or sent checksum differs from plain")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.submit(depth)
        refilling = True
        while pipe.inflight:
            out = pipe.poll(max_n=depth, timeout_ms=60000)
            check(bool(out), "batch leg wedged: no completion in 60 s")
            for back, csum in out:
                sums.append(csum.view(torch.int32))
                first = back if first is None else first
                last = back
            completed += len(out)
            refilling = refilling and (
                time.perf_counter() - t0 < BATCH_SECONDS)
            if refilling:
                pipe.submit(len(out))
                submits += 1
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        pipe.close()
    check(bool((torch.stack(sums) == pipe.sent.view(torch.int32)).all()),
          "refill loop: an echoed checksum differs from the sent one")
    check(same(first, payload) and same(last, payload),
          "refill loop: the first or last echoed tensor differs")
    return {"goodput_gbps": pipe.nbytes * completed / secs / 1e9,
            "calls": completed, "submits": submits, "seconds": secs,
            "depth": depth, "bytes": pipe.nbytes,
            "checked_on_device": completed + depth}


def phase_batch_path(dev, card: str, log) -> dict:
    """The pipelined RPC plane from device tensors: batch legs over tcp,
    shm (RMA landing) and a 1 KiB window, then the pin, deadline and
    inference checks."""
    import numpy as np
    import torch

    from brpc_tpu_torch import payload_from_numpy
    from brpc_tpu_torch.rpc import (Channel, DeadlineExpiredError,
                                    InferClient, RmaBuffer, Server,
                                    deadline_scope, get_flag, observe)
    from brpc_tpu_torch.rpc.batch import pinned_requests

    rng = np.random.default_rng(SEED + 3)
    payload = payload_from_numpy(rng.integers(
        0, 1 << 32, size=MAIN_BYTES // 4, dtype=np.uint32), dev)
    small = payload_from_numpy(rng.integers(
        0, 1 << 32, size=SMALL_BYTES // 4, dtype=np.uint32), dev)
    # The RMA landing buffers and each shm connection's two receive
    # windows live in /dev/shm: fail plainly if they cannot fit there.
    st = os.statvfs("/dev/shm")
    need = BATCH_DEPTH * MAIN_BYTES + 2 * int(
        get_flag("trpc_rma_window_bytes"))
    check(st.f_bavail * st.f_frsize >= need,
          f"/dev/shm has {st.f_bavail * st.f_frsize} bytes free, the shm "
          f"leg needs {need}")
    out = {"card": card, "legs": {}}
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    port = srv.start(0)
    addr = f"127.0.0.1:{port}"
    try:
        # tcp: pooled connections, responses landing in pinned tensors.
        bufs = [torch.empty(MAIN_BYTES, dtype=torch.uint8, pin_memory=True)
                for _ in range(BATCH_DEPTH)]
        ch = Channel(addr, timeout_ms=60000, connection_type="pooled")
        try:
            leg = _batch_leg(ch, payload, BATCH_DEPTH, bufs, (16, 8192))
            leg["transport"] = "tcp, pooled"
        finally:
            ch.close()
        # What the host copies cost beside the window: one D2H of the
        # payload into pinned memory per submit, one H2D per response.
        host = bufs[0]
        d2h_ms = cuda_ms(lambda: host.copy_(payload.view(torch.uint8),
                                            non_blocking=True), iters=10)
        h2d_ms = cuda_ms(lambda: host.to(dev, non_blocking=True), iters=10)
        leg.update(d2h_ms=d2h_ms, h2d_ms=h2d_ms, host_copy_share=(
            leg["submits"] * d2h_ms + leg["calls"] * h2d_ms)
            / (leg["seconds"] * 1e3))
        leg["vars"] = observe_snapshot()
        out["legs"]["tcp"] = leg
        del bufs, host

        # shm: responses landing in CUDA-registered RmaBuffers.
        rma0 = int(observe.Vars.dump().get("rma_rx_msgs", 0))
        lands = [RmaBuffer(MAIN_BYTES, device=dev)
                 for _ in range(BATCH_DEPTH)]
        try:
            check(all(b.cuda_registered for b in lands),
                  "an RmaBuffer is not registered with the CUDA driver")
            ch = Channel(addr, timeout_ms=60000, use_shm=True)
            try:
                leg = _batch_leg(ch, payload, BATCH_DEPTH, lands,
                                 (16, 8192))
                leg["transport"] = ch.transport
            finally:
                ch.close()
        finally:
            for b in lands:
                b.free()
        rma = int(observe.Vars.dump().get("rma_rx_msgs", 0)) - rma0
        leg.update(rma_rx_msgs=rma, path="rma" if rma > 0 else "copy",
                   vars=observe_snapshot())
        out["legs"]["shm"] = leg

        # 1 KiB at depth 256 over one connection, under the (1, 256) tile.
        bufs = [torch.empty(SMALL_BYTES, dtype=torch.uint8, pin_memory=True)
                for _ in range(SMALL_DEPTH)]
        ch = Channel(addr, timeout_ms=60000, connection_type="single")
        try:
            leg = _batch_leg(ch, small, SMALL_DEPTH, bufs,
                             (1, SMALL_BYTES // 4))
            leg["transport"] = ch.transport
        finally:
            ch.close()
        leg["vars"] = observe_snapshot()
        out["legs"]["1kib"] = leg
        del bufs
        for name, leg in out["legs"].items():
            log(f"batch {name} ({leg['transport']}"
                f"{', ' + leg['path'] if 'path' in leg else ''}) [{card}]: "
                f"{leg['calls']} x {leg['bytes']} B at depth {leg['depth']} "
                f"in {leg['seconds']:.3f} s, {leg['goodput_gbps']} GB/s; "
                f"{leg['checked_on_device']} responses checked by K1; "
                f"vars {json.dumps(leg['vars'])}")
        tcp = out["legs"]["tcp"]
        log(f"batch tcp host copies of 64 MiB: D2H {tcp['d2h_ms']} ms, H2D "
            f"{tcp['h2d_ms']} ms, share of the loop "
            f"{tcp['host_copy_share']}")

        deadline = time.monotonic() + 10
        while pinned_requests() and time.monotonic() < deadline:
            time.sleep(0.01)
        out["pinned_requests_after"] = pinned_requests()
        check(out["pinned_requests_after"] == 0,
              f"{pinned_requests()} request pins left after the pipelines "
              "closed")

        ch = Channel(addr, timeout_ms=5000)
        try:
            with deadline_scope(0.001):
                time.sleep(0.005)
                try:
                    ch.call("Echo.Echo", b"late")
                except DeadlineExpiredError as e:
                    out["deadline_code"] = e.code
            check(out.get("deadline_code") == 2007,
                  "a call under an exhausted deadline_scope did not raise "
                  "DeadlineExpiredError")
        finally:
            ch.close()
    finally:
        srv.close()

    srv = Server()
    srv.enable_infer(prefix_cache=False)
    port = srv.start(0)
    ch = Channel(f"127.0.0.1:{port}", timeout_ms=5000)
    try:
        client = InferClient(ch)
        streams = []
        for i in range(4):
            recs = list(client.submit([i * 1000 + j for j in range(8)],
                                      max_new_tokens=16,
                                      timeout_ms=30000).records())
            check(len(recs) == 16 and recs[-1].eos
                  and [r.index for r in recs] == list(range(16)),
                  f"prompt {i}: {len(recs)} token records, no EOS")
            streams.append([r.token for r in recs])
        out["infer_tokens"] = [len(s) for s in streams]
    finally:
        ch.close()
        srv.close()
    log(f"pins drained to 0; deadline_scope -> DeadlineExpiredError "
        f"({out['deadline_code']}); infer: 4 prompts x 16 tokens to EOS")
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
    from brpc_tpu_torch.ops.ring_kernel import WRAPPER as RING_WRAPPER

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
    ring_err = phase_ring_vs_plain(dev, log)

    _kernels.reset_launches()
    multi = phase_multi_device(dev, log)
    ring_launches = dict(_kernels.launches)
    check(ring_launches.get(RING_WRAPPER, 0) > 0,
          f"multi-device path launched {RING_WRAPPER} no time")
    log(f"multi-device path launches: {ring_launches}")

    ring_timing = phase_ring_timing(dev, card, log)

    _kernels.reset_launches()
    batch = phase_batch_path(dev, card, log)
    batch_launches = dict(_kernels.launches)
    check(batch_launches.get(WRAPPER, 0) > 0,
          f"batch path launched {WRAPPER} no time")
    log(f"batch path launches: {batch_launches}")
    timing_line = dict(timing, rpc_gbps=main["rpc_gbps"],
                       transport=main["transport"],
                       d2h_land_gbps=main["d2h_land_gbps"],
                       ici_zero_copy=main["ici_zero_copy"],
                       roundtrip_verified=main["roundtrip_verified"],
                       ring=dict(ring_timing, **multi),
                       batch=batch,
                       wall_s=time.perf_counter() - t0)
    log("timing: " + json.dumps(timing_line))
    kernels = {"kernels": [{
        "name": WRAPPER, "route": "cuda",
        "source": "brpc_tpu_torch/csrc/echo_kernel.cu",
        "replaces": "brpc_tpu/ops/echo_kernel.py:26",
        "launches": launches[WRAPPER] + batch_launches[WRAPPER],
        "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": RING_WRAPPER, "route": "cuda",
        "source": "brpc_tpu_torch/csrc/ring_kernel.cu",
        "replaces": "brpc_tpu/ops/ring_kernel.py:37",
        "launches": ring_launches[RING_WRAPPER], "max_abs_err": ring_err,
        "ms": ring_timing["ms"], "plain_ms": ring_timing["plain_ms"],
        "bound_ms": ring_timing["bound_ms"],
        "bound_by": ring_timing["bound_by"],
        "library_ms": ring_timing["library_ms"]}]}
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
