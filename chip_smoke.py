#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (brpc_tpu_torch) on one GPU (and on
up to four, where the host shows several, for K2 across cards).

    python3 chip_smoke.py [--out results.json]

From the root of a checkout it first lints the port's native boundary
(`python -m brpc_tpu_torch.tools.lint_trpc`: every ctypes binding of
build/libtpurpc.so and of the CUDA kernels against the cpp/capi and csrc/
prototypes, the wire tables against cpp/) and fails on any violation, so
no kernel launches through a binding that disagrees with the source it is
built from.  Then it:

1. builds every kernel of the port (nvcc, sm_90a) and the native runtime
   (build/libtpurpc.so) from the sources, in parallel, and prints each
   build time and the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card,
   bit-exact, at the main path's sizes (1 KiB under the batch path's
   (1, 256) tile, 1, 16 and 64 MiB; arange, seeded random and
   all-0xFFFFFFFF payloads), plus its error contract; then K1 on views at
   1 and 64 MiB (byte offsets 4, 8 and 12 of a larger buffer, stride 2, a
   copy buffer of another 16-byte phase: the ragged path) and on an int16
   payload, each bit-exact in copy and sum and each call one counted
   launch; and sum32/fletcher32 of edge-value f32, f16 and bf16 payloads
   on the card against the reference's constants and the CPU;
3. runs the single-chip echo step of `graft_entry.entry()` and at 64 MiB;
4. drives the main path — the 64 MiB echo data plane, device → RPC stack →
   device, verified on the device — over tcp, shm and the ici staging leg
   from a CUDA-registered slab, with every kernel launch count reset just
   before and read just after;
5. times each kernel at 64 MiB with CUDA events beside its bound, its plain
   version and PyTorch calls for the same function, and the D2H landing
   and RPC rates; K1 also on the card alone on a view at byte offset 4
   (its own phase and the ragged path) and a stride-2 view;
6. holds the all-gather kernel (K2) against its plain version on the card,
   every peer's copy, bit-exact, at n = 2, 4, 8 (f32 arange, seeded random
   bits with NaN patterns, bf16; 30-byte bf16 chunks, uint8 chunks at odd
   byte offsets, and a (n*3, 5) bf16 global through the fabric), plus its
   error contract and an exact launch count; then on the 8 peer streams
   of a fabric: against its plain version, and 10 times with every chunk
   rewritten on its stream behind a delay just before the gather and
   every output compared on its stream just after;
7. drives the multi-device path over n = 8 peers on the card, each on a
   stream of its own (it prints the peer-to-device map and the stream
   count), at the reference's headline size (the rdma_performance 64 MiB
   N-to-N exchange), with every launch count reset just before and read
   just after: the N-to-N exchange, K2 on 8 MiB chunks through the fabric
   (and 10 more seeded gathers), the full data-plane step on the 2x4 mesh,
   the stream echo, causal ring attention in f32 and bf16 against full
   attention, and the port's dryrun_multichip(8) 10 times;
8. times K2 at its main-path shape the way K1 is timed, on one stream and
   on the 8 peer streams, beside the faster of two PyTorch calls for the
   same gather; then drives K2's fenced entry (the cross-card path,
   `ring_all_gather_xcard`) with its launch count reset just before and
   read just after: as n = 2 launches on two streams of this card, and
   with two or more cards visible also one peer on each of up to four,
   every peer bit-exact against the plain version and then 10 times with
   every chunk rewritten behind a delay, a second stream set gathering
   right behind the first with no synchronise between; a refused launch
   raises and, in a child process, a launch whose peer never starts traps
   (the next synchronise raises); then times it (gated marginal, graph
   marginal, events) beside its bound, its plain version and one PyTorch
   call under the same fence (`expand().contiguous()` on one card,
   `torch.cuda.nccl.all_gather` across cards); on one card it says that
   the cross-card check and timing need two cards or more;
9. drives the pipelined RPC plane from device tensors (`EchoPipeline`,
   `rpc_batch_echo_step` over the batch pipeline), with every launch count
   reset just before and read just after: a 64 MiB payload at depth 8 over
   pooled tcp landing in pinned tensors and over shm landing in
   CUDA-registered RmaBuffers (stamped rma or copy), and a 1 KiB payload
   at depth 256 over one connection; one warm window, then ~1 s of the
   windowed refill loop, each sent checksum held bit-exact against the
   plain version's and every landed response checksummed on the card by
   K1; then the request pins drain to 0, an exhausted deadline_scope raises
   DeadlineExpiredError, and an inference server streams 4 prompts to EOS;
10. drives the KV-block plane at tools/kv_disagg.py's sizes, with every
   launch count reset just before and read just after: a seeded 96 MiB
   tensor on the card is staged into a CUDA-registered RmaBuffer, published
   as 12 x 8 MiB blocks and registered; a KvClient over shm fetches each
   into a CUDA-registered landing RmaBuffer (stamped rma or copy) and back
   onto the card, where it must equal its source slice and K1 on it must
   equal the plain version on the source, bit-exact; the first block is
   withdrawn, republished with new bytes and fetched fresh through the
   stale cached record; a prefix round (4 tenants x 6 blocks of 256 KiB) is published
   from CUDA tensors, matched and fetched, every block equal on the card;
   traffic capture is on during the fetches and its dump holds Kv.Fetch
   records;
11. holds the LCG kernel (the pipeline step's producer) bit-exact against
   its plain version on the card, and runs the pipeline-parallel step
   (4 members, 8 microbatches, 256 KiB shards, 2 ms emulated link) with its
   compute on the card, with every launch count reset just before and read
   just after: sequential and overlapped results byte-exact, every member's
   gathered buffers equal to the u32 sum over members of the plain pieces,
   readiness triggers seen, no session or ready map left;
12. probes which CUDA pointers can enter the IOBuf path
   (`tools/cuda_probe.py`, attempts A to E in children of their own) and
   prints each result;
13. sweeps K1's launch geometry (`tools/tune_echo.py`, the short set, the
   default among it): every geometry bit-exact at 1 KiB, 1, 16 and 64 MiB,
   then timed on the card alone (CUDA-graph marginal cost) with its goodput
   and hbm_frac, and the best beside K1's own entry; K1's `ms` in step 5 is
   timed the same host-free way, its old wrapper loop kept as `wrapper_ms`;
14. runs the two-process KV disaggregation workload
   (`python -m brpc_tpu_torch.tools.kv_disagg --json --seconds 2`, 12 x 8
   MiB at depth 4): its row must be verified on the card with K1 launched
   on every landed block, path rma, no failed fetch; the decode process's
   K1 launches (counted from 0 in that process) join the kernels line;
15. runs the port's headline bench (`brpc_tpu_torch.tools.bench`) in this
   process, with every launch count reset just before and read just after:
   the sweep child's rows at 1 KiB .. 64 MiB (K1 from 1 MiB; the batch
   pipeline at 1 KiB, 16 and 64 MiB) and the device-RPC child's 64 MiB
   round trip over ici/shm/tcp; every row must say gpu, K1 rows keep
   hbm_frac <= 1.05, the round trip is verified on the card and the ici
   payload rides sender-owned descriptors.

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
PEERS = 8                  # peers of the multi-device path, on one card
REPEATS = 10               # repetitions of the checks that catch a lost wait
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
# The H100 SXM's 32-bit integer rate: 132 SMs x 64 INT32 lanes (adds and
# multiply-adds alike, one a lane a clock) x 1.98 GHz boost = 16.7e12
# operations/s.  On K1's n adds it never binds (the bytes bound is ~40x
# larger); on the LCG kernel's words x iters multiply-adds it does.
INT32_ADDS_PER_S = 132 * 64 * 1.98e9
PLAIN_CHUNK = 1024         # LCG steps per CUDA graph of the plain loop
KV_BLOCKS = 12             # tools/kv_disagg.py DEFAULTS: 12 blocks ...
KV_BLOCK_BYTES = 8 * MIB   # ... of 8 MiB
PREFIX = {"tenants": 4, "sys_blocks": 4, "tail_blocks": 2,
          "block_tokens": 128, "block_kb": 256}  # its PREFIX_DEFAULTS
VIEW_SIZES_MIB = (1, 64)   # K1 on views: sizes ...
VIEW_OFFSETS = (4, 8, 12)  # ... and byte offsets into a larger buffer
# Edge values of the float-checksum check: in range, fractional, negative,
# the largest f16, the largest f32 below 2^32, 2^32 and above, +-inf, NaN.
FLOAT_EDGES = (0.0, 2.7, -0.5, -1.0, -3.0, 7.5, 65504.0, 4294967040.0,
               2.0 ** 32, 5e9, 1e10, float("inf"), float("-inf"),
               float("nan"))
# sum32 and fletcher32 of FLOAT_EDGES as each type holds them
# (`float_edges`), as brpc_tpu.ops.checksum computes them;
# tests/test_torch_checksum.py derives them from the JAX functions.
FLOAT_CHECKSUMS = {"float32": (65253, (65253, 456484)),
                   "float16": (65508, (65508, 458524)),
                   "bfloat16": (65540, (65540, 458748))}


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


def phase_lint() -> None:
    """The port's bindings and wire tables against cpp/ and csrc/, before
    anything is built or launched; any violation fails the run."""
    from brpc_tpu_torch.tools import lint_trpc

    check(lint_trpc.main() == 0,
          "lint_trpc: the port's bindings disagree with cpp/ or csrc/")


def phase_build(log) -> None:
    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import KERNEL
    from brpc_tpu_torch.ops.lcg import KERNEL as LCG_KERNEL
    from brpc_tpu_torch.ops.ring_kernel import KERNEL as RING_KERNEL
    from brpc_tpu_torch.rpc import _lib

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        return name, time.perf_counter() - t0, out

    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = [pool.submit(timed, f"kernel {name}",
                            lambda name=name: _kernels.build(name))
                for name in (KERNEL, RING_KERNEL, LCG_KERNEL)]
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


def phase_k1_views(dev, log) -> int:
    """K1 on payloads that are views, at VIEW_SIZES_MIB: at byte offsets
    4, 8 and 12 of a larger buffer, with stride 2, and into a copy buffer
    of another 16-byte phase (the ragged path), plus an int16 payload
    (converted like astype(uint32)); each bit-exact against echo_reference
    in copy and sum, and each call one counted K1 launch.  Returns the max
    abs error."""
    import torch

    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.echo_kernel import (WRAPPER, echo_fused,
                                                echo_fused_into,
                                                echo_reference, phase_split)

    def launched(what, fn):
        before = _kernels.launches[WRAPPER]
        out = fn()
        n = _kernels.launches[WRAPPER] - before
        check(n == 1, f"K1 on {what}: {n} counted launches, not 1")
        return out

    def err(what, copy, csum, ref_copy, ref_sum) -> int:
        torch.cuda.synchronize()
        diff = (copy.view(torch.int32).to(torch.int64) & MASK) - (
            ref_copy.view(torch.int32).to(torch.int64) & MASK)
        e = max(int(diff.abs().max()), abs(u32(csum) - u32(ref_sum)))
        check(e == 0, f"K1 != plain on {what} (err {e})")
        log(f"K1 vs plain {what}: bit-exact, one launch, "
            f"sum32={u32(csum)}")
        return e

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(n, dtype=torch.int32, bits=32):
        return torch.randint(-(1 << bits - 1), 1 << bits - 1, (n,),
                             dtype=dtype, device=dev, generator=gen)

    max_err = 0
    for mib in VIEW_SIZES_MIB:
        lanes = mib * MIB // 4
        big = rand(lanes + 4)
        views = [(f"{mib} MiB at byte offset {off}",
                  big[off // 4:off // 4 + lanes].view(torch.uint32))
                 for off in VIEW_OFFSETS]
        views.append((f"{mib} MiB stride 2",
                      rand(2 * lanes)[::2].view(torch.uint32)))
        for what, p in views:
            copy, csum = launched(what, lambda p=p: echo_fused(p))
            if p.is_contiguous():
                check(phase_split(p.data_ptr(), copy.data_ptr(), lanes)
                      is not None, f"{what}: copy not in the payload's phase")
            max_err = max(max_err, err(what, copy, csum, *echo_reference(p)))
        # The ragged path: the caller's copy in another 16-byte phase.
        buf = torch.empty(lanes + 4, dtype=torch.int32, device=dev)
        for what, p, copy in (
                (f"{mib} MiB offset 4 into a phase-0 copy", views[0][1],
                 buf[:lanes]),
                (f"{mib} MiB offset 0 into a phase-8 copy",
                 big[:lanes].view(torch.uint32), buf[2:2 + lanes])):
            check(phase_split(p.data_ptr(), copy.data_ptr(), lanes) is None,
                  f"{what}: not the ragged path")
            acc = torch.zeros(1, dtype=torch.int32, device=dev)
            launched(what, lambda p=p, copy=copy, acc=acc:
                     echo_fused_into(p, copy, acc))
            max_err = max(max_err, err(what, copy, acc[0],
                                       *echo_reference(p)))
    x = rand(MIB // 4, torch.int16, 16)
    copy, csum = launched("1 MiB int16", lambda: echo_fused(x))
    max_err = max(max_err, err("1 MiB int16", copy, csum, *echo_reference(
        x.to(torch.int32).view(torch.uint32))))
    return max_err


def float_edges(name: str, dev):
    """FLOAT_EDGES as a flat tensor of the float type `name` on dev."""
    import torch

    return torch.tensor(FLOAT_EDGES, dtype=torch.float64).to(
        getattr(torch, name)).to(dev)


def phase_float_checksums(dev, log) -> None:
    """sum32 and fletcher32 of the float edge payloads on the card: equal
    to FLOAT_CHECKSUMS (the reference's) and to the port's CPU results."""
    import torch

    from brpc_tpu_torch.ops.checksum import fletcher32, sum32

    def both(p):
        lanes = fletcher32(p).view(torch.int32).tolist()
        return u32(sum32(p)), tuple(v & MASK for v in lanes)

    for name, want in FLOAT_CHECKSUMS.items():
        p = float_edges(name, dev)
        got, cpu = both(p), both(p.cpu())
        check(got == want == cpu, f"{name} edge checksums: card {got}, "
              f"CPU {cpu}, reference {want}")
        log(f"float checksums {name}: sum32, fletcher32 = {got} on the "
            f"card, the CPU and the reference")


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

    from brpc_tpu_torch.ops.echo_kernel import (echo_fused, echo_fused_into,
                                                echo_reference, phase_split)
    from brpc_tpu_torch.ops.roofline import hbm_peak_gbps
    from brpc_tpu_torch.tools.tune_echo import CHAIN, device_ms, time_k1

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

    def host_free():  # K1 alone: a CUDA-graph marginal, no host work
        ms = time_k1(dev)
        check(ms is not None, "K1's longer graph was not slower")
        return ms

    # K1 alone on views: the payload at byte offset 4 into a copy in its
    # phase (3 head lanes, then the uint4 body) and into an aligned copy
    # (the ragged path); a stride-2 payload (made contiguous first).
    p4 = torch.arange(lanes + 1, dtype=torch.int32,
                      device=dev)[1:].view(torch.uint32)
    buf = torch.empty(lanes + 1, dtype=torch.int32, device=dev)
    strided = torch.arange(2 * lanes, dtype=torch.int32,
                           device=dev)[::2].view(torch.uint32)
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    views = {"phase4_ms": (p4, buf[1:]), "ragged_ms": (p4, buf[:lanes]),
             "strided_ms": (strided, buf[:lanes])}
    check(phase_split(p4.data_ptr(), buf[1:].data_ptr(), lanes) is not None
          and phase_split(p4.data_ptr(), buf.data_ptr(), lanes) is None,
          "the timed views do not take the paths they are named for")

    def view_ms(key):
        payload, copy = views[key]
        ms = device_ms(lambda: echo_fused_into(payload, copy, acc))
        check(ms is not None, f"K1 {key}: the longer graph was not slower")
        return ms

    t = {}
    # Turns on one card; mean of the turns.  `ms` is K1 timed on the card
    # alone; `wrapper_ms` the old loop of 50 `echo_fused` calls, each
    # with its two allocations, fill and ctypes launch.
    for key, fn in (("ms", None), ("phase4_ms", None), ("ragged_ms", None),
                    ("strided_ms", None),
                    ("plain_ms", lambda: echo_reference(p)),
                    ("wrapper_ms", lambda: echo_fused(p)),
                    ("yardstick_ms", yardstick), ("strided_ms", None),
                    ("ragged_ms", None), ("phase4_ms", None), ("ms", None),
                    ("wrapper_ms", lambda: echo_fused(p)),
                    ("plain_ms", lambda: echo_reference(p)),
                    ("yardstick_ms", yardstick)):
        if fn is not None:
            ms = cuda_ms(fn, iters=50)
        else:
            ms = host_free() if key == "ms" else view_ms(key)
        t.setdefault(key, []).append(ms)
    t = {k: sum(v) / len(v) for k, v in t.items()}
    out = {"card": card, "device_name": name, "bytes": MAIN_BYTES,
           "ms": t["ms"], "wrapper_ms": t["wrapper_ms"],
           "ms_method": (f"CUDA graphs of {CHAIN[1]} and {CHAIN[0]} "
                         "launches on preallocated buffers, marginal"),
           "plain_ms": t["plain_ms"],
           "yardstick_ms": t["yardstick_ms"],
           "yardstick": "clone() + torch.sum(dtype=int64) & mask (two calls)",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "hbm_peak_gbps": peak,
           "hbm_frac": bound_ms / t["ms"] if bound_ms else None,
           "kernel_gbps": bytes_moved / (t["ms"] * 1e-3) / 1e9}
    for key in views:
        out[key] = t[key]
        out[key.replace("_ms", "_frac")] = (bound_ms / t[key] if bound_ms
                                            else None)
    log(f"K1 64 MiB [{card}]: {t['ms']} ms on the card alone "
        f"({out['ms_method']}), wrapper_ms {t['wrapper_ms']}; bound "
        f"{bound_ms} ms ({bound_by}, {peak} GB/s from ops/roofline.py), "
        f"hbm_frac {out['hbm_frac']}; plain {t['plain_ms']} ms; yardstick "
        f"{t['yardstick_ms']} ms ({out['yardstick']})")
    log(f"K1 64 MiB views on the card alone [{card}]: phase-4 view "
        f"{t['phase4_ms']} ms (frac {out['phase4_frac']}), ragged path "
        f"{t['ragged_ms']} ms (frac {out['ragged_frac']}), stride-2 view "
        f"{t['strided_ms']} ms incl. its contiguous() pass (frac "
        f"{out['strided_frac']}); aligned {t['ms']} ms (frac "
        f"{out['hbm_frac']})")
    return out


def phase_tune_echo(dev, card: str, log) -> dict:
    """K1's launch-geometry sweep over the short set: every geometry
    bit-exact at the four sizes, then timed on the card alone."""
    from brpc_tpu_torch.tools import tune_echo

    out = tune_echo.sweep(tune_echo.QUICK, dev,
                          log=lambda row: log(f"  geometry {row}"))
    check(not out["failed"], f"geometries failed: {out['failed']}")
    check(all(r["goodput_gbps"] for r in out["rows"]),
          "a geometry was not timed")
    default = next(r for r in out["rows"] if r["default"])
    best, k1 = out["best"], out["k1_default"]
    log(f"tune_echo [{card}]: {len(out['rows'])} geometries exact at "
        f"{tune_echo.SIZES} bytes; best (threads, unroll, blocks/SM) = "
        f"({best['threads']}, {best['unroll']}, {best['blocks_per_sm']}) "
        f"{best['goodput_gbps']} GB/s, hbm_frac {best['hbm_frac']}; the "
        f"default through the geometry entry {default['goodput_gbps']} "
        f"GB/s, K1's own entry {k1['goodput_gbps']} GB/s "
        f"({k1['ms']} ms, hbm_frac {k1['hbm_frac']})")
    return {"rows": [[r["threads"], r["unroll"], r["blocks_per_sm"],
                      r["ms"], r["goodput_gbps"], r["hbm_frac"]]
                     for r in out["rows"]],
            "row_keys": ["threads", "unroll", "blocks_per_sm", "ms",
                         "goodput_gbps", "hbm_frac"],
            "best": best, "k1_default": k1}


def phase_cuda_probe(log) -> dict:
    """Which CUDA pointers enter the IOBuf path: attempts A to E on the
    card, each in a child of its own."""
    from brpc_tpu_torch.tools import cuda_probe

    out = cuda_probe.probe("cuda")
    for name, res in out["attempts"].items():
        log(f"  cuda_probe {name}: {json.dumps(res)}")
        check("timeout" not in res.get("error", "")
              and "no result" not in res.get("error", ""),
              f"cuda_probe {name} did not finish: {res}")
    att = out["attempts"]
    # The port's landing paths rest on these two.
    check(att["C_host_staging"]["ok"] and att["C_host_staging"]["pinned"],
          "cuda_probe C: no pinned staging copy")
    check(att["D_register_our_slab"]["ok"],
          "cuda_probe D: the registered slab was not written by the card")
    return out


def phase_kv_disagg(card: str, log) -> dict:
    """The two-process KV disaggregation workload at its defaults, as a
    user runs it."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.tools.kv_disagg", "--json",
         "--seconds", "2"], cwd=root, capture_output=True, text=True,
        timeout=300)
    check(proc.returncode == 0,
          f"kv_disagg rc {proc.returncode}: {proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    log("kv_disagg row: " + json.dumps(row))
    for key in ("verified", "prefix_fetch_verified", "device_verified"):
        check(row[key] is True, f"kv_disagg {key} is {row[key]}")
    check(row["rpc_path"] == "rma", f"kv_disagg path {row['rpc_path']}")
    check(row["k1_launches"] > 0, "kv_disagg launched K1 no time")
    check(row["kv_failures"] == 0, f"{row['kv_failures']} failed fetches")
    log(f"kv_disagg [{card}]: {row['kv_goodput_gbps']} GB/s over shm "
        f"({row['rpc_path']}), {row['device_goodput_gbps']} GB/s onto the "
        f"card, token p99 {row['token_p99_unloaded_us']} -> "
        f"{row['token_p99_loaded_us']} us (ratio {row['ratio_p99']}), "
        f"{row['k1_launches']} K1 launches in the decode process")
    return row


def phase_bench(dev, card: str, log) -> dict:
    """The port's bench children on the card, as `python -m
    brpc_tpu_torch.tools.bench` runs them: the sweep over the five sizes
    and the device-RPC round trip."""
    from brpc_tpu_torch.tools import bench

    rows = []
    for row in bench.sweep_rows(bench.SIZES, dev):
        log(f"bench sweep [{card}]: " + json.dumps(row))
        rows.append(row)
    check([r["size"] for r in rows] == bench.SIZES,
          f"bench sweep rows {[r['size'] for r in rows]}")
    for r in rows:
        check(r["platform"] == "gpu", f"bench {r['size']}: {r['platform']}")
        if r["size"] >= bench.FUSED_MIN_BYTES:
            check(r.get("hbm_frac") is not None,
                  f"bench {r['size']}: no hbm_frac on a K1 row")
        if r.get("hbm_frac") is not None:
            check(r["hbm_frac"] <= 1.05,
                  f"bench {r['size']}: hbm_frac {r['hbm_frac']} > 1.05")
    rpc = bench.device_rpc_row(dev)
    log(f"bench device_rpc [{card}]: " + json.dumps(rpc))
    check(rpc["platform"] == "gpu", f"bench device_rpc: {rpc['platform']}")
    failed = bench.device_rpc_failures(rpc)
    check(not failed, f"bench device_rpc failed: {failed}")
    return {"sweep": rows, "device_rpc": rpc}


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
    from brpc_tpu_torch.tools.multi_device import check_k2_streams

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

    # Per-peer streams (the fabric's): each chunk made on its own stream,
    # each output read on its own, K2 between them fenced by events.
    ring = Fabric.auto((PEERS,), ("link",), devices=dev)
    streams = list(ring.streams)
    for kind, chunks in _ring_cases(PEERS, dev):
        torch.cuda.synchronize()
        got = ring_all_gather(chunks, streams)
        want = ring_all_gather_plain(chunks)
        for peer, (g, w, s) in enumerate(zip(got, want, streams)):
            with torch.cuda.stream(s):
                err = int((_int_bits(g) - _int_bits(w)).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"K2 on peer streams != plain, {kind} peer "
                  f"{peer}")
        log(f"K2 vs plain on {len(set(streams))} peer streams, "
            f"{kind:<15}: every peer bit-exact")
    checked = check_k2_streams([dev] * PEERS, streams, REPEATS)
    log(f"K2 on {len(set(streams))} peer streams, {REPEATS} repetitions: "
        f"{checked} outputs bit-exact, each chunk rewritten behind a delay "
        "on its stream just before and read on its stream just after")
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
    from brpc_tpu_torch.tools.multi_device import check_k2_fabric

    n = PEERS
    out = {}
    ring = Fabric.auto((n,), ("link",), devices=dev)
    out["peer_devices"] = [str(d) for d in ring.devices]
    out["peer_streams"] = len(set(ring.streams))
    log(f"peer-to-device map: {out['peer_devices']}; "
        f"{out['peer_streams']} peer streams")
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

    check_k2_fabric(ring, REPEATS)
    log(f"K2 via Fabric.spmd on peer streams: {REPEATS} more seeded 64 MiB "
        "gathers, each bit-exact against the reference and the input")

    # The full data-plane step on the 2x4 mesh, 64 MiB f32 payload.
    mesh = Fabric.auto((2, n // 2), ("dp", "link"), devices=dev)
    payload = torch.from_numpy(rng.integers(0, 4, size=STEP_PAYLOAD).astype(
        np.float32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp, csum = make_full_dataplane_step(mesh, "dp", "link")(payload)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
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
    sent_t = tensor_from_numpy(chunks, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    totals, per_chunk = stream_echo(ring, "link", STREAM_CHUNKS)(
        sent_t,
        torch.zeros(n, dtype=torch.int32, device=dev).view(torch.uint32))
    torch.cuda.synchronize()
    out["stream_s"] = time.perf_counter() - t0
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
    for _ in range(REPEATS):
        dryrun_multichip(n, device=dev)
    log(f"dryrun_multichip({n}) on the card, {REPEATS} times: every leg "
        "checked")
    log(f"multi-device times (host clock to synchronize): N-to-N "
        f"{out['nton_s']} s, step {out['step_s']} s, stream "
        f"{out['stream_s']} s")
    torch.cuda.synchronize()
    return out


def phase_ring_timing(dev, card: str, log) -> dict:
    import torch

    from brpc_tpu_torch.ops.ring_kernel import (ring_all_gather,
                                                ring_all_gather_plain)
    from brpc_tpu_torch.ops.roofline import hbm_peak_gbps
    from brpc_tpu_torch.parallel import Fabric

    n = PEERS
    rows, cols = RING_CHUNK
    chunks = [torch.randn(rows, cols, device=dev) for _ in range(n)]
    stacked = torch.stack(chunks)
    streams = list(Fabric.auto((n,), ("link",), devices=dev).streams)
    caller = torch.cuda.current_stream(dev)

    def peer_streams():  # the fabric's way: fenced in and out by events
        entry = caller.record_event()
        for s in streams:
            s.wait_event(entry)
        ring_all_gather(chunks, streams)
        for s in streams:
            caller.wait_event(s.record_event())

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
             ("peer_streams_ms", peer_streams, 20),
             *((name, fn, 20) for name, fn in libraries.items()),
             ("peer_streams_ms", peer_streams, 20),
             ("ms", lambda: ring_all_gather(chunks), 20),
             ("plain_ms", lambda: ring_all_gather_plain(chunks), 10),
             *((name, fn, 20) for name, fn in reversed(libraries.items()))]
    t = {}
    for key, fn, iters in turns:
        t.setdefault(key, []).append(cuda_ms(fn, iters=iters))
    t = {k: sum(v) / len(v) for k, v in t.items()}
    library = min(libraries, key=t.get)
    out = {"card": card, "peers": n, "chunk_bytes": chunk_bytes,
           "ms": t["ms"], "peer_streams_ms": t["peer_streams_ms"],
           "plain_ms": t["plain_ms"],
           "library_ms": t[library], "library": library,
           "library_calls_ms": {name: t[name] for name in libraries},
           "bound_ms": bound_ms, "bound_by": "bytes", "bound_bytes": need,
           "hbm_frac": bound_ms / t["ms"] if bound_ms else None,
           "kernel_gbps": need / (t["ms"] * 1e-3) / 1e9}
    log(f"K2 n={n} x 8 MiB [{card}]: {t['ms']} ms on one stream, "
        f"{t['peer_streams_ms']} ms on {n} peer streams, bound {bound_ms} ms "
        f"(bytes, (n+n^2)C); hbm_frac {out['hbm_frac']}; plain "
        f"{t['plain_ms']} ms; library {t[library]} ms ({library}); "
        f"library calls {out['library_calls_ms']}")
    return out


# A fenced launch that waits for a peer that never starts must trap, so
# that the next synchronise raises: launch 1 waits behind ~2 s of sleep on
# its stream, launch 0 gives up after 0.2 s.
_BARRIER_TIMEOUT_CHILD = r"""
import sys
import time
import torch
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch.ops.ring_kernel import ring_all_gather_fenced
dev = torch.device("cuda")
streams = [torch.cuda.Stream(dev) for _ in range(2)]
chunks = [torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
          for _ in range(2)]
ring_all_gather_fenced(chunks, streams)  # flags made, the kernel loaded
torch.cuda.synchronize()
with torch.cuda.stream(streams[1]):
    torch.cuda._sleep(1 << 32)
ring_all_gather_fenced(chunks, streams, timeout_s=0.2)
t0 = time.perf_counter()
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print(f"raised after {time.perf_counter() - t0:.3f} s:",
          str(e).strip().splitlines()[0], flush=True)
    sys.exit(0)
print(f"no error after {time.perf_counter() - t0:.3f} s", flush=True)
sys.exit(1)
"""


def _per_card_cases(devices):
    """(kind, chunks) with chunk r on devices[r]: _ring_cases' three 8 MiB
    kinds, and uint8 chunks of 64 KiB + 1 bytes at byte 1 of a buffer of
    each card (the ragged path, 1-byte copies)."""
    import numpy as np
    import torch

    n = len(devices)
    for kind, chunks in _ring_cases(n, devices[0]):
        yield kind, [c.to(d) for c, d in zip(chunks, devices)]
    rng = np.random.default_rng(SEED + 30 + n)
    size = 64 * 1024 + 1
    yield "u8_odd_offset", [
        torch.from_numpy(rng.integers(0, 256, size=1 + size,
                                      dtype=np.uint8)).to(d).narrow(0, 1,
                                                                     size)
        for d in devices]


def _check_fenced_cases(cases, streams, gather, log, where: str) -> int:
    """Each case through `gather` on the peers' streams against the plain
    version, every peer, bit-exact; returns the max abs error of the bits."""
    import torch

    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather_plain

    max_err = 0
    for kind, chunks in cases:
        torch.cuda.synchronize()
        got = gather(chunks, streams)
        want = ring_all_gather_plain(chunks)
        whole = torch.cat([_int_bits(c).to(chunks[0].device)
                           for c in chunks])
        for peer, (g, w, s) in enumerate(zip(got, want, streams)):
            s.wait_stream(torch.cuda.current_stream(s.device))
            with torch.cuda.device(s.device), torch.cuda.stream(s):
                err = int((_int_bits(g) - _int_bits(w)).abs().max())
                same = torch.equal(_int_bits(g), whole.to(g.device))
            max_err = max(max_err, err)
            check(err == 0 and same,
                  f"fenced K2 {where} != plain, {kind} peer {peer}")
        log(f"fenced K2 {where}, {kind:<15}: every peer bit-exact")
    torch.cuda.synchronize()
    return max_err


def phase_fenced(dev, card: str, log) -> dict:
    """K2's fenced launches (brpc_ring_all_gather_xcard), the cross-card
    path: on this card as n = 2 launches on two streams (their grids share
    the SMs, so the barrier holds), and with two or more cards visible one
    peer on each of up to four cards; each case bit-exact against the
    plain version for every peer, then repeated with every chunk rewritten
    behind a delay while a second stream set over the same cards gathers
    right behind the first (no synchronise between: fenced gathers take
    turns on each card); launches counted from 0 over these checks; its
    error contract (a refused launch raises, a barrier timeout traps and
    the next synchronise raises); timed beside its bound, its plain
    version and one PyTorch call for the gather under the same fence
    (NCCL across cards).  The kernels line takes the gated marginal
    (`multi_device.gated_ms`) of the gather and of that call, the card's
    own times; `ms` by events, host enqueue included, and the graph
    marginal stay beside them."""
    import torch

    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.ring_kernel import (FENCED_WRAPPER,
                                                ring_all_gather,
                                                ring_all_gather_fenced,
                                                ring_all_gather_plain)
    from brpc_tpu_torch.ops.roofline import (gather_bound_ms, hbm_peak_gbps,
                                             nvlink_peak_gbps)
    from brpc_tpu_torch.tools.multi_device import (check_k2_streams,
                                                   fence_around, gated_ms,
                                                   time_k2_cross_card)
    from brpc_tpu_torch.tools.tune_echo import device_ms

    name = torch.cuda.get_device_name(0)
    cards = min(4, torch.cuda.device_count())
    devices = [torch.device("cuda", i) for i in range(cards)]
    one, one_too = ([torch.cuda.Stream(dev) for _ in range(2)]
                    for _ in range(2))
    many, many_too = ([torch.cuda.Stream(d) for d in devices]
                      for _ in range(2))
    _kernels.reset_launches()
    max_err = _check_fenced_cases(
        [*_ring_cases(2, dev), *_ring_ragged_cases(2, dev)], one,
        ring_all_gather_fenced, log, "n=2 on two streams of one card")
    checked = check_k2_streams([dev] * 2, one, REPEATS,
                               gather=ring_all_gather_fenced,
                               also=[one_too])
    log(f"fenced K2 on two streams of one card and on two others right "
        f"behind, {REPEATS} repetitions: {checked} outputs bit-exact, each "
        f"chunk rewritten behind a delay")
    if cards > 1:
        max_err = max(max_err, _check_fenced_cases(
            _per_card_cases(devices), many, ring_all_gather, log,
            f"one peer on each of {cards} cards"))
        checked = check_k2_streams(devices, many, REPEATS, also=[many_too])
        log(f"fenced K2 on {cards} cards over two stream sets, one right "
            f"behind the other, {REPEATS} repetitions: {checked} outputs "
            "bit-exact, each chunk rewritten behind a delay")
    launches = _kernels.launches[FENCED_WRAPPER]
    check(launches > 0 and _kernels.launches.get("ring_all_gather", 0) == 0,
          f"fenced checks launched {dict(_kernels.launches)}")
    log(f"fenced path launches: {dict(_kernels.launches)}")

    chunks = [torch.zeros((8, 128), device=dev) for _ in range(2)]
    for what, fn, exc in (
            ("one stream", lambda: ring_all_gather_fenced(
                chunks, [one[0]] * 2), ValueError),
            ("a zero timeout", lambda: ring_all_gather_fenced(
                chunks, one, timeout_s=0), RuntimeError)):
        before = _kernels.launches[FENCED_WRAPPER]
        try:
            fn()
        except exc:
            pass
        else:
            raise SmokeError(f"fenced K2 with {what} did not raise "
                             f"{exc.__name__}")
        check(_kernels.launches[FENCED_WRAPPER] == before,
              f"fenced K2 with {what} launched")
    torch.cuda.synchronize()
    child = subprocess.run(
        [sys.executable, "-c", _BARRIER_TIMEOUT_CHILD,
         os.path.dirname(os.path.abspath(__file__))],
        capture_output=True, text=True, timeout=120)
    check(child.returncode == 0,
          f"barrier timeout child rc {child.returncode}: {child.stdout} "
          f"{child.stderr[-2000:]}")
    log(f"fenced K2 contract: ValueError for one stream, RuntimeError for "
        f"a refused launch (nothing launched); a peer that never starts "
        f"traps after 0.2 s and the next synchronise {child.stdout.strip()}")

    rows, cols = RING_CHUNK
    chunk_bytes = rows * cols * 4
    hbm = hbm_peak_gbps(name)
    pair = [torch.randn(rows, cols, device=dev) for _ in range(2)]
    flat = torch.stack(pair).view(1, 2 * rows, cols)

    def fenced_pair():
        fence_around([dev] * 2, one,
                     lambda: ring_all_gather_fenced(pair, one))

    def library_pair():  # the same fence around the one PyTorch call
        fence_around([dev] * 2, one,
                     lambda: flat.expand(2, -1, -1).contiguous())

    turns = [("plain_ms", lambda: ring_all_gather_plain(pair), 10),
             ("ms", fenced_pair, 20), ("library_ms", library_pair, 20)]
    t = {}
    for key, fn, iters in turns + turns[::-1]:
        t.setdefault(key, []).append(cuda_ms(fn, iters=iters))
    out = {"one_card": {k: sum(v) / len(v) for k, v in t.items()}}
    # The card's own time: `ms` above carries the host's enqueue of two
    # launches and the fence; the gated marginal and the graph's do not.
    out["one_card"]["graph_ms"] = device_ms(fenced_pair)
    out["one_card"]["library_graph_ms"] = device_ms(library_pair)
    out["one_card"]["gated"] = {"k2": gated_ms([dev], fenced_pair),
                                "library": gated_ms([dev], library_pair)}
    bound = gather_bound_ms(2, chunk_bytes, hbm) if hbm else None
    out["one_card"].update(
        peers=2, chunk_bytes=chunk_bytes, bound_ms=bound, bound_by="bytes",
        library="stacked.view(1, 2*rows, cols).expand(2, -1, -1)"
                ".contiguous(), fenced as K2")
    gated = out["one_card"]["gated"]
    slower = gated["k2"]["ms"] > gated["library"]["ms"]
    log(f"fenced K2 n=2 x 8 MiB on two streams of one card [{card}]: "
        f"{out['one_card']}; gated, the fenced entry is "
        f"{'SLOWER' if slower else 'faster'} than the one PyTorch call "
        f"under the same fence ({gated['k2']['ms']:.4f} against "
        f"{gated['library']['ms']:.4f} ms)")
    # The kernels line: gated marginals (the card's time, host enqueue
    # hidden) for the gather and its library call alike, each inside the
    # same fence; the graph marginals and `ms` by events stay beside them.
    line = dict(out["one_card"], ms=gated["k2"]["ms"],
                library_ms=gated["library"]["ms"])
    if cards > 1:
        big = [torch.randn(rows, cols, device=d) for d in devices]
        cross = time_k2_cross_card(devices, many, big, hbm,
                                   nvlink_peak_gbps(name))
        cross["plain_ms"] = sum(cuda_ms(lambda: ring_all_gather_plain(big),
                                        iters=10) for _ in range(2)) / 2
        out["cross_card"] = cross
        log(f"fenced K2 one peer on each of {cards} cards x 8 MiB [{card}]: "
            f"{cross}")
        line = dict(ms=cross["gated"]["k2"]["ms"],
                    plain_ms=cross["plain_ms"], bound_ms=cross["bound_ms"],
                    bound_by="bytes",
                    library_ms=cross["gated"].get("nccl", {}).get("ms"))
    else:
        log("fenced K2 across cards: NOT checked or timed, it needs >= 2 "
            "visible cards; this card checked the fenced launches as n = 2 "
            "on two streams of one card only (no NVLink, no remote stores)")
    out.update(cards=cards, launches=launches, max_abs_err=max_err,
               line=line)
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


def _prompt_tokens(tenant: int) -> list:
    """tools/kv_disagg.py `_prompt_tokens(spec, tenant, 0)`: a tenant's
    shared system prefix and its hottest prompt's own tail."""
    bt = PREFIX["block_tokens"]
    sys_part = [1_000_000 * (tenant + 1) + j
                for j in range(PREFIX["sys_blocks"] * bt)]
    tail = [500_000_000 + 1_000_000 * tenant + 10_000 + j
            for j in range(PREFIX["tail_blocks"] * bt)]
    return sys_part + tail


def _prefix_block(key, nbytes: int):
    """tools/kv_disagg.py `_prefix_block_bytes`: content from the chain
    key, so every process makes the same block."""
    import numpy as np

    salt = (key[1] & MASK) | 1
    return ((np.arange(nbytes, dtype=np.uint64) * 2654435761 + salt)
            >> 13).astype(np.uint8)


def phase_kv_path(dev, card: str, log) -> dict:
    """The KV-block plane at tools/kv_disagg.py's sizes: blocks published
    from a device tensor, fetched one-sided over shm back onto the card
    and checked there (K1 against the plain version on the source), a
    republish fetched through a stale cached record, a prefix round from
    device tensors, and Kv.Fetch records in a traffic capture."""
    import numpy as np
    import torch

    from brpc_tpu_torch import payload_from_numpy
    from brpc_tpu_torch.ops.echo_kernel import echo_fused, echo_reference
    from brpc_tpu_torch.rpc import (Channel, RmaBuffer, Server, capture, kv,
                                    observe)

    bb, lanes = KV_BLOCK_BYTES, KV_BLOCK_BYTES // 4
    rng = np.random.default_rng(SEED + 4)
    src = payload_from_numpy(rng.integers(
        0, 1 << 32, size=KV_BLOCKS * lanes, dtype=np.uint32), dev)
    src8 = src.view(torch.uint8)
    out = {"card": card, "blocks": KV_BLOCKS, "block_bytes": bb}
    cap_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "kv_fetch.cap")
    kv.reset()
    srv = Server()
    srv.enable_kv_store()
    srv.enable_kv_registry()
    addr = f"127.0.0.1:{srv.start(0)}"
    pages = RmaBuffer(KV_BLOCKS * bb, device=dev)
    lands = [RmaBuffer(bb, device=dev) for _ in range(KV_BLOCKS)]
    reg = kv.KvRegistryClient(Channel(addr, timeout_ms=10000),
                              owns_channel=True)
    cli = kv.KvClient(addr, use_shm=True, timeout_ms=30000)
    try:
        check(pages.cuda_registered and all(b.cuda_registered for b in lands),
              "a KV RmaBuffer is not registered with the CUDA driver")
        # The store serves the registered pages zero-copy from publish on:
        # the D2H copy must be complete before.
        pages.tensor.copy_(src8, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        for i in range(KV_BLOCKS):
            meta = kv.publish(1 + i, pages, offset=i * bb, length=bb,
                              lease_ms=600000, node=addr)
            reg.register(meta, lease_ms=600000)
        check(kv.store_count() == KV_BLOCKS == kv.registry_count(),
              f"store {kv.store_count()} / registry {kv.registry_count()} "
              f"blocks, want {KV_BLOCKS}")

        capture.enable_capture(True)
        capture.reset_capture()
        rma0 = int(observe.Vars.dump().get("rma_rx_msgs", 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backs = []
        for i in range(KV_BLOCKS):
            got = cli.fetch(1 + i, resp_buf=lands[i])
            check(got == bb, f"block {1 + i}: fetched {got} of {bb} bytes")
            backs.append(lands[i].tensor.to(dev, non_blocking=True))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rma = int(observe.Vars.dump().get("rma_rx_msgs", 0)) - rma0
        out.update(fetch_gbps=KV_BLOCKS * bb / secs / 1e9, fetch_s=secs,
                   rma_rx_msgs=rma, path="rma" if rma > 0 else "copy")
        for i, back in enumerate(backs):
            want = src[i * lanes:(i + 1) * lanes]
            check(torch.equal(back, src8[i * bb:(i + 1) * bb]),
                  f"block {1 + i} differs from its source on the card")
            copy, csum = echo_fused(back.view(torch.int32).view(torch.uint32))
            ref_copy, ref_sum = echo_reference(want)
            check(torch.equal(copy.view(torch.int32), ref_copy.view(
                torch.int32)) and u32(csum) == u32(ref_sum),
                f"block {1 + i}: K1 on the landed block != plain on source")
        del backs

        # Republish block 1 with new bytes; the client's cached record is
        # now stale and must be invalidated, not served.
        fresh = payload_from_numpy(rng.integers(
            0, 1 << 32, size=lanes, dtype=np.uint32), dev)
        kv.withdraw(1)
        pages.tensor[:bb].copy_(fresh.view(torch.uint8), non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        meta = kv.publish(1, pages, length=bb, lease_ms=600000, node=addr)
        reg.register(meta, lease_ms=600000)
        inval0 = cli.invalidations
        check(cli.fetch(1, resp_buf=lands[0]) == bb, "republished fetch")
        back = lands[0].tensor.to(dev)
        check(torch.equal(back, fresh.view(torch.uint8)),
              "the republished block came back stale")
        check(cli.invalidations >= inval0 + 1 and meta.generation >= 2,
              f"no invalidation ({cli.invalidations}) or generation "
              f"{meta.generation} on republish")
        out.update(invalidations=cli.invalidations,
                   republish_generation=meta.generation)

        n = capture.dump(cap_path)
        capture.enable_capture(False)
        _header, recs = capture.load_capture(cap_path)
        fetches = sum(r.method == "Kv.Fetch" for r in recs)
        check(fetches > 0, f"capture of {n} records holds no Kv.Fetch")
        out["capture_kv_fetch_records"] = fetches

        # One prefix round: each tenant's hottest prompt, published from
        # device tensors, matched and fetched back onto the card.
        bt, pb = PREFIX["block_tokens"], PREFIX["block_kb"] << 10
        blocks = 0
        for tenant in range(PREFIX["tenants"]):
            tokens = _prompt_tokens(tenant)
            keys = kv.prefix_chain(tokens, bt)
            check(len(keys) == PREFIX["sys_blocks"] + PREFIX["tail_blocks"],
                  f"tenant {tenant}: {len(keys)} chain keys")
            datas = []
            for d, key in enumerate(keys):
                host = _prefix_block(key, pb)
                data = torch.from_numpy(host).to(dev)
                span = tokens[d * bt:(d + 1) * bt]
                meta, _fresh = kv.prefix_publish(key, d, data, span,
                                                 lease_ms=600000, node=addr)
                check(meta.hash == kv.content_hash(host.tobytes(), span),
                      f"tenant {tenant} block {d}: content hash of the "
                      "device tensor != hash of its bytes")
                reg.put_prefix(meta, lease_ms=600000)
                datas.append(data)
            groups = cli.match_prefix(tokens, bt)
            got = cli.fetch_prefix(tokens, bt)
            check(len(groups) == len(keys) == len(got),
                  f"tenant {tenant}: matched {len(groups)}, fetched "
                  f"{len(got)} of {len(keys)} blocks")
            for d, (data, raw) in enumerate(zip(datas, got)):
                back = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
                check(torch.equal(back.to(dev), data),
                      f"tenant {tenant} prefix block {d} differs on card")
            blocks += len(got)
        out["prefix_blocks"] = blocks
    finally:
        capture.enable_capture(False)
        cli.close()
        reg.close()
        for b in lands:
            b.free()
        pages.free()
        srv.close()
        kv.reset()
    log(f"kv [{card}]: {KV_BLOCKS} x 8 MiB published from the card, fetched "
        f"over shm ({out['path']}, {out['rma_rx_msgs']} rma_rx_msgs) back "
        f"onto the card, equal and K1 == plain; fetch goodput "
        f"{out['fetch_gbps']} GB/s; republish fetched fresh (generation "
        f"{out['republish_generation']}, invalidations "
        f"{out['invalidations']}); {blocks} prefix blocks of 256 KiB equal "
        f"on the card; capture holds {fetches} Kv.Fetch records")
    return out


def _lcg_plain_replayed(words: int, base: int, iters: int, dev):
    """`lcg_plain`'s loop on the card, as int64 values in [0, 2^32), its
    launches replayed from a CUDA graph of PLAIN_CHUNK steps: the same
    torch operations without a host launch each (launched one by one, the
    ~5e5 steps of a calibrated piece cost 20 s of host time)."""
    import torch

    from brpc_tpu_torch.ops.lcg import ADD, MUL, lcg_plain

    v = lcg_plain(words, base, 0, dev).view(torch.int32).to(
        torch.int64) & MASK

    def steps(t, k):
        for _ in range(k):
            t.mul_(MUL).add_(ADD).bitwise_and_(MASK)

    warm = torch.cuda.Stream(dev)  # warm-up outside the capture
    warm.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(warm):
        steps(v.clone(), 3)
    torch.cuda.current_stream(dev).wait_stream(warm)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps(v, PLAIN_CHUNK)
    for _ in range(iters // PLAIN_CHUNK):
        graph.replay()
    steps(v, iters % PLAIN_CHUNK)
    return v


def phase_pipeline_step(dev, card: str, log) -> dict:
    """The pipeline-parallel step with its compute on the card, checked
    against the plain LCG; returns the row and the LCG kernel's numbers.
    The caller resets and reads the launch counts around it."""
    import torch

    from brpc_tpu_torch.ops import _kernels
    from brpc_tpu_torch.ops.lcg import (WRAPPER, lcg, lcg_jump, lcg_plain,
                                        piece_base)
    from brpc_tpu_torch.ops.roofline import hbm_peak_gbps
    from brpc_tpu_torch.tools.pipeline_step import run_pipeline

    gathered = []

    def keep(bufs):  # copies of the overlapped run's results, on the card
        gathered.extend([[t.to(dev, copy=True) for t in per] for per in bufs])

    row = run_pipeline(device=dev, on_gathered=keep)
    launches = _kernels.launches[WRAPPER]
    log(f"pipeline step [{card}]: {json.dumps(row)}")
    n, m_count = row["members"], row["microbatches"]
    words, iters = row["shard_bytes"] // 4, row["compute_iters"]
    check(row["byte_exact"], "pipeline: overlapped != sequential bytes")
    check(row["ready_triggers"] > 0, "pipeline: no readiness trigger")
    check(row["sessions_live"] == 0 and row["ready_maps_live"] == 0,
          f"pipeline: {row['sessions_live']} sessions, "
          f"{row['ready_maps_live']} ready maps left")

    def bits(t):
        return t.view(torch.int32).to(torch.int64) & MASK

    # The kernel against the plain loop at one piece, the calibrated iters
    # (the loop replayed from a graph, itself held against the eager loop).
    base = piece_base(0, 0, 0)
    short = 3 * PLAIN_CHUNK + 5
    check(torch.equal(_lcg_plain_replayed(words, base, short, dev),
                      bits(lcg_plain(words, base, short, dev))),
          "the replayed plain loop != the eager plain loop")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = _lcg_plain_replayed(words, base, iters, dev)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    got = bits(lcg(words, base, iters, dev))
    err = int((got - plain).abs().max())
    check(err == 0, f"LCG kernel != plain at iters={iters} (err {err})")
    check(torch.equal(plain, bits(lcg_jump(
        words, torch.tensor([base], device=dev), iters)[0])),
        "LCG closed form != plain loop on the card")

    # Every member's gathered buffer: the u32 sum over members of the
    # plain pieces, computed on the card for every (rank, microbatch,
    # piece) by the plain loop's closed form.
    bases = torch.tensor([piece_base(r, m, p) for r in range(n)
                          for m in range(m_count) for p in range(n)],
                         device=dev)
    pieces = bits(lcg_jump(words, bases, iters)).view(n, m_count, n * words)
    want = pieces.sum(dim=0) & MASK
    for r in range(n):
        for m in range(m_count):
            check(torch.equal(bits(gathered[r][m]), want[m]),
                  f"pipeline: rank {r} microbatch {m} gathered != the sum "
                  "of the plain pieces")

    ms = cuda_ms(lambda: lcg(words, base, iters, dev), iters=10)
    # Bound: words x iters multiply-adds at the INT32 rate, or the output
    # written once at the published HBM rate, whichever is longer.
    ops_ms = words * iters / INT32_ADDS_PER_S * 1e3
    peak = hbm_peak_gbps(torch.cuda.get_device_name(0))
    bytes_ms = 0.0 if peak is None else 4 * words / (peak * 1e9) * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    out = {"row": row, "launches": launches, "max_abs_err": err,
           "words": words, "iters": iters, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "int32_frac": bound_ms / ms}
    log(f"LCG kernel [{card}]: {words} words x {iters} iters bit-exact vs "
        f"plain; {ms} ms, bound {bound_ms} ms ({out['bound_by']}), fraction "
        f"{out['int32_frac']}; plain {plain_ms} ms; gathered buffers of "
        f"{n} members x {m_count} microbatches equal the plain sums; "
        f"speedup {row['speedup']}, overlap_efficiency "
        f"{row['overlap_efficiency']}, compute_ms {row['compute_ms']}, "
        f"comm_ms {row['comm_ms']}; {launches} launches")
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
    from brpc_tpu_torch.ops.lcg import WRAPPER as LCG_WRAPPER
    from brpc_tpu_torch.ops.ring_kernel import FENCED_WRAPPER
    from brpc_tpu_torch.ops.ring_kernel import WRAPPER as RING_WRAPPER

    def log(msg: str) -> None:
        print(msg, flush=True)

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_lint()
    phase_s = {"lint": time.perf_counter() - t0}
    phase_build(log)
    phase_s["build"] = time.perf_counter() - t0 - phase_s["lint"]
    t_probe = time.perf_counter()
    probe = phase_cuda_probe(log)
    phase_s["cuda_probe"] = time.perf_counter() - t_probe
    max_err = phase_kernel_vs_plain(dev, log)
    max_err = max(max_err, phase_k1_views(dev, log))
    phase_float_checksums(dev, log)
    phase_step(dev, log)

    _kernels.reset_launches()
    main = phase_main_path(dev, log)
    launches = dict(_kernels.launches)
    check(launches.get(WRAPPER, 0) > 0,
          f"main path launched {WRAPPER} no time")
    log(f"main path launches: {launches}")

    timing = phase_timing(dev, card, log)
    t_tune = time.perf_counter()
    tune = phase_tune_echo(dev, card, log)
    phase_s["tune_echo"] = time.perf_counter() - t_tune
    ring_err = phase_ring_vs_plain(dev, log)

    _kernels.reset_launches()
    multi = phase_multi_device(dev, log)
    ring_launches = dict(_kernels.launches)
    check(ring_launches.get(RING_WRAPPER, 0) > 0,
          f"multi-device path launched {RING_WRAPPER} no time")
    log(f"multi-device path launches: {ring_launches}")

    ring_timing = phase_ring_timing(dev, card, log)
    t_fenced = time.perf_counter()
    fenced = phase_fenced(dev, card, log)
    phase_s["fenced"] = time.perf_counter() - t_fenced

    _kernels.reset_launches()
    batch = phase_batch_path(dev, card, log)
    batch_launches = dict(_kernels.launches)
    check(batch_launches.get(WRAPPER, 0) > 0,
          f"batch path launched {WRAPPER} no time")
    log(f"batch path launches: {batch_launches}")

    t_kv = time.perf_counter()
    _kernels.reset_launches()
    kv_path = phase_kv_path(dev, card, log)
    kv_launches = dict(_kernels.launches)
    check(kv_launches.get(WRAPPER, 0) > 0,
          f"KV path launched {WRAPPER} no time")
    log(f"KV path launches: {kv_launches}")

    t_pipe = time.perf_counter()
    _kernels.reset_launches()
    pipeline = phase_pipeline_step(dev, card, log)
    check(pipeline["launches"] > 0,
          f"pipeline step launched {LCG_WRAPPER} no time")
    log(f"pipeline step launches: {{{LCG_WRAPPER!r}: "
        f"{pipeline['launches']}}}")
    phase_s.update(kv=t_pipe - t_kv, pipeline=time.perf_counter() - t_pipe)

    t_disagg = time.perf_counter()
    disagg = phase_kv_disagg(card, log)
    phase_s["kv_disagg"] = time.perf_counter() - t_disagg

    t_bench = time.perf_counter()
    _kernels.reset_launches()
    bench = phase_bench(dev, card, log)
    bench_launches = dict(_kernels.launches)
    check(bench_launches.get(WRAPPER, 0) > 0,
          f"bench path launched {WRAPPER} no time")
    log(f"bench path launches: {bench_launches}")
    phase_s["bench"] = time.perf_counter() - t_bench
    log(f"phase seconds: {phase_s}")
    timing_line = dict(timing, rpc_gbps=main["rpc_gbps"],
                       transport=main["transport"],
                       d2h_land_gbps=main["d2h_land_gbps"],
                       ici_zero_copy=main["ici_zero_copy"],
                       roundtrip_verified=main["roundtrip_verified"],
                       ring=dict(ring_timing, **multi), fenced=fenced,
                       batch=batch, kv=kv_path,
                       pipeline=pipeline, tune_echo=tune,
                       kv_disagg=disagg, bench=bench,
                       cuda_probe=probe["attempts"], phase_s=phase_s,
                       wall_s=time.perf_counter() - t0)
    log("timing: " + json.dumps(timing_line))
    kernels = {"kernels": [{
        "name": WRAPPER, "route": "cuda",
        "source": "brpc_tpu_torch/csrc/echo_kernel.cu",
        "replaces": "brpc_tpu/ops/echo_kernel.py:26",
        "launches": (launches[WRAPPER] + batch_launches[WRAPPER]
                     + kv_launches[WRAPPER] + disagg["k1_launches"]
                     + bench_launches[WRAPPER]),
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
        "library_ms": ring_timing["library_ms"]}, {
        "name": FENCED_WRAPPER, "route": "cuda",
        "source": "brpc_tpu_torch/csrc/ring_kernel.cu",
        "replaces": "brpc_tpu/ops/ring_kernel.py:37",
        "launches": fenced["launches"], "max_abs_err": fenced["max_abs_err"],
        "ms": fenced["line"]["ms"], "plain_ms": fenced["line"]["plain_ms"],
        "bound_ms": fenced["line"]["bound_ms"],
        "bound_by": fenced["line"]["bound_by"],
        "library_ms": fenced["line"]["library_ms"]}, {
        "name": LCG_WRAPPER, "route": "cuda",
        "source": "brpc_tpu_torch/csrc/lcg_kernel.cu",
        "replaces": "tools/pipeline_step.py:63",
        "launches": pipeline["launches"],
        "max_abs_err": pipeline["max_abs_err"],
        "ms": pipeline["ms"], "plain_ms": pipeline["plain_ms"],
        "bound_ms": pipeline["bound_ms"], "bound_by": pipeline["bound_by"],
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
    # The run drives the first card, and the fenced K2 phase one peer on
    # each of up to four: show torch at most the first four visible cards,
    # so the device count it reports is the count it used.  (CUDA stops at
    # the first ordinal a host lacks, so "0,1,2,3" on a host of one card
    # shows that one.)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
        ("0,1,2,3" if visible is None else visible).split(",")[:4])
    try:
        return run(args.out)
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
