"""Pipeline-parallel training step as ONE overlapped dataflow — port of
tools/pipeline_step.py, with the microbatch compute on the card.

A 4-member fleet runs M microbatches of a data-parallel training step:
each microbatch's gradient buffer is produced on the device (an iterated
u32 multiply-add, deterministic per (rank, microbatch, piece): one launch
of the LCG kernel per piece, `ops/lcg.py`), reduce-scattered across the
fleet, and the reduced chunk all-gathered back — the reduce-scatter /
all-gather decomposition of a data-parallel optimizer step.

Two executions of the SAME dataflow:

  sequential — microbatch m computes, THEN communicates: step time is
      the ~sum of compute and comm (the whole-buffer-barrier world).
  overlapped — each rank's comm lane issues every microbatch's
      reduce-scatter up front with a `collective.ReadyMap` over the
      gradient buffer while the compute lane keeps producing: transfers
      fire per-chunk as the producer stamps (`trpc_coll_overlap`), so
      microbatch m's communication rides UNDER microbatch m+1's compute.

Each member computes on a CUDA stream of its own.  A piece is copied from
the card into the member's gradient `RmaBuffer` (registered with the CUDA
driver, so the copy is one DMA) and the member waits on an event recorded
after that copy before it stamps the ReadyMap: a stamp ahead of the copy
would let the collective send stale bytes.

Headline metric: **overlap efficiency** = step_time / max(compute_time,
comm_time) — 1.0 is perfect overlap (the step costs only its longest
lane); the sequential baseline sits near (compute + comm) /
max(compute, comm).  Results must be byte-exact across both modes
(`byte_exact` in the row).

Compute iterations are calibrated so compute_time ≈ 0.8 x comm_time —
the regime where overlap pays the most.  The fleet is loopback on one
box, so the link is emulated with the deterministic fault plane
(`delay=1:MS` parks the rx fiber, burning no CPU); both modes pay the
identical emulated link, stamped on the row as link_delay_ms.

Run on the GPU:  python -m brpc_tpu_torch.tools.pipeline_step --json
On the CPU:      python -m brpc_tpu_torch.tools.pipeline_step --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time

import torch

from brpc_tpu_torch import resolve_device
from brpc_tpu_torch.ops.lcg import lcg, piece_base
from brpc_tpu_torch.rpc import (Server, collective, fault, get_flag,
                                observe, rma, set_flag)

#: Seconds a member thread may run before the fleet calls it wedged.
JOIN_S = 240


class Fleet:
    """n collective members in one process (one Server + Group each);
    run_all drives one callable per rank on its own thread."""

    def __init__(self, n: int, timeout_ms: int = 60000):
        self.n = n
        self.srvs = []
        self.groups = []
        try:
            for _ in range(n):
                s = Server()
                s.enable_collective()
                s.start(0)
                self.srvs.append(s)
            members = [f"127.0.0.1:{s.port}" for s in self.srvs]
            self.groups = [collective.Group(members, r,
                                            timeout_ms=timeout_ms)
                           for r in range(n)]
        except BaseException:
            self.close()
            raise

    def run_all(self, fn) -> float:
        errs = [None] * self.n

        def go(r):
            try:
                fn(r)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs[r] = e

        threads = [threading.Thread(target=go, args=(r,), daemon=True)
                   for r in range(self.n)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.monotonic() + JOIN_S
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0))
        dt = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise TimeoutError("pipeline member wedged")
        if any(errs):
            raise RuntimeError(f"pipeline member failed: {errs}")
        return dt

    def close(self):
        for g in self.groups:
            g.close()
        for s in self.srvs:
            s.stop()


def per_iter_cost(hi_s: float, lo_s: float, hi_iters: int,
                  lo_iters: int) -> float:
    """Seconds per iteration of a piece: the marginal between two probe
    lengths, so a launch's fixed cost does not count; where noise hides
    it (a loaded host can time the longer probe faster), the longer
    probe's mean per iteration, which bounds it from above and so errs
    toward less compute, never toward the 2^20 cap."""
    marginal = (hi_s - lo_s) / (hi_iters - lo_iters)
    return marginal if marginal > 0 else hi_s / hi_iters


def calibrate(baseline, iters: int, attempts: int = 3) -> int:
    """Runs `baseline(iters)`, which returns the step's compute/comm ratio,
    until the ratio is within 0.65 to 0.92, re-aiming iters at 0.8x the
    comm it measured between runs, at most `attempts` times.  Returns the
    iters of the LAST baseline run, on target or not: its results are the
    golden bytes the overlapped run is held to, so that run must compute
    with the same iters.  At the 2^20 cap it stops only when more compute
    is wanted."""
    for attempt in range(attempts):
        ratio = baseline(iters)
        if (0.65 <= ratio <= 0.92 or (ratio < 0.65 and iters >= (1 << 20))
                or attempt == attempts - 1):
            break
        iters = min(1 << 20, max(8, int(iters * 0.80 / max(ratio, 1e-6))))
    return iters


def run_pipeline(members: int = 4, shard_kb: int = 256,
                 microbatches: int = 8, target_ms: float = 0.0,
                 link_delay_ms: int = 2, device=None,
                 on_gathered=None) -> dict:
    """One sequential and one overlapped run of the step; returns the row.
    `device` is where the pieces are computed (the GPU unless given).
    `on_gathered`, when given, is called with the overlapped run's
    gathered buffers (per rank, per microbatch: uint8 CPU tensors over the
    registered bytes, valid only during the call)."""
    dev = resolve_device(device)
    with contextlib.ExitStack() as cleanup:
        return _run(cleanup, dev, members, shard_kb << 10, microbatches,
                    target_ms, link_delay_ms, on_gathered)


def _run(cleanup, dev, n, shard, m_count, target_ms, link_delay_ms,
         on_gathered) -> dict:
    words = shard // 4

    def buffers(size):
        # Registered with the CUDA driver on a GPU; freed on the way out.
        return [[cleanup.enter_context(rma.RmaBuffer(size, device=dev))
                 for _ in range(m_count)] for _ in range(n)]

    # Per rank per microbatch: gradient accumulator (n*shard, MUTATED by
    # reduce_scatter), reduced chunk (shard), gathered result (n*shard).
    grads = buffers(n * shard)
    reds = buffers(shard)
    gaths = buffers(n * shard)
    streams = ([torch.cuda.Stream(dev) for _ in range(n)]
               if dev.type == "cuda" else [None] * n)
    fleet = Fleet(n)
    cleanup.callback(fleet.close)
    # Process-wide switches go back to their defaults whatever fails.
    cleanup.callback(set_flag, "trpc_coll_overlap", "false")
    if link_delay_ms > 0:
        cleanup.callback(fault.set_schedule, "")

    seq_no = [0]

    def next_seqs():
        # Two collectives per microbatch, same run_seq on every member.
        base = seq_no[0] + 1
        seq_no[0] += 2 * m_count
        return base

    def produce(r, m, p, iters):
        # One piece into rank r's gradient buffer; returns once the bytes
        # are there (only then may the producer stamp them ready).
        dst = grads[r][m].tensor[p * shard:(p + 1) * shard]
        base = piece_base(r, m, p)
        if streams[r] is None:
            dst.copy_(lcg(words, base, iters, dev).view(torch.uint8))
            return
        with torch.cuda.stream(streams[r]):
            out = lcg(words, base, iters, dev)
            dst.copy_(out.view(torch.uint8), non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(streams[r])
        copied.synchronize()

    def fill_all(iters):
        # Pre-fill every gradient buffer (no timing): comm-only probes.
        for r in range(n):
            for m in range(m_count):
                for p in range(n):
                    produce(r, m, p, iters)

    def comm_lane(r, base):
        # The barrier-world comm schedule: every microbatch's
        # reduce-scatter + all-gather issued strictly in order (used by
        # the comm-only calibration probe).
        for m in range(m_count):
            fleet.groups[r].reduce_scatter(
                grads[r][m], reds[r][m], shard_bytes=shard,
                run_seq=base + 2 * m)
            fleet.groups[r].all_gather(
                reds[r][m], gaths[r][m], shard_bytes=shard,
                run_seq=base + 2 * m + 1)

    # Emulated link (netem for the in-process fleet): park every rx
    # fiber link_delay_ms before delivery — comm goes latency-bound (as
    # on a real fabric) while the host stays free.  Both modes below pay
    # the identical link.
    if link_delay_ms > 0:
        fault.set_schedule(f"delay=1:{int(link_delay_ms)}")

    # --- calibrate: comm-only time, then iters so compute ≈ comm ---
    fill_all(1)
    for _ in range(2):  # warm rings/windows/connections (twice: stable)
        base = next_seqs()
        fleet.run_all(lambda r: comm_lane(r, base))
    fill_all(1)
    base = next_seqs()
    comm_probe_s = fleet.run_all(lambda r: comm_lane(r, base))
    if target_ms > 0:
        comm_probe_s = target_ms / 1e3
    # Cost of one iteration over a piece: the marginal time between two
    # probe lengths, so a launch's fixed cost does not count (on the card
    # 64 iterations are mostly launch and wait).
    lo_iters = 64
    hi_iters = lo_iters + (1 << 16 if dev.type == "cuda" else 64)

    def probe_s(iters):
        produce(0, 0, 0, iters)  # warm
        t0 = time.perf_counter()
        for _ in range(4):
            produce(0, 0, 0, iters)
        return (time.perf_counter() - t0) / 4

    per_iter_s = per_iter_cost(probe_s(hi_iters), probe_s(lo_iters),
                               hi_iters, lo_iters)
    pieces_per_rank = m_count * n
    # Initial guess: compute ≈ 0.55x the comm-only probe (the probe
    # overstates in-step comm because compute gaps absorb the rx tail).
    # The sequential baseline below then measures the TRUE in-step
    # compute/comm split and the guess is refined until compute sits at
    # ~0.8x comm — comm stays the longer lane (the overlapped dataflow
    # hides all of compute under it) with the least dead air.
    iters = max(8, int(0.55 * comm_probe_s / max(per_iter_s, 1e-9)
                       / pieces_per_rank))
    iters = min(iters, 1 << 20)

    compute_s = [0.0] * n
    comm_s = [0.0] * n

    def compute_piece(r, m, p):
        t0 = time.perf_counter()
        produce(r, m, p, iters)
        compute_s[r] += time.perf_counter() - t0

    set_flag("trpc_coll_overlap", "false")
    seq = {}

    def baseline(iters_now):
        # --- sequential baseline: compute m, then communicate m ---
        nonlocal iters
        iters = iters_now
        produce(0, 0, 0, iters)  # warm at this length
        compute_s[:] = [0.0] * n
        comm_s[:] = [0.0] * n
        base = next_seqs()

        def seq_member(r):
            for m in range(m_count):
                for p in range(n):
                    compute_piece(r, m, p)
                t0 = time.perf_counter()
                fleet.groups[r].reduce_scatter(
                    grads[r][m], reds[r][m], shard_bytes=shard,
                    run_seq=base + 2 * m)
                fleet.groups[r].all_gather(
                    reds[r][m], gaths[r][m], shard_bytes=shard,
                    run_seq=base + 2 * m + 1)
                comm_s[r] += time.perf_counter() - t0

        seq["step_s"] = fleet.run_all(seq_member)
        seq["compute_ms"] = max(compute_s) * 1e3
        seq["comm_ms"] = max(comm_s) * 1e3
        return seq["compute_ms"] / max(seq["comm_ms"], 1e-6)

    iters = calibrate(baseline, iters)
    seq_step_s, compute_ms, comm_ms = (seq["step_s"], seq["compute_ms"],
                                       seq["comm_ms"])

    seq_golden = [[gaths[r][m].tensor.clone() for m in range(m_count)]
                  for r in range(n)]

    # --- overlapped: one comm lane riding under the compute lane ---
    set_flag("trpc_coll_overlap", "true")
    rx0 = observe.Vars.dump().get("rma_rx_msgs", 0)
    trig0 = observe.Vars.dump().get("coll_ready_triggers_total", 0)
    base = next_seqs()

    def ovl_member(r):
        readies = [collective.ReadyMap(grads[r][m], granularity=shard)
                   for m in range(m_count)]

        # ONE dataflow: the comm lane's reduce-scatter for microbatch m
        # fires per-chunk as the producer stamps, so RS(m) + AG(m) ride
        # under compute(m+1..). A single lane — concurrent collectives
        # would contend on the emulated link's serialized rx fibers.
        def comm_thread():
            for m in range(m_count):
                fleet.groups[r].reduce_scatter(
                    grads[r][m], reds[r][m], shard_bytes=shard,
                    run_seq=base + 2 * m, ready=readies[m])
                fleet.groups[r].all_gather(
                    reds[r][m], gaths[r][m], shard_bytes=shard,
                    run_seq=base + 2 * m + 1)

        comm = threading.Thread(target=comm_thread, daemon=True)
        comm.start()
        # The compute lane: produce microbatch m's pieces and stamp each
        # once its bytes are in the buffer — m's transfers fire under
        # m+1's compute.
        for m in range(m_count):
            for p in range(n):
                compute_piece(r, m, p)
                readies[m].stamp(p * shard, shard)
        comm.join(JOIN_S)
        alive = comm.is_alive()
        for rm in readies:
            rm.close()
        if alive:
            raise TimeoutError(f"rank {r} comm lane wedged")

    ovl_step_s = fleet.run_all(ovl_member)
    set_flag("trpc_coll_overlap", "false")
    if link_delay_ms > 0:
        fault.set_schedule("")
    rpc_path = ("rma" if observe.Vars.dump().get("rma_rx_msgs", 0) > rx0
                else "copy")
    ready_triggers = (observe.Vars.dump().get("coll_ready_triggers_total", 0)
                      - trig0)

    byte_exact = all(
        torch.equal(gaths[r][m].tensor, seq_golden[r][m])
        for r in range(n) for m in range(m_count))
    if on_gathered is not None:
        on_gathered([[gaths[r][m].tensor for m in range(m_count)]
                     for r in range(n)])

    return {
        "workload": "pipeline_overlap",
        "members": n,
        "microbatches": m_count,
        "shard_bytes": shard,
        "link_delay_ms": int(link_delay_ms),
        "compute_iters": iters,
        "seq_step_ms": round(seq_step_s * 1e3, 1),
        "ovl_step_ms": round(ovl_step_s * 1e3, 1),
        "compute_ms": round(compute_ms, 1),
        "comm_ms": round(comm_ms, 1),
        # 1.0 = perfect overlap: the step costs only its longest lane.
        "overlap_efficiency": round(
            ovl_step_s * 1e3 / max(compute_ms, comm_ms, 1e-6), 3),
        "seq_efficiency": round(
            seq_step_s * 1e3 / max(compute_ms, comm_ms, 1e-6), 3),
        "speedup": round(seq_step_s / max(ovl_step_s, 1e-9), 3),
        "byte_exact": byte_exact,
        "ready_triggers": int(ready_triggers),
        "rpc_path": rpc_path,
        "granularity_bytes": int(
            get_flag("trpc_coll_ready_granularity_bytes")),
        "sessions_live": collective.sessions_live(),
        "ready_maps_live": collective.ready_maps_live(),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="print the row as one JSON line")
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--shard-kb", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--link-delay-ms", type=int, default=2,
                    help="emulated rx link latency (0 = raw loopback)")
    ap.add_argument("--device", default=None,
                    help="where the pieces are computed (default: the GPU)")
    args = ap.parse_args()
    row = run_pipeline(args.members, args.shard_kb, args.microbatches,
                       link_delay_ms=args.link_delay_ms, device=args.device)
    if args.json:
        print(json.dumps(row), flush=True)
    else:
        for k, v in row.items():
            print(f"{k:>20}: {v}")


if __name__ == "__main__":
    main()
