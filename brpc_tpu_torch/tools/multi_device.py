"""The multi-device plane on the card: checks that repeat to catch a missing
stream wait, and times at full width.

    python brpc_tpu_torch/tools/multi_device.py [--cards 1|all] [--json]
        [--repeat 10] [--root PATH] [--out FILE]

`--cards 1` lays 8 peers on the first card, each on a stream of its own;
`--cards all` lays one peer on each visible card (peer access between
every pair, K2 once per card).  It prints the peer-to-device map and the
stream count, then:

- checks, each `--repeat` times, bit-exact: K2 called on every peer's
  stream directly, with every chunk rewritten on its stream behind a
  delay just before the gather and every output compared on its stream
  just after (a missing wait reads stale bytes); K2 through the fabric;
  `dryrun_multichip` at its small shapes on these devices;
- times, with the card's name and power limit: K2 on the peers' streams
  (CUDA events on the caller's stream, which fences the peers in and
  out; and on the card alone, the marginal cost in CUDA graphs) beside
  its bound and its plain version, and on one card also on one stream;
  across cards at n x 8 and n x 32 MiB, with each card's own kernel time
  (events around its launch on its stream) and two yardsticks timed as
  K2's `ms`: `torch.cuda.nccl.all_gather` on the same chunks (the tool's
  only call of it; the port never makes one) and card 0's chunk copied
  to every other card; then K2 through the fabric, the 64 MiB-per-peer
  N-to-N exchange, the 64 MiB data-plane step and the 16 x 4 MiB stream
  echo (host clock ending in a synchronise of every card).

`--root PATH` times the package of another checkout (its times only: the
checks and the per-peer stream timing need this one's).  Run it as a
file, not with -m, so that `--root` decides which package is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

MIB = 1 << 20
PEERS = 8                  # peers on one card
RING_CHUNK = (16384, 128)  # f32 rows, cols of each peer's K2 chunk: 8 MiB
PEER_BYTES = 64 * MIB      # N-to-N bytes each peer sends
STEP_PAYLOAD = (16384, 1024)  # f32 payload of the data-plane step: 64 MiB
STREAM_CHUNKS = 16         # stream echo: chunks of 4 MiB per peer
STREAM_LANES = MIB
SLEEP_CYCLES = 200_000     # ~0.1 ms delay ahead of each chunk's rewrite
GATE_CYCLES = 40_000_000   # ~20 ms gate ahead of a timed chain (gated_ms)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_s(fn, reps: int) -> list:
    """Seconds of each of `reps` calls, each ending in a synchronise of
    every card (after one warm call)."""
    fn()
    sync_all()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync_all()
        out.append(time.perf_counter() - t0)
    return out


def peer_devices(cards: str):
    import torch

    if cards == "all":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cuda", 0)] * PEERS


def check_k2_streams(devices, streams, repeat: int, gather=None,
                     also=()) -> int:
    """K2 on the peers' own streams, `repeat` times: chunk j is rewritten
    on stream j behind a delay just before the gather, and output r is
    compared on stream r just after, against the gather made apart.
    `gather(chunks, streams)` is `ring_all_gather` unless given.  `also`:
    more stream sets over the same devices, each with chunks of its own
    and gathered in each repetition right after the one before, with no
    synchronise between.  Returns the comparisons made; raises on the
    first wrong byte."""
    import torch

    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather

    gather = gather or ring_all_gather

    n = len(devices)
    sets = [list(streams), *(list(s) for s in also)]
    rows, cols = RING_CHUNK
    gen = torch.Generator().manual_seed(7)
    base = torch.randint(-(1 << 31), 1 << 31, (n * rows, cols),
                         dtype=torch.int32, generator=gen)
    bases = [base.to(d) for d in devices]  # every peer's view of the gather
    chunks = [[torch.empty((rows, cols), dtype=torch.int32, device=d)
               for d in devices] for _ in sets]
    sync_all()
    checked = 0
    for it in range(repeat):
        outs = []
        for i, (ss, cs) in enumerate(zip(sets, chunks)):
            for j, (d, s) in enumerate(zip(devices, ss)):
                with torch.cuda.device(d), torch.cuda.stream(s):
                    torch.cuda._sleep(SLEEP_CYCLES)
                    torch.add(bases[j][j * rows:(j + 1) * rows],
                              it + (i << 16), out=cs[j])
            outs.append(gather(cs, ss))
        for i, (ss, got) in enumerate(zip(sets, outs)):
            same = []
            for r, (d, s) in enumerate(zip(devices, ss)):
                with torch.cuda.device(d), torch.cuda.stream(s):
                    same.append(torch.equal(got[r],
                                            bases[r] + (it + (i << 16))))
            bad = [r for r, ok in enumerate(same) if not ok]
            if bad:
                raise AssertionError(
                    f"K2 on per-peer streams, repetition {it}, stream set "
                    f"{i}: peers {bad} differ from the gather")
            checked += n
    sync_all()
    return checked


def check_k2_fabric(ring, repeat: int) -> None:
    import torch

    from brpc_tpu_torch.ops.ring_kernel import (ring_all_gather_kernel,
                                                ring_all_gather_reference)

    n = ring.size
    rows, cols = RING_CHUNK
    for it in range(repeat):
        gen = torch.Generator().manual_seed(100 + it)
        global_ = ring.put(torch.randn((n * rows, cols), generator=gen),
                           "link")
        got = ring_all_gather_kernel(ring, "link")(global_)
        want = ring_all_gather_reference(ring, "link")(global_)
        if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(got, global_)):
            raise AssertionError(f"K2 through the fabric, repetition {it}")


def fence_around(devices, streams, call) -> None:
    """call() between the caller's stream (of devices[0]) and the peers'
    streams: every peer's stream waits for the caller's work so far, and
    the caller waits for every peer's stream after the call."""
    import torch

    caller = torch.cuda.current_stream(devices[0])
    entry = caller.record_event()
    distinct = list(dict.fromkeys(streams))
    for s in distinct:
        s.wait_event(entry)
    call()
    for s in distinct:
        caller.wait_event(s.record_event())


def gated_ms(devices, fn, short: int = 4, long: int = 20,
             reps: int = 5) -> dict:
    """The card's milliseconds per fn() with the host's enqueue hidden:
    the caller's stream (of devices[0]) sleeps ~GATE_CYCLES before a chain
    of fn() calls, so the whole chain is enqueued before any of it runs;
    the median over `reps` of (T(long) - T(short)) / (long - short) by
    events on the caller's stream.  fn() must fence itself to the caller
    (`fence_around`).  Also the host's microseconds to enqueue one call
    (the long chains' mean), and whether every chain was enqueued within
    the sleep (else the marginal holds host time)."""
    import torch

    caller = torch.cuda.current_stream(devices[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def chain(count: int):
        sync_all()
        start.record(caller)
        with torch.cuda.device(devices[0]):
            torch.cuda._sleep(GATE_CYCLES)
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        host = time.perf_counter() - t0
        end.record(caller)
        end.synchronize()
        return start.elapsed_time(end), host

    chain(short)  # warm
    got, hosts, hidden = [], [], True
    for _ in range(reps):
        t_short, _ = chain(short)
        t_long, host = chain(long)
        got.append((t_long - t_short) / (long - short))
        hosts.append(host / long * 1e6)
        hidden = hidden and t_short > host * 1e3
    return {"ms": statistics.median(got), "host_us": statistics.mean(hosts),
            "host_hidden": hidden}


def card_kernel_ms(devices, streams, chunks, iters: int = 20) -> list:
    """Each card's own K2 time: the mean of CUDA events recorded on each
    peer's stream just before and just after the call (between the
    fence's waits a peer's stream holds only its own card's launch), over
    `iters` fenced gathers enqueued behind a gate on the caller's stream
    (as in `gated_ms`, so the host's enqueue stays out); one entry per
    distinct stream, in peer order."""
    import torch

    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather

    distinct = list(dict.fromkeys(streams))

    def marks():
        events = []
        for s in distinct:
            with torch.cuda.device(s.device):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(s)
            events.append(ev)
        return events

    runs = []
    for gated in (False, True):  # warm, then measured
        runs = []
        sync_all()
        if gated:
            with torch.cuda.device(devices[0]):
                torch.cuda._sleep(GATE_CYCLES)
        for _ in range(iters):
            def call():
                starts = marks()
                ring_all_gather(chunks, streams)
                runs.append(list(zip(starts, marks())))

            fence_around(devices, streams, call)
    sync_all()
    per = [[] for _ in distinct]
    for run in runs:
        for k, (start, end) in enumerate(run):
            per[k].append(start.elapsed_time(end))
    return [statistics.mean(p) for p in per]


def nccl_yardstick(devices, streams, chunks, iters: int = 20) -> dict:
    """`torch.cuda.nccl.all_gather` on the same chunks into preallocated
    outputs, its streams the peers', fenced and timed as K2's `ms`; or the
    words saying why there is no such time.  The port never calls it."""
    import torch
    from torch.cuda import nccl

    if not nccl.is_available(chunks):
        return {"nccl_ms": None, "nccl": "torch.cuda.nccl.is_available is "
                "False for these chunks (one contiguous CUDA tensor per "
                "card is needed, and a PyTorch built with NCCL)"}
    outs = [torch.empty((len(chunks) * c.shape[0], *c.shape[1:]),
                        dtype=c.dtype, device=c.device) for c in chunks]

    def call():
        nccl.all_gather(chunks, outs, streams=streams)

    fence_around(devices, streams, call)
    sync_all()
    whole = torch.cat([c.cpu() for c in chunks])
    if not all(torch.equal(o.cpu(), whole) for o in outs):
        raise AssertionError("torch.cuda.nccl.all_gather gave another "
                             "gather than the chunks'")
    return {"nccl_ms": cuda_ms(lambda: fence_around(devices, streams, call),
                               iters=iters),
            "nccl": "torch.cuda.nccl.all_gather"}


def time_k2_cross_card(devices, streams, chunks, hbm, link) -> dict:
    """K2 with one peer on each card at one chunk size: its `ms` (events
    on the caller's stream, every card fenced in and out), its graph
    marginal, each card's own kernel time, the NCCL and copy-engine
    yardsticks, beside the NVLink bound."""
    import torch

    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather
    from brpc_tpu_torch.ops.roofline import gather_cross_card_bound_ms

    from brpc_tpu_torch.tools.tune_echo import device_ms

    n = len(devices)
    chunk_bytes = chunks[0].numel() * chunks[0].element_size()

    def fenced():
        fence_around(devices, streams,
                     lambda: ring_all_gather(chunks, streams))

    # The copy engines' yardstick: card 0's chunk to every other card
    # (PyTorch's copy, on card 0's stream), one after another; timed with
    # events, as a copy between cards fences streams that a graph capture
    # does not hold.
    dsts = [torch.empty_like(chunks[0], device=d) for d in devices[1:]]

    def copy_one_to_rest():
        for d in dsts:
            d.copy_(chunks[0])

    t = {}
    for key, fn in (("ms", fenced), ("copy_one_to_rest_ms", copy_one_to_rest),
                    ("copy_one_to_rest_ms", copy_one_to_rest), ("ms", fenced)):
        t.setdefault(key, []).append(cuda_ms(fn, iters=20))
    out = {k: statistics.mean(v) for k, v in t.items()}
    out["card_kernel_ms"] = card_kernel_ms(devices, streams, chunks)
    try:
        out.update(nccl_yardstick(devices, streams, chunks))
    except RuntimeError as e:  # the yardstick's own failure, in words
        out.update(nccl_ms=None, nccl=f"torch.cuda.nccl.all_gather raised: "
                   f"{e}")
    # On the card alone: the marginal cost in CUDA graphs of 4 and 36
    # fenced calls (the peers' streams fork from and join the captured
    # stream), so the host's enqueue time drops out.
    out["graph_ms"] = device_ms(fenced)
    # The fence alone (the caller's stream to every peer's and back, a
    # kernel of no work on each peer's stream, so that a graph holds it),
    # in a graph and gated; and K2 and NCCL gated: the card's time in
    # eager launches, with the host's enqueue hidden.
    def nothing():
        for s in dict.fromkeys(streams):
            with torch.cuda.device(s.device), torch.cuda.stream(s):
                torch.cuda._sleep(0)

    def bare():
        fence_around(devices, streams, nothing)

    out["fence_graph_ms"] = device_ms(bare)
    out["gated"] = {"k2": gated_ms(devices, fenced),
                    "fence": gated_ms(devices, bare)}
    if out.get("nccl_ms") is not None:
        from torch.cuda import nccl

        outs = [torch.empty((n * c.shape[0], *c.shape[1:]), dtype=c.dtype,
                            device=c.device) for c in chunks]
        out["gated"]["nccl"] = gated_ms(devices, lambda: fence_around(
            devices, streams, lambda: nccl.all_gather(chunks, outs,
                                                      streams=streams)))
    bound = (gather_cross_card_bound_ms(n, chunk_bytes, hbm, link)
             if hbm and link else None)
    out.update(chunk_bytes=chunk_bytes, bound_ms=bound,
               bound_by="bytes (NVLink egress)",
               bound_frac=bound / out["graph_ms"]
               if bound and out["graph_ms"] else None,
               ms_bound_frac=bound / out["ms"] if bound else None)
    return out


def time_k2(devices, streams, card_name: str) -> dict:
    """K2 at n x 8 MiB on the peers' streams, fenced by the caller's
    stream, beside its bound and its plain version (and on one card, on
    one stream); across cards also at n x 32 MiB, with each card's own
    kernel time and the NCCL and copy-engine yardsticks."""
    import torch

    from brpc_tpu_torch.ops.ring_kernel import (ring_all_gather,
                                                ring_all_gather_plain)
    from brpc_tpu_torch.ops.roofline import (gather_bound_ms,
                                             hbm_peak_gbps,
                                             nvlink_peak_gbps)

    from brpc_tpu_torch.tools.tune_echo import device_ms

    n = len(devices)
    rows, cols = RING_CHUNK
    chunks = [torch.randn(rows, cols, device=d) for d in devices]
    chunk_bytes = rows * cols * 4
    cards = len(set(devices))
    hbm = hbm_peak_gbps(card_name)
    link = nvlink_peak_gbps(card_name)
    plain = statistics.mean(cuda_ms(lambda: ring_all_gather_plain(chunks),
                                    iters=10) for _ in range(2))
    if cards > 1:
        out = time_k2_cross_card(devices, streams, chunks, hbm, link)
        big = [torch.randn(4 * rows, cols, device=d) for d in devices]
        out["chunk_32mib"] = time_k2_cross_card(devices, streams, big, hbm,
                                                link)
        out["graph_4x_chunk_ms"] = out["chunk_32mib"]["graph_ms"]
        out.update(peers=n, cards=cards, plain_ms=plain)
        return out

    def fenced(parts=chunks):
        fence_around(devices, streams,
                     lambda: ring_all_gather(parts, streams))

    bound = gather_bound_ms(n, chunk_bytes, hbm) if hbm else None
    turns = [("ms", fenced, 20),
             ("one_stream_ms", lambda: ring_all_gather(chunks), 20)]
    t = {}
    for key, fn, iters in turns + turns[::-1]:
        t.setdefault(key, []).append(cuda_ms(fn, iters=iters))
    # On the card alone: the marginal cost in CUDA graphs of 4 and 36
    # fenced calls (the peers' streams fork from and join the captured
    # stream), so the host's enqueue time drops out.
    t["graph_ms"] = [device_ms(fenced)]
    t["one_stream_graph_ms"] = [device_ms(lambda: ring_all_gather(chunks))]
    out = {k: statistics.mean(v) for k, v in t.items()}
    # Apart: K2 at 4 x the chunk, so the per-byte rate shows without the
    # fixed cost of a gather.
    big = [torch.randn(4 * rows, cols, device=d) for d in devices]
    out["graph_4x_chunk_ms"] = device_ms(lambda: fenced(big))
    out.update(peers=n, cards=cards, chunk_bytes=chunk_bytes, plain_ms=plain,
               bound_ms=bound, bound_by="bytes",
               bound_frac=bound / out["graph_ms"] if bound else None)
    return out


def time_programs(fabric_of, devices, timed_reps: int) -> dict:
    """Host-clock seconds of K2 through the fabric, the N-to-N exchange,
    the data-plane step and the stream echo, on `devices`."""
    import numpy as np
    import torch

    from brpc_tpu_torch.models.echo import (make_full_dataplane_step,
                                            make_nton_exchange)
    from brpc_tpu_torch.ops.ring_kernel import ring_all_gather_kernel
    from brpc_tpu_torch.streaming import stream_echo

    n = len(devices)
    ring = fabric_of((n,), ("link",))
    rng = np.random.default_rng(3)
    rows, cols = RING_CHUNK
    k2 = ring_all_gather_kernel(ring, "link")
    chunks = ring.put(torch.randn((n * rows, cols)), "link")
    lanes = PEER_BYTES // 4 // n
    local = ring.put(torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=(n * n, lanes), dtype=np.int32)), "link")
    nton = make_nton_exchange(ring, "link")
    mesh = fabric_of((2, n // 2), ("dp", "link"))
    payload = mesh.put(torch.from_numpy(rng.integers(
        0, 4, size=STEP_PAYLOAD).astype(np.float32)), "link", None)
    step = make_full_dataplane_step(mesh, "dp", "link")
    sent = ring.put(torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=(STREAM_CHUNKS, n * STREAM_LANES),
        dtype=np.int32)), None, "link")
    totals = ring.put(torch.zeros(n, dtype=torch.int32), "link")
    echo = stream_echo(ring, "link", STREAM_CHUNKS)
    out = {}
    for key, fn in (("fabric_k2_s", lambda: k2(chunks)),
                    ("nton_s", lambda: nton(local.view(torch.uint32))),
                    ("step_s", lambda: step(payload)),
                    ("stream_s", lambda: echo(sent.view(torch.uint32),
                                              totals.view(torch.uint32)))):
        reps = host_s(fn, timed_reps)
        out[key] = statistics.mean(reps)
        out[key + "_all"] = reps
    return out


def run(args) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool measures the card")
    from brpc_tpu_torch.parallel import Fabric

    card = card_line()
    devices = peer_devices(args.cards)
    row = {"card": card, "device_count": torch.cuda.device_count(),
           "root": os.path.abspath(args.root) if args.root else None,
           "devices": [str(d) for d in devices]}

    def fabric_of(shape, names):
        return Fabric.auto(shape, names, devices=(
            devices if len(set(devices)) > 1 else devices[0]))

    ring = fabric_of((len(devices),), ("link",))
    streams = list(getattr(ring, "streams", ()))
    row["streams"] = len(set(streams))
    print(f"card: {card}; peers {len(devices)} on {row['devices']}; "
          f"{row['streams']} peer streams", flush=True)
    if streams:  # this checkout's plane: check before timing
        from brpc_tpu_torch.graft_entry import dryrun_multichip

        t0 = time.perf_counter()
        # A second set of peer streams gathers right behind the first's.
        checked = check_k2_streams(devices, streams, args.repeat, also=[
            [torch.cuda.Stream(d) for d in devices]])
        check_k2_fabric(ring, args.repeat)
        small = devices if len(set(devices)) > 1 else devices[0]
        for _ in range(args.repeat):
            dryrun_multichip(len(devices), device=small)
        row["checks"] = {"k2_stream_compares": checked,
                         "repeats": args.repeat,
                         "s": time.perf_counter() - t0}
        print(f"checks: {row['checks']}", flush=True)
        row["k2"] = time_k2(devices, streams, torch.cuda.get_device_name(0))
        print(f"K2: {row['k2']}", flush=True)
    row["programs"] = time_programs(fabric_of, devices, args.reps)
    print(f"programs: {row['programs']}", flush=True)
    row["card_after"] = card_line()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", choices=("1", "all"), default="1")
    ap.add_argument("--repeat", type=int, default=10,
                    help="repetitions of each check")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls of each program")
    ap.add_argument("--root", help="import brpc_tpu_torch from this tree")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", help="also write the row here as JSON")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    if sys.path and os.path.abspath(sys.path[0]) == here:
        del sys.path[0]  # run as a file: the tools are no top-level modules
    sys.path.insert(0, os.path.abspath(args.root or os.path.join(
        here, "..", "..")))
    row = run(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    if args.json:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
