"""A prepared submit's two request modes, timed against each other: the
runtime copying each call's request inside the submit's crossing (no pin,
no deleter), and each call referencing the request's bytes with a pin and
a deleter that takes the GIL on a native thread when the runtime drops
them.  `batch.COPY_REQUEST_MAX` is set from this.

One native echo server and a channel in this process, over loopback tcp.
At each size, and in each mode, a closed loop of `--depth` calls of one
request (pinned host memory where there is a card) into as many landing
buffers, `--calls` completions, through the batch's one native submit
(`Batch._issue`) with the arguments a prepared submit passes.  The modes
take turns (copy, reference, reference, copy); the result is the median of
each mode's rounds.  Prints
one JSON line: per size, calls/s and the host microseconds a call spent in
the submit (pins and crossing) in each mode.

    python -m brpc_tpu_torch.tools.request_copy
        [--sizes 1024,16384,65536,262144] [--calls 20000] [--depth 64]
        [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time

import torch

from brpc_tpu_torch.rpc import Channel, Server, zerocopy
from brpc_tpu_torch.rpc.batch import COPY_REQUEST_MAX

MODES = ("copy", "reference")


def _loop(ch, mode: str, request, bufs, calls: int) -> tuple[float, float]:
    """(calls/s, host us a call in the submit) of one closed loop."""
    b = ch.pipeline()
    n = len(bufs)
    flat = request.numpy()
    reqs = (ctypes.c_void_p * n)(*[flat.ctypes.data] * n)
    lens = (ctypes.c_size_t * n)(*[flat.nbytes] * n)
    free = [(buf.data_ptr(), buf.numel()) for buf in bufs]
    rb, rc = (ctypes.c_void_p * n)(), (ctypes.c_size_t * n)()
    ctxs, tokens = (ctypes.c_void_p * n)(), (ctypes.c_uint64 * n)()
    deleter = ctypes.cast(zerocopy.release_cb, ctypes.c_void_p)
    by_token, done, submitted, in_submit = {}, 0, 0, 0

    def submit(k: int) -> None:
        nonlocal submitted, in_submit
        t0 = time.perf_counter_ns()
        taken = [free.pop() for _ in range(k)]
        for i, (addr, cap) in enumerate(taken):
            rb[i], rc[i] = addr, cap
        if mode == "copy":
            out = b._issue(b"Echo.Echo", reqs, lens, rb, rc, k, 0, None,
                           None, tokens, [])
        else:
            pins = [zerocopy.pin(flat, request) for _ in range(k)]
            ctxs[:k] = pins
            out = b._issue(b"Echo.Echo", reqs, lens, rb, rc, k, 0, deleter,
                           ctxs, tokens, pins)
        in_submit += time.perf_counter_ns() - t0
        by_token.update(zip(out, taken))
        submitted += k

    try:
        t0 = time.perf_counter()
        submit(n)
        while done < calls:
            got = b.poll(max_n=n, timeout_ms=10000)
            if not got:
                raise RuntimeError("no completion in 10 s")
            for c in got:
                if not c.ok or c.resp_len != flat.nbytes:
                    raise RuntimeError(f"a call failed: {c!r}")
                free.append(by_token.pop(c.token))
            done += len(got)
            k = min(len(got), calls - submitted)
            if k > 0:
                submit(k)
        took = time.perf_counter() - t0
    finally:
        b.close()
    return done / took, in_submit / 1e3 / submitted


def measure(sizes, calls: int, depth: int, rounds: int) -> dict:
    cuda = torch.cuda.is_available()
    srv = Server()
    srv.register_native_echo("Echo.Echo")
    srv.start(0)
    ch = Channel(f"127.0.0.1:{srv.port}", timeout_ms=10000,
                 connection_type="single")
    rows = []
    try:
        for size in sizes:
            request = torch.randint(0, 256, (size,), dtype=torch.uint8)
            if cuda:
                request = request.pin_memory()
            bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
                    for _ in range(depth)]
            got = {m: [] for m in MODES}
            _loop(ch, "copy", request, bufs, depth * 4)  # warm
            for _ in range(rounds):
                for mode in MODES + MODES[::-1]:
                    got[mode].append(_loop(ch, mode, request, bufs, calls))
            row = {"bytes": size}
            for mode in MODES:
                row[f"{mode}_calls_per_s"] = statistics.median(
                    r for r, _ in got[mode])
                row[f"{mode}_submit_us_per_call"] = statistics.median(
                    u for _, u in got[mode])
            rows.append(row)
    finally:
        ch.close()
        srv.stop()
        srv.close()
    return {"tool": "request_copy", "copy_request_max": COPY_REQUEST_MAX,
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "calls": calls, "depth": depth, "rounds": rounds, "sizes": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1024,16384,65536,262144")
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    print(json.dumps(measure(sizes, args.calls, args.depth, args.rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
