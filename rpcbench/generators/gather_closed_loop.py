"""Closed-loop all-gather of one chunk per peer, one peer on each card
(the nton_4card deployment).

The entry the window drives is `brpc_tpu_torch.ops.ring_kernel
.ring_all_gather`, called from Python as a caller would call it: one chunk
per card, each on its card's current stream, no CUDA graph.  Each call
gathers every chunk into every card's own output.  The loop keeps at most
`inflight` gathers on the cards (it waits for the gather `inflight` before
the next, by an event on the first card's stream) until the window's time
is up; the window ends in a synchronise of every card.

The chunks are float32, made on each card from the seed, in CHUNK_SETS
sets that the steps take in turn, so that an output left as an earlier
step wrote it does not pass for this step's.

Mix keys: chunk_bytes, cols, inflight, check_every (one step in that many,
drawn from the seed, has every card's output compared, at most KEEP_MAX
steps; the last step always), and trace_slice_s.
"""

from __future__ import annotations

import collections
import random
import time

import torch

from rpcbench import reference
from rpcbench.harness import Check, Window, reserve

#: Sets of chunks the steps take in turn.
CHUNK_SETS = 3
#: Sampled steps whose outputs are kept for the check (the last besides).
KEEP_MAX = 8
#: Untimed gathers in set-up (the plan, the flags, the cached outputs).
WARM_STEPS = 6


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.n = int(ctx.config["peers"])
        if len(ctx.devices) != self.n:
            raise ValueError(f"{self.n} peers on {len(ctx.devices)} devices")
        self.cols = int(mix["cols"])
        self.rows = int(mix["chunk_bytes"]) // (4 * self.cols)
        self.inflight = int(mix["inflight"])
        self.rng = random.Random(ctx.seed)
        self.kept = []  # (step, chunk set, outputs)
        self.window = None

    def setup(self) -> None:
        from brpc_tpu_torch.ops.ring_kernel import ring_all_gather

        ctx = self.ctx
        self.gather = ctx.system or ring_all_gather
        gens = []
        for r, dev in enumerate(ctx.devices):
            g = torch.Generator(device=dev)
            g.manual_seed((ctx.seed * 1_000_003 + r) % (1 << 64))
            gens.append(g)
        self.sets = [[torch.randn(self.rows, self.cols, device=dev,
                                  generator=gens[r])
                      for r, dev in enumerate(ctx.devices)]
                     for _ in range(CHUNK_SETS)]
        out_bytes = self.n * self.rows * self.cols * 4
        for dev in dict.fromkeys(ctx.devices):
            reserve(dev, out_bytes, self.inflight + KEEP_MAX + 3)
        for step in range(WARM_STEPS):
            self.gather(self.sets[step % len(self.sets)])
        ctx.sync()

    def warm_step(self) -> None:
        self.gather(self.sets[0])
        self.ctx.sync()

    def _done_event(self):
        if not self.ctx.cuda:
            return None
        return torch.cuda.current_stream(self.ctx.devices[0]).record_event()

    def run_window(self) -> Window:
        ctx = self.ctx
        p_keep = 1.0 / float(ctx.mix.get("check_every", 4000))
        sets, nsets = self.sets, len(self.sets)
        w = Window(bytes_per_call=self.n * self.rows * self.cols * 4)
        enqueue = w.spans.setdefault("ring_all_gather", [])
        events = collections.deque()
        tracer = ctx.tracer
        step, outs = 0, None
        ctx.sync()
        t0 = ctx.begin_window(w)
        while time.perf_counter() - t0 < ctx.seconds:
            if len(events) >= self.inflight:
                with ctx.span("rpcbench.wait"):
                    ev = events.popleft()
                    if ev is not None:
                        ev.synchronize()
            chunks = sets[step % nsets]
            with ctx.span("rpcbench.gather"):
                ts = time.perf_counter()
                outs = self.gather(chunks)
                te = time.perf_counter()
            if not tracer.active:
                enqueue.append(te - ts)
            events.append(self._done_event())
            if len(self.kept) < KEEP_MAX and self.rng.random() < p_keep:
                self.kept.append((step, step % nsets, outs))
            step += 1
            ctx.tick(step)
        ctx.sync()
        w.seconds = time.perf_counter() - t0
        w.attempted = w.completed = step
        if outs is not None:
            self.kept.append((step - 1, (step - 1) % nsets, outs))
        held = {id(o): o for _, _, kept in self.kept for o in kept}
        for out in held.values():
            if out.device.type == "cuda":
                w.kept_bytes[out.device.index] = (
                    w.kept_bytes.get(out.device.index, 0)
                    + out.numel() * out.element_size())
        self.window = w
        return w

    def release(self) -> None:
        self.gather = None

    def check(self) -> list:
        """Every card's output of every sampled step, the last among them,
        against the reference's gather of that step's chunks."""
        want = {}
        bad, compared, bad_steps = 0, 0, set()
        for step, s, outs in self.kept:
            if len(outs) != self.n:  # outputs that never came
                bad += abs(self.n - len(outs))
                bad_steps.add(step)
            for r, out in enumerate(outs[:self.n]):
                dev = self.ctx.devices[r]
                key = (s, r)
                if key not in want:
                    want[key] = reference.gathered(self.sets[s], dev)
                compared += 1
                if not reference.same_bytes(out, want[key]):
                    bad += 1
                    bad_steps.add(step)
        self.kept = None
        return [Check("bad_outputs", bad, 0, compared=compared,
                      calls_failed=len(bad_steps))]
