"""Closed-loop echo from the card over the RPC stack (the echo_loopback
deployment).

Rewritten from the batch goodput leg of the port's bench
(`brpc_tpu_torch/tools/bench.py`, `_rpc_batch_goodput`), with the window
set by `--seconds` instead of 1 s.  A native echo server and a client share
the host, over loopback tcp.  PAYLOADS payloads of `payload_bytes` in uint32
lanes are made on the card from the seed.  The entry the window drives is
`EchoPipeline`: it makes its payload's response copy and checksum with K1,
keeps calls of it on a batch pipeline, lands each response in a recycled
pinned buffer, copies it back to the card and checksums it there with K1.

The window is a closed loop of `inflight` calls, refilled as calls drain,
in turns.  Each turn is one EchoPipeline on the one channel, with the next
payload and the landing buffers that the turn before last used, so that
each buffer holds another payload's bytes before a turn's response lands in
it.  After `calls_per_payload` completions the next turn takes the refills
while the last one drains, so for a while two payloads are in flight on the
channel.  When the window's time is up the loop stops refilling and drains
the tail; the window ends in a synchronise of the card.

Mix keys: payload_bytes, inflight, calls_per_payload, warm_windows,
check_sum_every and check_bytes_every (one call in that many, drawn from the
seed, has its checksum or its bytes compared with its own payload's, at most
keep_bytes_max of the latter; the first `inflight` calls of every turn have
their checksums compared, those of the first turn and the last call their
bytes too), trace_slice_s.
"""

from __future__ import annotations

import array
import collections
import random
import time

import torch

from rpcbench import reference
from rpcbench.harness import Check, Window, reserve

#: Distinct payloads, taken by the turns in order: three, so that the turn
#: whose landing buffers a turn takes over sent another payload.
PAYLOADS = 3
#: How long one poll waits for a completion before the loop looks at the
#: clock again; while two turns are in flight, how long it waits on the
#: older before it looks at the newer.
POLL_MS = 1000
OVERLAP_POLL_MS = 1
#: A drain that sees no completion for this long ends: the rest never came.
DRAIN_TIMEOUT_S = 60.0
#: Checksums held for the check, stacked on the card in groups of
#: SUM_GROUP into one buffer made in set-up.
SUMS_MAX = 1 << 16
SUM_GROUP = 256


class _Turn:
    """One EchoPipeline of the window, its payload's index, and its calls'
    (submit time, tracer epoch), oldest first."""

    def __init__(self, index: int, pipe, payload: int):
        self.index, self.pipe, self.payload = index, pipe, payload
        self.pending = collections.deque()
        self.done = 0


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        mix, config = ctx.mix, ctx.config
        self.size = int(mix["payload_bytes"])
        self.depth = int(mix["inflight"])
        self.turn_calls = int(mix["calls_per_payload"])
        self.lanes = self.size // 4
        self.conn = ("pooled" if self.size >= int(config["pooled_from_bytes"])
                     else "single")
        self.device = ctx.devices[0]
        self.rng = random.Random(ctx.seed)
        self.srv = self.ch = self.turn = None
        self.keep_max = int(mix.get("keep_bytes_max", 16))
        self.p_sum = 1.0 / float(mix.get("check_sum_every", 1))
        self.p_bytes = 1.0 / float(mix.get("check_bytes_every", 64))
        self.backs = []    # (payload index, echoed tensor) for the check
        self.copies = []   # (payload index, K1's copy) of the first turns
        self.sums = None   # int32[SUMS_MAX] on the card
        self.sum_payload = array.array("b")  # payload index of each sum
        self._group = []   # checksums not yet stacked into self.sums
        self._held = 0     # checksums stacked
        self.served0 = self.served = 0
        self.last = None
        self.window = None

    def _tile(self):
        from brpc_tpu_torch.ops.echo_kernel import _BLOCK, _COLS, _ROWS

        return (_ROWS, _COLS) if self.lanes % _BLOCK == 0 else (1, self.lanes)

    def setup(self) -> None:
        from brpc_tpu_torch.models.echo import (EchoPipeline,
                                                rpc_batch_echo_step)
        from brpc_tpu_torch.rpc import Channel, Server

        cfg, dev = self.ctx.config, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.ctx.seed % (1 << 64))
        self.payloads = torch.randint(
            -(1 << 31), 1 << 31, (PAYLOADS, self.lanes), dtype=torch.int32,
            device=dev, generator=gen).view(torch.uint32)
        self.srv = Server()
        self.srv.register_native_echo(cfg["method"])
        self.srv.start(0)
        self.ch = Channel(f"{cfg['host']}:{self.srv.port}",
                          timeout_ms=int(cfg["timeout_ms"]),
                          connection_type=self.conn)
        cuda = dev.type == "cuda"
        self.bufs = [[torch.empty(self.size, dtype=torch.uint8,
                                  pin_memory=cuda)
                      for _ in range(self.depth)] for _ in range(2)]
        self.tile = self._tile()
        # Warm windows (untimed): connections, pools, both buffer sets, K1.
        for i in range(int(self.ctx.mix.get("warm_windows", 2))):
            echoed, _, _ = rpc_batch_echo_step(
                self.ch, self.payloads[i % PAYLOADS], self.depth,
                self.bufs[i % 2], method=cfg["method"], rows=self.tile[0],
                cols=self.tile[1])
            del echoed
        # Outputs kept for the check come from cached blocks.
        if self.size >= 1 << 20:
            reserve(dev, self.size,
                    2 * self.depth + self.keep_max + PAYLOADS + 2)
        self.sums = torch.zeros(SUMS_MAX, dtype=torch.int32, device=dev)
        self.make = self.ctx.system or EchoPipeline
        self.turn = self._new_turn(0)
        self.ctx.sync()

    def _new_turn(self, index: int) -> _Turn:
        k = index % PAYLOADS
        pipe = self.make(self.ch, self.payloads[k], self.bufs[index % 2],
                         method=self.ctx.config["method"], rows=self.tile[0],
                         cols=self.tile[1])
        if index < PAYLOADS:
            self.copies.append((k, pipe.copy))
        return _Turn(index, pipe, k)

    def _close(self, turn: _Turn) -> None:
        self._hold_sum(turn.payload, turn.pipe.sent)
        turn.pipe.close()

    def _served(self) -> int:
        """Calls the native server has answered so far."""
        from brpc_tpu_torch.rpc import observe

        name = f"rpc_server_{self.ctx.config['method']}"
        return observe.Latency.read(name).count

    def _hold_sum(self, payload: int, csum) -> None:
        if len(self.sum_payload) >= SUMS_MAX:
            return
        self._group.append(csum.view(torch.int32))
        self.sum_payload.append(payload)
        if len(self._group) == SUM_GROUP:
            self._stack()

    def _stack(self) -> None:
        """Stacks the held checksums into self.sums (one launch)."""
        n = len(self._group)
        if n:
            torch.stack(self._group, out=self.sums[self._held:self._held + n])
            self._held += n
            self._group = []

    def warm_step(self) -> None:
        pipe = self.turn.pipe
        pipe.submit(1)
        while pipe.inflight:
            pipe.poll(max_n=1, timeout_ms=int(self.ctx.config[
                "timeout_ms"]))

    def _submit(self, turn: _Turn, k: int) -> None:
        ts = time.perf_counter()
        with self.ctx.span("rpcbench.submit"):
            turn.pipe.submit(k)
        turn.pending.extend([(ts, self.ctx.tracer.epoch)] * k)

    def _poll(self, turn: _Turn, w: Window, timeout_ms: int) -> int:
        """Drains what `turn` has (waiting up to timeout_ms) and samples
        it for the check; returns the completions, or -1 on a failure."""
        ctx, rng, depth = self.ctx, self.rng, self.depth
        before = turn.pipe.inflight
        try:
            with ctx.span("rpcbench.poll"):
                out = turn.pipe.poll(max_n=depth, timeout_ms=timeout_ms)
        except Exception as e:  # noqa: BLE001 - a failed call, counted
            w.errors.append(f"{type(e).__name__}: {e}")
            lost = before - turn.pipe.inflight
            for _ in range(min(lost, len(turn.pending))):
                turn.pending.popleft()
            return -1
        now = time.perf_counter()
        for back, csum in out:
            ts, epoch = turn.pending.popleft()
            if ctx.tracer.quiet(epoch):
                w.latencies_s.append(now - ts)
            if turn.done < depth or rng.random() < self.p_sum:
                self._hold_sum(turn.payload, csum)
            if (turn.index == 0 and turn.done < depth) or (
                    rng.random() < self.p_bytes
                    and len(self.backs) < depth + self.keep_max):
                self.backs.append((turn.payload, back))
            self.last = (turn.payload, back)
            turn.done += 1
            w.completed += 1
        return len(out)

    def run_window(self) -> Window:
        ctx, depth = self.ctx, self.depth
        w = Window(bytes_per_call=self.size)
        # Landing buffers start poisoned, so a response that never lands
        # in its buffer cannot pass for one that did.
        for b in self.bufs[0] + self.bufs[1]:
            b.fill_(0xA5)
        self.served0 = self._served()
        cur, old = self.turn, None
        ctx.sync()
        t0 = ctx.begin_window(w)
        self._submit(cur, depth)
        w.attempted = depth
        submitting, progress = True, t0
        while cur.pipe.inflight or old is not None:
            if old is not None and not old.pipe.inflight:
                self._close(old)
                old = None
            if old is not None:
                n = self._poll(old, w, OVERLAP_POLL_MS)
                m = self._poll(cur, w, 0) if n >= 0 and cur.pipe.inflight \
                    else 0
                n = -1 if m < 0 else n + m
            else:
                n = self._poll(cur, w, POLL_MS)
            now = time.perf_counter()
            if n < 0:
                submitting = False  # drain what is left, stop refilling
                continue
            if n == 0:
                if now - progress > DRAIN_TIMEOUT_S:
                    break  # the rest never came back
                continue
            progress = now
            if submitting and now - t0 >= ctx.seconds:
                submitting = False  # drain the tail, stop refilling
            if submitting:
                if old is None and cur.done >= self.turn_calls:
                    old, cur = cur, self._new_turn(cur.index + 1)
                self._submit(cur, n)
                w.attempted += n
            ctx.tick(w.completed)
        self._stack()
        ctx.sync()
        w.seconds = time.perf_counter() - t0
        w.missing = w.attempted - w.completed  # never came back, or failed
        if old is not None:  # a drain that timed out
            self._close(old)
        if self.last is not None:
            self.backs.append(self.last)
        self.turn = cur
        if self.device.type == "cuda":
            held = [b for _, b in self.backs] + [
                c for i, (_, c) in enumerate(self.copies) if i != cur.index]
            w.kept_bytes[self.device.index] = (
                sum(t.numel() * t.element_size()
                    for t in {id(t): t for t in held}.values())
                + self.sums.numel() * self.sums.element_size())
        self.window = w
        return w

    def release(self) -> None:
        self.served = self._served() - self.served0
        self._close(self.turn)
        self.turn = None
        self.ch.close()
        self.srv.stop()
        self.srv.close()
        self.ch = self.srv = None
        self.bufs = None

    def check(self) -> list:
        """Every held checksum (K1's of sampled calls, and each turn's sent
        one) against the reference's wrapping sum of its own payload; every
        sampled call's bytes, and K1's copy of each payload, against that
        payload; every call came back, and the server answered each."""
        want = [reference.wrapping_sum(reference.u32_lanes(p))
                for p in self.payloads]
        self._stack()
        got = reference.u32_lanes(self.sums[:self._held]).tolist()
        bad_sums = sum(1 for g, k in zip(got, self.sum_payload)
                       if g != want[k])
        bad_bytes = sum(1 for k, b in self.backs
                        if not reference.same_bytes(b, self.payloads[k]))
        bad_copies = sum(1 for k, c in self.copies
                         if not reference.same_bytes(c, self.payloads[k]))
        w = self.window
        unserved = max(0, w.completed - self.served)
        n_bytes = len(self.backs) + len(self.copies)
        self.sums = self.backs = self.copies = None
        return [
            Check("bad_checksums", bad_sums, 0, compared=len(got),
                  calls_failed=bad_sums),
            Check("bad_echoes", bad_bytes + bad_copies, 0, compared=n_bytes,
                  calls_failed=bad_bytes),
            Check("missing_calls", w.missing, 0, compared=w.attempted),
            Check("unserved_calls", unserved, 0, compared=w.completed,
                  calls_failed=unserved),
        ]
