"""Two QoS classes of echo from the card on one server (the qos_lanes_echo
deployment).

Rewritten from the port's mixed-workload QoS row (`brpc_tpu_torch/tools/
bench.py`, `_child_qos_mixed`) with both classes driving the card.  One
native echo server runs with the QoS priority lanes on (the configuration's
`flags`, set in set-up and restored after) and its tenant governor
(`governor`).  Each class has its own tagged channel to it (`classes`:
tenant, priority, connection type) and its own payloads from the seed, and
runs on a thread of its own:

- the latency class (mix key `latency`) is `echo_closed_loop`'s window: a
  closed loop of `inflight` calls in turns over EchoPipelines, on the main
  thread, which alone calls `ctx.tick`; its completions and latencies are
  the window's (`completed`, `latencies_s`, `bytes_per_call`);
- the bulk class (mix key `bulk`) is an open loop paced at `rate_hz`: at
  every slot from the window's start it lands what has completed, without
  waiting, and puts one call in flight, unless `inflight` are in flight
  still, and then the slot is skipped, not bunched.  Between slots its
  thread sleeps: it wakes once a slot, not at every completion as well,
  and so takes the GIL from the latency class half as often.  Its calls
  take the same turns as the latency class's.  Its window hangs off the
  latency class's as `Window.bulk`.

`attempted` and `missing` count both classes' calls.  The generator makes
no stream and no event: keeping the classes apart on the card is the
program's work.  The check holds each class to its own payloads (sampled
bytes, checksums, K1's copies), to calls missing and unserved, to the
server's lanes (each class's calls dispatched from its own lane, no other
lane used and nothing shed, as deltas of the native `qos_lane_dispatch_<n>`
and `qos_shed_total` over the window), and to progress: each class
completes calls in every `progress_s` (default the harness's PROGRESS_S)
of the window.

Mix keys: `latency` and `bulk`, each with echo_closed_loop's keys
(payload_bytes, inflight, calls_per_payload, warm_windows,
check_sum_every, check_bytes_every, keep_bytes_max), `bulk` with rate_hz;
progress_s; trace_slice_s.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from rpcbench.generators import echo_closed_loop as closed
from rpcbench.harness import PROGRESS_S, Check, Context, Window, reserve


def _var(name: str) -> int:
    """A native counter by name; 0 where the runtime has not made it."""
    from brpc_tpu_torch.rpc import observe

    try:
        return int(observe.Vars.read(name))
    except KeyError:
        return 0


class _ClassContext(Context):
    """One class's view of the run: its own mix, configuration and seed.
    The latency class's also starts the bulk class's window with its own
    and notes, at each tick, the progress interval it completed calls in."""

    started: threading.Event
    t0: float
    every: float
    seen: set

    def begin_window(self, window: Window) -> float:
        self.t0 = super().begin_window(window)
        self.started.set()
        return self.t0

    def tick(self, completed: int) -> None:
        super().tick(completed)
        self.seen.add(int((time.perf_counter() - self.t0) // self.every))


def _class_context(ctx, name: str, seed: int, every: float):
    cfg = ctx.config
    # The class names its connection type; echo_closed_loop's size rule
    # (pooled_from_bytes) is given a value only to be overruled.
    config = dict(cfg, **cfg["classes"][name], pooled_from_bytes=0)
    fields = {f.name: getattr(ctx, f.name)
              for f in dataclasses.fields(Context)}
    sub = _ClassContext(**dict(fields, mix=ctx.mix[name], config=config,
                               seed=seed))
    sub.started, sub.every, sub.seen = threading.Event(), every, set()
    return sub


class _Class(closed.Workload):
    """One class: echo_closed_loop's workload over a channel and server
    that the deployment shares, its calls served from its own lane."""

    def __init__(self, ctx, name: str, lanes: int):
        super().__init__(ctx)
        self.name = name
        self.conn = ctx.config["connection_type"]
        self.lane = min(int(ctx.config["priority"]), lanes - 1)

    def setup(self, srv, ch) -> None:
        """echo_closed_loop's set-up on the shared server and channel."""
        from brpc_tpu_torch.models.echo import (EchoPipeline,
                                                rpc_batch_echo_step)

        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.ctx.seed % (1 << 64))
        self.payloads = torch.randint(
            -(1 << 31), 1 << 31, (closed.PAYLOADS, self.lanes),
            dtype=torch.int32, device=dev, generator=gen).view(torch.uint32)
        self.srv, self.ch = srv, ch
        self.bufs = [[torch.empty(self.size, dtype=torch.uint8,
                                  pin_memory=dev.type == "cuda")
                      for _ in range(self.depth)] for _ in range(2)]
        self.tile = self._tile()
        for i in range(int(self.ctx.mix.get("warm_windows", 2))):
            rpc_batch_echo_step(
                ch, self.payloads[i % closed.PAYLOADS], self.depth,
                self.bufs[i % 2], method=self.ctx.config["method"],
                rows=self.tile[0], cols=self.tile[1])
        if self.size >= 1 << 20:
            reserve(dev, self.size,
                    2 * self.depth + self.keep_max + closed.PAYLOADS + 2)
        self.sums = torch.zeros(closed.SUMS_MAX, dtype=torch.int32,
                                device=dev)
        self.make = self.ctx.system or EchoPipeline
        self.turn = self._new_turn(0)
        self.ctx.sync()

    def _served(self) -> int:
        """Calls the server has dispatched from this class's lane."""
        return _var(f"qos_lane_dispatch_{self.lane}")

    def release(self) -> None:
        self.served = self._served() - self.served0
        self._close(self.turn)
        self.turn = self.bufs = None

    def starved(self) -> int:
        """Whole progress intervals of the window with no completion."""
        ctx = self.ctx
        return sum(1 for k in range(int(ctx.seconds // ctx.every))
                   if k not in ctx.seen)


class _Paced(_Class):
    """The bulk class: an open loop paced at `rate_hz`, on its own thread,
    whose window starts with the latency class's (`starts_with`)."""

    def __init__(self, ctx, name: str, lanes: int, starts_with):
        super().__init__(ctx, name, lanes)
        self.period = 1.0 / float(ctx.mix["rate_hz"])
        self.starts_with = starts_with

    def prepare(self) -> None:
        """Before the window: landing buffers poisoned, as the latency
        class's are, and the lane's count read."""
        for b in self.bufs[0] + self.bufs[1]:
            b.fill_(0xA5)
        self.served0 = self._served()

    def run_window(self) -> Window:
        ctx = self.ctx
        w = Window(bytes_per_call=self.size)
        self.starts_with.started.wait()
        t0 = w.started = self.starts_with.t0
        cur, old = self.turn, None
        due = progress = t0  # the next slot; the last completion
        submitting = True
        while True:
            if old is not None and not old.pipe.inflight:
                self._close(old)
                old = None
            now = time.perf_counter()
            submitting = submitting and now - t0 < ctx.seconds
            busy = cur.pipe.inflight + (old.pipe.inflight if old else 0)
            if not submitting and not busy:
                break
            if submitting and now < due:
                time.sleep(due - now)  # to the slot, GIL free
                continue
            # At a slot, what has completed is landed without waiting;
            # in the drain, the loop waits for it.
            wait_ms = 0 if submitting else closed.POLL_MS
            n = 0
            if busy:
                if old is not None:
                    n = self._poll(old, w, min(wait_ms,
                                               closed.OVERLAP_POLL_MS))
                    m = self._poll(cur, w, 0) if n >= 0 and \
                        cur.pipe.inflight else 0
                    n = -1 if m < 0 else n + m
                else:
                    n = self._poll(cur, w, wait_ms)
            now = time.perf_counter()
            if n < 0:
                submitting = False  # drain what is left, stop sending
                continue
            if n > 0:
                progress = now
                ctx.seen.add(int((now - t0) // ctx.every))
            elif not submitting and now - progress > closed.DRAIN_TIMEOUT_S:
                break  # the rest never came back
            if submitting:
                # The slots that passed are not made up, nor is one that
                # finds `inflight` calls in flight.
                due += (int((now - due) / self.period) + 1) * self.period
                if cur.pipe.inflight + (old.pipe.inflight if old else 0) \
                        < self.depth:
                    if old is None and cur.done >= self.turn_calls:
                        old, cur = cur, self._new_turn(cur.index + 1)
                    self._submit(cur, 1)
                    w.attempted += 1
        self._stack()
        w.seconds = time.perf_counter() - t0
        w.missing = w.attempted - w.completed
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


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg = ctx.config
        every = float(ctx.mix.get("progress_s", PROGRESS_S))
        lanes = int(cfg["flags"]["trpc_qos_lanes"])
        self.lanes = lanes
        fg = _class_context(ctx, "latency", 2 * ctx.seed, every)
        self.fg = _Class(fg, "latency", lanes)
        self.bulk = _Paced(_class_context(ctx, "bulk", 2 * ctx.seed + 1,
                                          every), "bulk", lanes, fg)
        self.classes = (self.fg, self.bulk)
        self.srv = self.saved = None
        self.others = ()     # (name, count at the window's start)
        self.others_moved = 0
        self.bulk_out = None  # the bulk thread's window, or its exception

    def setup(self) -> None:
        from brpc_tpu_torch.rpc import Channel, Server, get_flag, set_flag

        cfg = self.ctx.config
        self.saved = {k: get_flag(k) for k in cfg["flags"]}
        for k, v in cfg["flags"].items():
            set_flag(k, str(v))
        self.srv = Server()
        self.srv.register_native_echo(cfg["method"])
        self.srv.set_qos(cfg["governor"])
        self.srv.start(0)
        for cls in self.classes:
            c = cls.ctx.config
            cls.setup(self.srv, Channel(
                f"{cfg['host']}:{self.srv.port}",
                timeout_ms=int(cfg["timeout_ms"]),
                connection_type=c["connection_type"],
                qos_tenant=c["tenant"], qos_priority=int(c["priority"])))

    def warm_step(self) -> None:
        self.fg.warm_step()

    def _bulk_thread(self) -> None:
        try:
            self.bulk_out = self.bulk.run_window()
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            self.bulk_out = e

    def run_window(self) -> Window:
        used = {self.fg.lane, self.bulk.lane}
        names = [f"qos_lane_dispatch_{i}" for i in range(self.lanes)
                 if i not in used] + ["qos_shed_total"]
        self.others = [(n, _var(n)) for n in names]
        self.bulk.prepare()
        bulk = threading.Thread(target=self._bulk_thread, daemon=True,
                                name="rpcbench-bulk")
        bulk.start()
        w = self.fg.run_window()
        bulk.join(self.ctx.seconds + closed.DRAIN_TIMEOUT_S + 60.0)
        if bulk.is_alive():
            raise RuntimeError("the bulk class never drained")
        if isinstance(self.bulk_out, BaseException):
            raise self.bulk_out
        b = self.bulk_out
        self.ctx.sync()
        self.fg.window = dataclasses.replace(w)  # the latency class alone
        w.seconds = time.perf_counter() - w.started
        w.attempted += b.attempted
        w.missing += b.missing
        w.errors = w.errors + [f"bulk: {e}" for e in b.errors]
        w.kept_bytes = {d: w.kept_bytes.get(d, 0) + b.kept_bytes.get(d, 0)
                        for d in {*w.kept_bytes, *b.kept_bytes}}
        w.bulk = b
        return w

    def release(self) -> None:
        from brpc_tpu_torch.rpc import set_flag

        for cls in self.classes:
            cls.release()
            cls.ch.close()
            cls.ch = None
        self.others_moved = sum(_var(n) - v for n, v in self.others)
        self.srv.stop()
        self.srv.close()
        self.srv = None
        for k, v in self.saved.items():
            set_flag(k, v)

    def check(self) -> list:
        """Each class's echo_closed_loop checks, named `<check>.<class>`;
        `lane_calls_off`: over both classes, |calls dispatched from the
        class's lane - calls it completed|; `other_lanes_or_shed`: calls
        dispatched from any other lane, and calls shed; `starved_intervals`:
        whole progress intervals in which a class completed nothing."""
        checks = []
        done = 0
        off = 0
        for cls in self.classes:
            done += cls.window.completed
            off += abs(cls.served - cls.window.completed)
            checks += [dataclasses.replace(c, name=f"{c.name}.{cls.name}")
                       for c in cls.check()]
        starved = sum(cls.starved() for cls in self.classes)
        intervals = int(self.ctx.seconds // self.fg.ctx.every)
        return checks + [
            Check("lane_calls_off", off, 0, compared=done,
                  calls_failed=off),
            Check("other_lanes_or_shed", self.others_moved, 0,
                  compared=done, calls_failed=self.others_moved),
            Check("starved_intervals", starved, 0,
                  compared=2 * intervals),
        ]
