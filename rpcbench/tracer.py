"""Host spans and the device trace of a traced run (`--trace 1`).

`Tracer` profiles one steady slice inside the measured window with
`torch.profiler` (CPU and CUDA activities), keeps the trace in memory and
never writes it out.  Host spans are rpcbench's own `record_function`
ranges (named `rpcbench.*`), so they share the device ops' clock; with
tracing off a span is a no-op.  `TraceView` is what the metric readers
see: the device ops (kernels, copies, memsets) and the host spans of the
slice, and the program's counters over the window.  The events are read
from the profiler's Chrome trace (its `cat` field tells kernels, copies and
memsets from annotations on every PyTorch version), written to a temporary
file under TMPDIR and deleted once read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time

#: Kineto activity types that are work on the device.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The span around the whole profiled slice: its bounds are the slice's.
SLICE = "rpcbench.slice"
#: Where the slice starts in the window, in seconds (moved earlier in a
#: window too short for it).
START_S = 3.0


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: str
    device: int
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int


def short_name(name: str) -> str:
    """A kernel's demangled name without its namespace, return type and
    arguments: 'void (anonymous namespace)::echo_kernel<256, 4>(unsigned
    int const*, ...)' -> 'echo_kernel<256, 4>'; copies keep their name."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name[:120]
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    if "(" in name:
        name = name[:name.index("(")]
    return name[:120]


def merge(intervals: list) -> list:
    """Sorted, disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class TraceView:
    """The profiled slice: [start_ns, end_ns], its device ops and host
    spans, the devices of the run, and completions counted in it."""

    start_ns: int
    end_ns: int
    ops: list
    spans: list
    devices: list
    completed: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy(self, device: int) -> list:
        """Merged intervals of `device` busy with any op, clipped to the
        slice."""
        return merge([(max(o.start_ns, self.start_ns),
                       min(o.end_ns, self.end_ns))
                      for o in self.ops
                      if o.device == device and o.end_ns > self.start_ns
                      and o.start_ns < self.end_ns])

    def busy_s(self) -> float | None:
        """Seconds some op ran on the device, averaged over the devices of
        the run; None where the trace shows no device op at all."""
        if not self.ops or not self.devices:
            return None
        total = sum(e - s for d in self.devices for s, e in self.busy(d))
        return total / len(self.devices) / 1e9

    def ops_named(self, *needles: str) -> list:
        return [o for o in self.ops if any(n in o.name for n in needles)]

    def span_at(self, t_ns: int) -> str:
        """The innermost rpcbench span open at t_ns (the latest to start)."""
        best = None
        for s in self.spans:
            if s.start_ns <= t_ns <= s.end_ns and (
                    best is None or s.start_ns > best.start_ns):
                best = s
        return best.name if best is not None else "outside rpcbench spans"

    def idle_gaps(self) -> list:
        """(seconds, device, start_ns, end_ns) of every stretch of the slice
        in which a device of the run ran nothing."""
        gaps = []
        for d in self.devices:
            t = self.start_ns
            for s, e in self.busy(d) + [[self.end_ns, self.end_ns]]:
                if s > t:
                    gaps.append(((s - t) / 1e9, d, t, s))
                t = max(t, e)
        return gaps

    def breakdown(self) -> dict:
        """The ten device ops that took most time (summed by name over the
        devices) and the ten longest idle gaps, named by the span the host
        was in at each gap's middle."""
        by_name: dict = {}
        for o in self.ops:
            s = max(o.start_ns, self.start_ns)
            e = min(o.end_ns, self.end_ns)
            if e > s:
                key = short_name(o.name)
                by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        many = len(self.devices) > 1
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[0])[:10]
        named = [[self.span_at((a + b) // 2) + (f" (cuda:{d})" if many
                                                 else ""), sec]
                 for sec, d, a, b in gaps]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}


class Tracer:
    """Profiles [START_S, START_S + slice_s) of the window when enabled.

    The generator calls `span(name)` around its calls into the program and
    `tick(completed)` once per loop turn; `tick` starts and stops the
    profiler on time and counts the completions made inside the slice.
    `epoch` counts the profiler's starts and stops, so that a host-clock
    reading can leave out what the profiler's own cost touched."""

    def __init__(self, enabled: bool, slice_s: float, cuda: bool):
        self.enabled = enabled
        self.start_s = START_S
        self.slice_s = slice_s
        self.epoch = 0
        self.cuda = cuda
        self._prof = None
        self._slice_span = None
        self._t0 = None
        self._done = False
        self._completed_at_start = 0
        self.completed = 0
        self._done_prof = None

    @property
    def active(self) -> bool:
        """Whether the profiler is recording now."""
        return self._prof is not None

    def quiet(self, since: int) -> bool:
        """Whether the profiler has neither run nor started or stopped
        since `epoch` read `since`."""
        return self.epoch == since and self._prof is None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.autograd.profiler import record_function

        return record_function(name)

    def _profile(self):
        import torch.profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(tp.ProfilerActivity.CUDA)
        return tp.profile(activities=acts, record_shapes=False,
                          profile_memory=False, with_stack=False)

    def warm(self, step) -> None:
        """Profiles `step()` once during set-up, so the profiler's own
        start-up (CUPTI's, on the card) is paid there, not in the window."""
        if not self.enabled:
            return
        prof = self._profile()
        prof.start()
        step()
        prof.stop()

    def begin_window(self, seconds: float) -> None:
        """Called at the start of the window: places the slice inside it."""
        self._t0 = time.perf_counter()
        if self.start_s + self.slice_s > 0.8 * seconds:
            self.start_s = 0.25 * seconds
            self.slice_s = min(self.slice_s, 0.5 * seconds)

    def tick(self, completed: int) -> None:
        if not self.enabled or self._done or self._t0 is None:
            return
        now = time.perf_counter() - self._t0
        if self._prof is None and now >= self.start_s:
            from torch.autograd.profiler import record_function

            self._prof = self._profile()
            self._prof.start()
            self._slice_span = record_function(SLICE)
            self._slice_span.__enter__()
            self._completed_at_start = completed
            self.epoch += 1
        elif self._prof is not None and now >= self.start_s + self.slice_s:
            self.stop(completed)

    def stop(self, completed: int) -> None:
        """Ends the slice (also when the window ends before its time)."""
        if self._prof is None:
            return
        self._slice_span.__exit__(None, None, None)
        self._prof.stop()
        self.completed = completed - self._completed_at_start
        self._done_prof = self._prof
        self._prof = None
        self._done = True
        self.epoch += 1

    def view(self, devices: list) -> TraceView | None:
        """The slice as readers see it, or None when no slice was taken."""
        if self._done_prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="rpcbench-")
        os.close(fd)
        try:
            self._done_prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._done_prof = None
        ops, spans, bounds = [], [], None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            kind, name = ev.get("cat", ""), ev.get("name", "")
            start = int(round(float(ev["ts"]) * 1000))
            end = start + int(round(float(ev.get("dur", 0)) * 1000))
            if kind in DEVICE_KINDS:
                device = ev.get("args", {}).get("device", ev.get("pid"))
                ops.append(Op(name, kind, int(device), start, end))
            elif kind == "user_annotation" and name.startswith("rpcbench."):
                if name == SLICE:
                    bounds = (start, end)
                spans.append(Span(name, start, end))
        if bounds is None:
            return None
        return TraceView(bounds[0], bounds[1], ops, spans, list(devices),
                         self.completed)
