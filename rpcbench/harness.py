"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, and the result line.

The flow is general; everything particular to a cell comes from the files
`BENCHMARK.json` names (`spec.py`).  A generator module defines
`Workload(ctx)` with:

    setup()       build the system under test from the seed and warm every
                  shape the window will use;
    warm_step()   one short call of the system (the profiler's warm-up);
    run_window()  the measured window -> Window, its clock started by
                  ctx.begin_window(window), ctx.tick(completed) called once
                  a loop turn;
    release()     free the program's state, keeping what the check reads;
    check()       compare with the reference -> [Check].

`ctx.system`, when given, replaces the program's entry (the control and
the planted faults of the tests); the benchmark's own runs never give it.
"""

from __future__ import annotations

import array
import dataclasses
import gc
import sys
import time

from rpcbench import spec as spec_mod
from rpcbench.tracer import Tracer, TraceView

#: Top-level module names that must not be loaded (compared whole: the
#: port's `brpc_tpu_torch` is not `brpc_tpu`).
FORBIDDEN = ("jax", "jaxlib", "flax", "brpc_tpu")
#: Completions are counted at every PROGRESS_S of the window, for the log.
PROGRESS_S = 5.0


class RunError(RuntimeError):
    """The run cannot give a result (no card, JAX loaded, a reader that
    finds no number for an end-to-end metric)."""


@dataclasses.dataclass
class Check:
    """One number compared with its limit: within it while value <= limit."""

    name: str
    value: float
    limit: float
    compared: int = 0     # outputs this number was taken over
    calls_failed: int = 0  # calls or steps it found wrong

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What the measured window did, as the generator counted it."""

    started: float = 0.0          # perf_counter() at its start
    seconds: float = 0.0          # its length, ending in a synchronise
    attempted: int = 0            # calls (or steps) started
    completed: int = 0            # calls that came back
    missing: int = 0              # calls that never came back, or failed
    bytes_per_call: int = 0
    latencies_s: array.array = dataclasses.field(
        default_factory=lambda: array.array("d"))
    #: host seconds of rpcbench's spans around program calls, by name,
    #: taken outside the profiled slice
    spans: dict = dataclasses.field(default_factory=dict)
    errors: list = dataclasses.field(default_factory=list)
    #: device index -> bytes of outputs held for the check past the point
    #: where the program would have dropped them (left out of the peak)
    kept_bytes: dict = dataclasses.field(default_factory=dict)
    #: completions counted at every PROGRESS_S of the window
    progress: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Context:
    """What a generator gets: the cell's files, the seed, the devices, the
    tracer, and optionally a system to run in the program's place."""

    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    devices: list
    tracer: Tracer
    system: object = None
    _t0: float = None
    _progress: list = None

    @property
    def cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def span(self, name: str):
        return self.tracer.span(name)

    def begin_window(self, window: Window) -> float:
        """Starts the window's clock (and the tracer's); returns its start."""
        self.tracer.begin_window(self.seconds)
        self._progress = window.progress
        self._t0 = window.started = time.perf_counter()
        return self._t0

    def tick(self, completed: int) -> None:
        """Once per loop turn, with the completions so far."""
        self.tracer.tick(completed)
        if (time.perf_counter() - self._t0
                >= PROGRESS_S * (len(self._progress) + 1)):
            self._progress.append(completed)

    def sync(self) -> None:
        if self.cuda:
            import torch

            for d in dict.fromkeys(self.devices):
                torch.cuda.synchronize(d)


@dataclasses.dataclass
class RunData:
    """What a metric reader gets."""

    cell: dict
    config: dict
    mix: dict
    card: str
    devices: list
    setup_s: float
    window: Window
    trace: TraceView | None
    counters: dict  # name -> (value at window start, at window end)

    def counter_delta(self, name: str) -> float | None:
        pair = self.counters.get(name)
        if pair is None or pair[0] is None or pair[1] is None:
            return None
        return pair[1] - pair[0]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _read_counters(names) -> dict:
    from brpc_tpu_torch.rpc import observe

    out = {}
    for name in names:
        try:
            value = observe.Vars.read(name)
        except KeyError:
            value = None
        out[name] = value if isinstance(value, (int, float)) else None
    return out


def _memory_peak(devices, kept: dict) -> int:
    """The window's peak on the fullest card, less the outputs the check
    holds there (all of which are live at the window's end)."""
    import torch

    return max(torch.cuda.max_memory_allocated(d) - kept.get(d.index, 0)
               for d in dict.fromkeys(devices))


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", system=None,
             overrides: dict | None = None, log=None) -> dict:
    """Runs `workload` once and returns the result object.  `device` is
    "cuda" for a measurement; "cpu" is the rehearsal the tests run, whose
    numbers go under "rehearsal" and never under a metric's name.
    `overrides` replace keys of the traffic mix (rehearsal and
    calibration only).  `log(line)` takes the lines for standard error."""
    import torch

    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    spec = spec_mod.Spec.load(root)
    cell = spec.cell(workload)
    config = spec.config(cell)
    mix = dict(spec.mix(cell), **(overrides or {}))
    if device == "cuda":
        devices = [torch.device("cuda", i) for i in range(cell["chips"])]
        card = torch.cuda.get_device_name(0)
        torch.cuda.set_device(0)
    else:
        devices = [torch.device("cpu")] * cell["chips"]
        card = "cpu"
    metrics = spec.per_layer(workload) if trace else spec.end_to_end(
        workload)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    counter_names = sorted({c for r in readers.values()
                            for c in getattr(r, "COUNTERS", ())})
    tracer = Tracer(trace, float(mix.get("trace_slice_s", 1.0)),
                    device == "cuda")
    ctx = Context(cell, config, mix, seed, seconds, devices, tracer, system)
    work = spec.generator(mix).Workload(ctx)
    work.setup()
    tracer.warm(work.warm_step)
    ctx.sync()
    if device == "cuda":  # the peak of the window, not of the set-up
        for d in dict.fromkeys(devices):
            torch.cuda.reset_peak_memory_stats(d)
    gc.collect()
    gc.freeze()
    before = _read_counters(counter_names)
    window = work.run_window()
    after = _read_counters(counter_names)
    gc.unfreeze()
    tracer.stop(window.completed)
    peak = (_memory_peak(devices, window.kept_bytes) if device == "cuda"
            else 0)
    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules loaded by the run: {', '.join(bad)}")
    work.release()
    checks = work.check()
    view = tracer.view(sorted({d.index for d in devices})
                       if device == "cuda" else [])
    run = RunData(cell, config, mix, card, devices,
                  window.started - t_start, window, view,
                  {n: (before[n], after[n]) for n in counter_names})
    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is None and not trace:
            raise RunError(f"no value for end-to-end metric {m['name']!r}")
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = window.missing + sum(c.calls_failed for c in checks)
    result = {
        "correct": all(c.ok for c in checks) and window.completed > 0,
        "attempted": window.attempted,
        "failed": min(failed, window.attempted),
        "metrics": values if device == "cuda" else {},
        "device": {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": card, "count": len(set(devices))
                   if device == "cuda" else cell["chips"],
                   "memory_peak_bytes": peak},
    }
    if device != "cuda":
        result["rehearsal"] = {k: v["value"] for k, v in values.items()}
    if trace:
        busy = view.busy_s() if view is not None else None
        if device == "cuda" and busy:
            result["device"]["busy_s"] = busy
            result["device"]["window_s"] = view.seconds
            result["breakdown"] = view.breakdown()
        if view is None:
            log("trace: no profiled slice was taken")
        elif busy is None:
            log("trace: the profiler showed no device op in the slice")
    for e in window.errors[:5]:
        log(f"error in window: {e}")
    if window.latencies_s:
        log(f"latency samples: {len(window.latencies_s)}")
    log(f"window: {window.seconds:.6f} s, {window.completed} completed of "
        f"{window.attempted}")
    if window.progress:
        steps = [b - a for a, b in zip([0] + window.progress,
                                       window.progress)]
        log(f"completed in each {PROGRESS_S:g} s: {steps}")
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "compared": c.compared} for c in checks}
    for c in checks:
        log(f"check {c.name}: {c.value} (limit {c.limit}, "
            f"{c.compared} compared)")
    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules loaded by the run: {', '.join(bad)}")
    return result


def reserve(device, nbytes: int, count: int) -> None:
    """Fills the caching allocator with `count` blocks of `nbytes` on a
    card and frees them, so that outputs kept for the check are cut from
    cached blocks and not allocated from the CUDA driver inside the window."""
    import torch

    if device.type != "cuda" or count <= 0:
        return
    blocks = [torch.empty(nbytes, dtype=torch.uint8, device=device)
              for _ in range(count)]
    del blocks
