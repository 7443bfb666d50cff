"""What the program's own host spans show in a traced run of one cell.

    python3 rpcbench/program_spans.py --workload <name> --seed <n> --seconds <s>

Runs the cell once with `--trace 1`, as run.py does, and also keeps the
program's spans of the profiled slice: the `trpc.*` ranges that
brpc_tpu_torch opens under a profiler (`rpc/observe.py` `span`), which the
harness's `TraceView` leaves out.  Prints one JSON object: the result line
(`result`) and

    slice_calls_per_s   completions in the slice over its length
    window_calls_per_s  completions over the whole window, from the host
    host_us_per_call    time in trpc.echo.submit and trpc.echo.poll, less
                        trpc.batch.wait inside them, per completion in the
                        slice (echo cells)
    self_us_per_call    each program span's own time (less the program
                        spans inside it) per completion in the slice
    idle_gaps           the ten longest idle gaps of the slice, named by
                        rpcbench's span and the innermost program span open
                        at the gap's middle ("rpcbench.poll >
                        trpc.batch.wait")
    little              (wire + ring wait) x window completions / window
                        seconds over the cell's `inflight` (echo cells; 1.0
                        when the native part of the loop holds every call)

It is a diagnostic, not a metric of BENCHMARK.json; it reads nothing
`rpcbench/tracer.py` does not already profile.  A program without such
spans gives empty tables.  It goes once `rpcbench/tracer.py` keeps the
program's spans itself and a `host_us_per_call.calls` reader exists.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: The program's span names start so.
PREFIX = "trpc."
#: Echo spans whose time is the host path, and the native wait inside.
HOST = ("trpc.echo.submit", "trpc.echo.poll")
WAIT = "trpc.batch.wait"


def program_spans(events: list) -> list:
    """(name, tid, start_ns, end_ns) of the program's ranges in a
    profiler's Chrome trace events."""
    out = []
    for ev in events:
        name = ev.get("name", "")
        if (ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and name.startswith(PREFIX)):
            start = int(round(float(ev["ts"]) * 1000))
            out.append((name, ev.get("tid"), start,
                        start + int(round(float(ev.get("dur", 0)) * 1000))))
    return out


def self_ns(spans: list) -> dict:
    """Each name's summed own time: a span's length less that of the
    spans directly inside it on its thread."""
    out: dict = {}
    by_tid: dict = {}
    for s in spans:
        by_tid.setdefault(s[1], []).append(s)
    for group in by_tid.values():
        stack: list = []  # [name, end, own]
        for name, _, start, end in sorted(group,
                                          key=lambda s: (s[2], -s[3])):
            while stack and stack[-1][1] <= start:
                done = stack.pop()
                out[done[0]] = out.get(done[0], 0) + done[2]
            if stack:
                stack[-1][2] -= end - start
            stack.append([name, end, end - start])
        for name, _, own in stack:
            out[name] = out.get(name, 0) + own
    return out


def host_us_per_call(spans: list, completed: int) -> float | None:
    """Time in HOST spans less WAIT spans, per completion (µs); None
    without completions or host spans."""
    host = sum(e - s for n, _, s, e in spans if n in HOST)
    if not completed or not host:
        return None
    wait = sum(e - s for n, _, s, e in spans if n == WAIT)
    return (host - wait) / completed / 1e3


def name_gaps(view, spans: list, top: int = 10) -> list:
    """The `top` longest idle gaps of `view` as [name, seconds], named as
    `TraceView.breakdown` names them and, where one is open, by the
    innermost program span at the gap's middle (`TraceView.span_at` over a
    view whose spans are the program's)."""
    from rpcbench.tracer import Span

    inner = dataclasses.replace(view, spans=[Span(n, s, e)
                                             for n, _, s, e in spans])
    many = len(view.devices) > 1
    out = []
    for sec, d, a, b in sorted(view.idle_gaps(), key=lambda g: -g[0])[:top]:
        mid = (a + b) // 2
        name = view.span_at(mid)
        program = inner.span_at(mid)
        if program.startswith(PREFIX):
            name += f" > {program}"
        if many:
            name += f" (cuda:{d})"
        out.append([name, sec])
    return out


def little(wire_us, ring_us, completed: int, window_s: float,
           inflight: int) -> float | None:
    """Calls held in the native part of the loop on average (Little's law)
    over the calls the loop keeps in flight."""
    if wire_us is None or ring_us is None or not window_s or not inflight:
        return None
    return (wire_us + ring_us) * 1e-6 * completed / window_s / inflight


class _Exported:
    """A profiler's exported events, exported again on request (a torch
    profiler exports once)."""

    def __init__(self, events: list):
        self.events = events

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _tracer_class(base):
    class ProgramSpanTracer(base):
        """The harness's tracer, also keeping the slice's program spans,
        its view, and the window's completions and length (the harness
        stops the tracer once more at the window's end)."""

        last = None
        spans: list = []
        trace_view = None
        window_completed = 0
        window_s = 0.0

        def stop(self, completed):
            super().stop(completed)
            self.window_completed = completed
            self.window_s = time.perf_counter() - self._t0

        def view(self, devices):
            ProgramSpanTracer.last = self
            if self._done_prof is not None:
                fd, path = tempfile.mkstemp(suffix=".json",
                                            prefix="rpcbench-spans-")
                os.close(fd)
                try:
                    self._done_prof.export_chrome_trace(path)
                    with open(path) as f:
                        events = json.load(f).get("traceEvents", [])
                finally:
                    os.unlink(path)
                self.spans = program_spans(events)
                self._done_prof = _Exported(events)
            self.trace_view = super().view(devices)
            return self.trace_view

    return ProgramSpanTracer


def traced_run(root, workload: str, seed: int, seconds: float, **kw):
    """`harness.run_cell` with tracing on, keeping the program's spans:
    returns (result, tracer)."""
    from rpcbench import harness

    cls = _tracer_class(harness.Tracer)
    base, harness.Tracer = harness.Tracer, cls
    try:
        result = harness.run_cell(root, workload, seed, seconds, True, **kw)
    finally:
        harness.Tracer = base
    return result, cls.last


def report(result: dict, tracer, mix: dict) -> dict:
    """The JSON object this command prints, from a run's result line and
    its tracer."""
    view = getattr(tracer, "trace_view", None)
    out = {"result": result}
    if view is None:
        return out
    spans = [(n, t, max(s, view.start_ns), min(e, view.end_ns))
             for n, t, s, e in tracer.spans
             if e > view.start_ns and s < view.end_ns]
    done = view.completed
    out["slice_calls_per_s"] = done / view.seconds if view.seconds else None
    out["window_calls_per_s"] = (tracer.window_completed / tracer.window_s
                                 if tracer.window_s else None)
    out["host_us_per_call"] = host_us_per_call(spans, done)
    out["self_us_per_call"] = {k: v / done / 1e3 for k, v in sorted(
        self_ns(spans).items())} if done else {}
    out["idle_gaps"] = name_gaps(view, spans)
    # A CPU rehearsal gives the counters' readings under "rehearsal".
    values = {k: v["value"] for k, v in result.get("metrics", {}).items()}
    values.update(result.get("rehearsal", {}))

    def us(name_us, name_ms):
        if name_us in values:
            return values[name_us]
        return values[name_ms] * 1e3 if name_ms in values else None

    out["little"] = little(us("wire_us.calls", "wire_ms.bulk"),
                           us("ring_wait_us.calls", "ring_wait_ms.bulk"),
                           tracer.window_completed, tracer.window_s,
                           int(mix.get("inflight", 0)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and
                   str(pathlib.Path(p).resolve()) != here]
    sys.path.insert(0, str(ROOT))
    from rpcbench import run, spec

    run._cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("program_spans: no CUDA card", file=sys.stderr)
        return 2
    result, tracer = traced_run(ROOT, args.workload, args.seed,
                                args.seconds, t_start=T_START)
    s = spec.Spec.load(ROOT)
    out = report(result, tracer, s.mix(s.cell(args.workload)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
