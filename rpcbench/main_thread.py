"""The echo pipeline's calling thread, read by name from the program's vars.

EchoPipeline (brpc_tpu_torch/models/echo.py) reads these clocks in every
poll and submit, with or without a profiler, over the whole window:

    trpc_echo_polls             polls that landed calls
    trpc_echo_poll_ns           wall ns inside poll, less the native wait
    trpc_echo_poll_wait_ns      wall ns inside the native poll (GIL
                                released)
    trpc_echo_submit_ns         wall ns inside submit

and these at a flush of a pipeline's sums into the gauges (every 64 polls
that land calls, at a poll that leaves nothing in flight, at close) half a
second or more after the thread last read its CPU clock (a system call,
which steps by 10 ms on the card's host):

    trpc_echo_host_cpu_ns       the thread's CPU ns since that reading
    trpc_echo_host_cpu_wall_ns  the wall ns of the same stretches

poll: poll ns per landed call; submit: submit ns per submitted call;
caller: the window less the poll, its wait and the submit, per completed
call, in microseconds: the caller's own loop between the program's calls.
calls per poll: landed calls over the polls that landed them.  On-CPU: the
driving thread's CPU time over its wall time, in percent: below 100 the
thread was off its core, or blocked in a native wait.  A program without these gauges reads None for each."""

POLLS = "trpc_echo_polls"
POLL_NS = "trpc_echo_poll_ns"
POLL_WAIT_NS = "trpc_echo_poll_wait_ns"
SUBMIT_NS = "trpc_echo_submit_ns"
HOST_CPU_NS = "trpc_echo_host_cpu_ns"
HOST_CPU_WALL_NS = "trpc_echo_host_cpu_wall_ns"
LANDED = "trpc_echo_landed"
SUBMITTED = "trpc_echo_submitted"


def _per(run, summed: str, count: str, scale: float = 1e-3):
    """The window's change of `summed` per one of `count`, times scale;
    None where the program has no such gauges or counted nothing."""
    total = run.counter_delta(summed)
    n = run.counter_delta(count)
    if not n or total is None:
        return None
    return total / n * scale


def poll_us(run) -> float | None:
    return _per(run, POLL_NS, LANDED)


def submit_us(run) -> float | None:
    return _per(run, SUBMIT_NS, SUBMITTED)


def calls_per_poll(run) -> float | None:
    return _per(run, LANDED, POLLS, 1.0)


def host_oncpu_pct(run) -> float | None:
    return _per(run, HOST_CPU_NS, HOST_CPU_WALL_NS, 100.0)


def caller_us(run) -> float | None:
    w = run.window
    ns = [run.counter_delta(n) for n in (POLL_NS, POLL_WAIT_NS, SUBMIT_NS)]
    if None in ns or not w.completed or w.seconds <= 0:
        return None
    return (w.seconds * 1e6 - sum(ns) / 1000) / w.completed
