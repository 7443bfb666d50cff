"""The batch pipeline's queue, read by name from the program's vars.

wire: the mean of the native recorder `rpc_client_batch`, from a call's
issue in the native runtime to the completion stamp its callback takes
before the response's landing copy.  The recorder keeps a trailing window of
10 s, read when the reader runs, a few seconds after the measured window's
end: the mean of the window's last seconds and its drained tail.

held: `rpc_client_batch_held_us` over `rpc_client_batch_drained`, the
window's change of each (brpc_tpu_torch/rpc/batch.py): from the host's
submit, just before the native crossing, to the return of the poll that
drained the call.

ring wait: held less wire: the response's landing copy, the time the
finished call sits in the completion ring, and the poll's return, plus the
native submit crossing up to the issue.  A program without the held
counters reads None for it; one without the recorder reads None for both."""

RECORDER = "rpc_client_batch"
DRAINED = "rpc_client_batch_drained"
HELD_US = "rpc_client_batch_held_us"
#: The counters a ring-wait reader lists as its COUNTERS.
HELD = (DRAINED, HELD_US)


def wire_us(run) -> float | None:
    """The recorder's mean, in microseconds; None where the program has no
    such recorder or it saw no call in its window."""
    from brpc_tpu_torch.rpc import observe

    try:
        stats = observe.Latency.read(RECORDER)
    except (KeyError, TypeError):
        return None
    return float(stats.avg_us) if stats.avg_us > 0 else None


def held_us(run) -> float | None:
    """The window's change of the held sum per drained call, in
    microseconds; None where the program has no such counters or drained
    nothing."""
    drained = run.counter_delta(DRAINED)
    summed = run.counter_delta(HELD_US)
    if not drained or summed is None:
        return None
    return summed / drained


def ring_wait_us(run) -> float | None:
    held = held_us(run)
    wire = wire_us(run)
    if held is None or wire is None:
        return None
    return held - wire
