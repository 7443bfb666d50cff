"""bulk_gbps.qos: payload bytes the bulk class echoed device -> RPC ->
device over the window (both classes' tails drained, ending in a
synchronise of the card), divided by the window, in 10^9 bytes a second.
Its pace is set at rate_hz; a shortfall is slots skipped while its calls
were in flight."""


def read(run):
    w = run.window
    bulk = getattr(w, "bulk", None)
    if bulk is None or w.seconds <= 0 or not bulk.completed:
        return None
    return bulk.completed * bulk.bytes_per_call / w.seconds / 1e9
