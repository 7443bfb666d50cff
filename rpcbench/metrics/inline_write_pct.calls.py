"""inline_write_pct.calls: the share of the native sockets' inline write
attempts that drained the whole queue on the caller, over the window
(counters socket_inline_write_hits / socket_inline_write_attempts, read
by name), in percent."""

COUNTERS = ("socket_inline_write_attempts", "socket_inline_write_hits")


def read(run):
    attempts = run.counter_delta("socket_inline_write_attempts")
    hits = run.counter_delta("socket_inline_write_hits")
    if not attempts or hits is None:
        return None
    return 100.0 * hits / attempts
