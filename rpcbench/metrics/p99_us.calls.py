"""p99_us.calls: the 99th percentile (nearest rank) of every call's latency in
the window, in microseconds.  A call's latency runs from the submit that
put it in flight to the return of the poll that delivered it; the entry's
public interface returns no call tokens, so completions are matched to
submits in order (oldest first).  Calls that were in flight while the
profiler ran, started or stopped give no latency: the tail is the
program's, not the profiler's."""

import math


def read(run):
    lat = sorted(run.window.latencies_s)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.99 * len(lat)) - 1)] * 1e6
