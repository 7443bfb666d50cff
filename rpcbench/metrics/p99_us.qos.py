"""p99_us.qos: the 99th percentile (nearest rank) of the latency class's
call latencies in the window, in microseconds, while the bulk class loads
the same server and card.  As p99_us.calls: from the submit that put a call
in flight to the return of the poll that delivered it, completions matched
to submits oldest first, calls that the profiler touched left out."""

import math


def read(run):
    lat = sorted(run.window.latencies_s)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.99 * len(lat)) - 1)] * 1e6
