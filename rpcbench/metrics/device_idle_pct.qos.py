"""device_idle_pct.qos: the share of the profiled slice in which no kernel,
copy or memset ran on the card, in percent, with both classes on it."""

def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.busy_s()
    if busy is None or t.seconds <= 0:
        return None
    return 100.0 * (1.0 - busy / t.seconds)
