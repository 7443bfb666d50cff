"""enqueue_us.gather: the host's microseconds inside each ring_all_gather
call (plan lookup, output allocation, one C call; no synchronise), from
host-clock readings taken inside rpcbench's span around the call, averaged
over the calls made outside the profiled slice."""

def read(run):
    spans = run.window.spans.get("ring_all_gather")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e6
