"""goodput_gbps: payload bytes echoed device -> RPC -> device over the
whole window (the tail drained, ending in a synchronise of the card),
divided by the window, in 10^9 bytes a second."""

def read(run):
    w = run.window
    if w.seconds <= 0 or not w.completed:
        return None
    return w.completed * w.bytes_per_call / w.seconds / 1e9
