"""device_ops_per_call.calls: kernels, copies and memsets on the card in
the profiled slice, per call completed in it."""

def read(run):
    t = run.trace
    if t is None or not t.completed or not t.ops:
        return None
    return len(t.ops) / t.completed
