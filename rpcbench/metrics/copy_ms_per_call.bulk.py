"""copy_ms_per_call.bulk: milliseconds of DtoH and HtoD copies on the card
in the profiled slice, per call completed in it (EchoPipeline's D2H of
each submit and H2D of each landed response)."""

def read(run):
    t = run.trace
    if t is None or not t.completed:
        return None
    copies = [o for o in t.ops if o.kind == "gpu_memcpy"]
    if not copies:
        return None
    return sum(o.seconds for o in copies) * 1e3 / t.completed
