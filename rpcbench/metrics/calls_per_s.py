"""calls_per_s: calls completed over the whole window (the tail drained,
ending in a synchronise of the card), divided by the window."""

def read(run):
    w = run.window
    if w.seconds <= 0 or not w.completed:
        return None
    return w.completed / w.seconds
