"""gather_ms: the whole window (ending in a synchronise of every card)
divided by the number of four-card gathers completed in it."""

def read(run):
    w = run.window
    if w.seconds <= 0 or not w.completed:
        return None
    return w.seconds * 1e3 / w.completed
