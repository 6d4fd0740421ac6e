"""Monte-Carlo traces (seeds simulated to the end) per second: every lane
of every batch in the window over all the window's wall time."""


def read(run):
    if not run.batches or run.window_s <= 0:
        return None
    return sum(len(b.seeds) for b in run.batches) / run.window_s
