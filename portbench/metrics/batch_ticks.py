"""Executed ticks a batch: the driver's chunks times the ticks of a chunk,
averaged over the window's batches (a count)."""

from portbench.harness.trace import CHUNK_TICKS


def read(run):
    if not run.batches:
        return None
    return sum(b.out["chunks"] * CHUNK_TICKS for b in run.batches) / len(run.batches)
