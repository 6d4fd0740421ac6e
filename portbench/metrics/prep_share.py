"""Share of a batch's wall time that the entry spends before it hands the
stacked traces to the simulator: scenario generation, the fluid config,
``trace_from_jobs`` and ``stack_traces`` (host clock, synchronised)."""


def read(run):
    wall = sum(b.wall_s for b in run.batches)
    return sum(b.prep_s for b in run.batches) / wall if wall > 0 else None
