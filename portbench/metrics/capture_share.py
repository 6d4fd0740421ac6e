"""Share of a batch's wall time spent on CUDA-graph captures: the eager
warm-up block, the recording and the instantiation of every batch shape,
as the simulator returns them in ``captures``."""


def read(run):
    wall = sum(b.wall_s for b in run.batches)
    caps = [c for b in run.batches for c in b.out.get("captures", [])]
    if wall <= 0 or not caps:
        return None
    spent = sum(c["warmup_s"] + c["capture_s"] + c["instantiate_s"] for c in caps)
    return spent / wall
