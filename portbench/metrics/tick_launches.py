"""Kernels and copies on the device per executed tick, in the profiled
chunks."""


def read(run):
    ticks = sum(p["ticks"] for p in run.profiles)
    n = sum(len(p["device"]) for p in run.profiles)
    return n / ticks if ticks and n else None
