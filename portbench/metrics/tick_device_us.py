"""Microseconds of device time (kernels and copies) per executed tick, in
the profiled chunks."""


def read(run):
    ticks = sum(p["ticks"] for p in run.profiles)
    dev = sum(e - s for p in run.profiles for _, s, e in p["device"])
    return dev / ticks if ticks and dev > 0 else None
