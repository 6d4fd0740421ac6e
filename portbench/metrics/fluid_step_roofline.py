"""Percent of its roofline the fluid step core reaches in the profiled
chunks: the least time of each launch at its batch shape (bytes over
the HBM bandwidth or operations over the float32 peak, whichever is
larger), summed, over the summed device time of the launches."""

from portbench.harness.roofline import fluid_step_bound_s

KERNEL = "fluid_step_core_kernel"


def read(run):
    bound = spent = 0.0
    for p in run.profiles:
        launches = [(s, e) for name, s, e in p["device"] if KERNEL in name]
        bound += len(launches) * fluid_step_bound_s(*p["shape"])
        spent += sum(e - s for s, e in launches) * 1e-6
    return 100.0 * bound / spent if spent > 0 else None
