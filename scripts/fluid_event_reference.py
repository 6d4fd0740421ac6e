"""The JAX reference's fluid path and event engine on chip_smoke.py's cut
paper batch (phase 4's job lists: ``paper``, 160 jobs on 16 x 4 GPUs,
iterations 100-600, seeds 0-7), on the CPU: the reference's own fluid /
event avg JCT per seed, to set beside phase 32's ratios of the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/fluid_event_reference.py \
        [--comms ada srsf1 srsf2] [--seeds 0 1 2 3 4 5 6 7]

Prints one JSON line per (comm, seed) with the fluid and event avg JCT
(full precision) and their ratio, then the host CPU.  This script runs
the JAX package only; it imports nothing of ``repro_torch``.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from pathlib import Path

from repro.scenarios import get_scenario, monte_carlo_fluid, run_scenario_event

#: chip_smoke.py's PAPER_CUT (published: 1000-6000 iterations)
PAPER_CUT = dict(min_iters=100, max_iters=600)


def _host_cpu() -> str:
    try:
        name = next((ln.split(":", 1)[1].strip()
                     for ln in Path("/proc/cpuinfo").read_text().splitlines()
                     if ln.startswith("model name")), "model name not reported")
    except OSError:
        name = "model name not reported"
    return f"{name}, {platform.machine()}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--comms", nargs="+", default=["ada", "srsf1", "srsf2"])
    ap.add_argument("--seeds", nargs="+", type=int, default=list(range(8)))
    args = ap.parse_args()
    for comm in args.comms:
        t0 = time.perf_counter()
        fluid = monte_carlo_fluid("paper", args.seeds, comm=comm, placement="lwf",
                                  overrides=PAPER_CUT)
        fluid_wall = time.perf_counter() - t0
        for seed, rec in zip(args.seeds, fluid):
            ev = run_scenario_event(get_scenario("paper", seed=seed, **PAPER_CUT), comm=comm)
            print(json.dumps({
                "comm": comm, "seed": seed,
                "fluid_avg_jct": rec.avg_jct, "fluid_finished": rec.n_finished,
                "event_avg_jct": ev.avg_jct(), "event_finished": len(ev.jct),
                "n_jobs": rec.n_jobs, "ratio": rec.avg_jct / ev.avg_jct(),
                "fluid_batch_wall_s": fluid_wall,
            }), flush=True)
    print(f"host: {_host_cpu()}")


if __name__ == "__main__":
    main()
