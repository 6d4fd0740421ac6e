"""The JAX reference's event engine on chip_smoke.py's phase-49 cells, on
the CPU: the dynamic scheduling, fault-injection and trace-replay
scenarios at registered size, seed 0, comm ada — ``preemption_gain`` under
``sched`` static and preemptive_srsf, ``elastic_surge`` under static and
elastic, the three ``chaos_*`` and the three ``trace_replay_*``
(``trace_replay_synth`` streamed through ``run_scenario_event``).  The
source of chip_smoke.py's ``REFERENCE_DYNAMIC``, which phase 49 holds the
port's results to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/event_dynamic_reference.py

Prints one JSON line per cell (its avg JCT at full precision and its
preemption, resize, fault, cancellation and censored counts, and the
wall seconds of the run), then the ``REFERENCE_DYNAMIC`` dict to paste,
then the host CPU.  This script runs the JAX package only; it imports
nothing of ``repro_torch``.
"""

from __future__ import annotations

import json
import platform
import time
from pathlib import Path

from repro.scenarios import get_scenario, run_scenario_event

#: (scenario, sched or None for the scenario's own), chip_smoke.py's
#: DYNAMIC_CELLS
CELLS = (("preemption_gain", "static"), ("preemption_gain", "preemptive_srsf"),
         ("elastic_surge", "static"), ("elastic_surge", "elastic"),
         ("chaos_steady", None), ("chaos_recovery_storm", None), ("chaos_stragglers", None),
         ("trace_replay_synth", None), ("trace_replay_philly", None),
         ("trace_replay_alibaba", None))
FIELDS = ("avg_jct", "preemptions", "resizes", "faults", "cancelled", "censored")


def _host_cpu() -> str:
    try:
        name = next((ln.split(":", 1)[1].strip()
                     for ln in Path("/proc/cpuinfo").read_text().splitlines()
                     if ln.startswith("model name")), "model name not reported")
    except OSError:
        name = "model name not reported"
    return f"{name}, {platform.machine()}"


def main() -> None:
    table = {}
    for name, sched in CELLS:
        kw = {} if sched is None else {"sched": sched}
        t0 = time.perf_counter()
        res = run_scenario_event(get_scenario(name, seed=0), comm="ada", **kw)
        wall = time.perf_counter() - t0
        row = {"avg_jct": res.avg_jct(), "preemptions": res.preemptions,
               "resizes": res.resizes, "faults": res.faults, "cancelled": res.cancelled,
               "censored": res.censored}
        table[f"{name}/{sched or res.sched_name}"] = tuple(row[f] for f in FIELDS)
        print(json.dumps({"scenario": name, "sched": res.sched_name, **row,
                          "wall_s": wall}), flush=True)
    print("REFERENCE_DYNAMIC = {")
    for k, v in table.items():
        print(f"    {k!r}: {v!r},")
    print("}")
    print(f"host: {_host_cpu()}")


if __name__ == "__main__":
    main()
