"""The JAX reference on chip_smoke.py's phase-50 cells, on the CPU: the
source of its ``REFERENCE_SWEEP_FLUID``, ``REFERENCE_REST`` and
``REFERENCE_SWEEP_EVENT``, which phase 50 holds the port's results to.

* (a) ``sweep(["fusion_sweep", "model_zoo"], comms=("ada", "srsf2"),
  seeds=(0, 1), backend="fluid")`` at phase 11's overrides: each record's
  JCT statistics and makespan (the port's card records are held within
  1e-6 relative, the finished counts exact);
* (b) the event engine at registered size, seed 0, comm ada: ``paper``
  with ``comm_chunks=4`` and with ``contention_domain="link"``; ``paper``
  and ``preemption_gain`` (``sched="preemptive_srsf"``) under
  ``gating="rescan"`` (``paper`` at half depth, ``HOST_CUTS``) and
  ``workloads="rescan"``; ``paper`` and
  ``chaos_recovery_storm`` under ``observe=ObsConfig.full()`` (mean JCT
  parts and the Chrome trace's event count); ``trace_replay_philly`` under
  ``profile_phases=True`` (the keys of ``replay_summary(window_s=60)``
  and its values but the phase seconds).  Each run's finish times are
  digested (sha256 of ``repr(list(res.finish.items()))``);
* (c) the event ``sweep(["paper", "oversub_fabric"], comms=("ada",
  "srsf1", "srsf2"), per_scenario_overrides=QUICK_OVERRIDES)``: each
  record's avg JCT and the sha256 of the ``repr`` of its ``CSV_FIELDS``
  values, ``wall_s`` aside.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/event_rest_reference.py

The registered-size runs take minutes each on one CPU core; they run in 6
worker processes.  Prints one JSON line per cell, then the three dicts to
paste, then the host CPU.  This script runs the JAX package only; it
imports nothing of ``repro_torch``.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import platform
import time
from pathlib import Path

#: phase 11's overrides of the phase-50 fluid cells (chip_smoke.py's
#: CARD_CPU_CELLS)
FLUID_OVERRIDES = {
    "fusion_sweep": {"fusion": 32e6},
    "model_zoo": {"n_jobs": 12, "min_iters": 15, "max_iters": 60, "horizon_s": 600.0},
}
FLUID_FIELDS = ("n_jobs", "n_finished", "avg_jct", "median_jct", "p95_jct", "p99_jct",
                "makespan")
#: phase 50 (b): (tag, scenario, engine keywords), seed 0, comm ada
HOST_CELLS = (
    ("paper/gating=rescan", "paper", {"gating": "rescan"}),
    ("paper/comm_chunks=4", "paper", {"comm_chunks": 4}),
    ("paper/observed", "paper", {"observe": "full"}),
    ("paper/workloads=rescan", "paper", {"workloads": "rescan"}),
    ("paper/link", "paper", {"contention_domain": "link"}),
    ("preemption_gain/preemptive_srsf/gating=rescan", "preemption_gain",
     {"sched": "preemptive_srsf", "gating": "rescan"}),
    ("preemption_gain/preemptive_srsf/workloads=rescan", "preemption_gain",
     {"sched": "preemptive_srsf", "workloads": "rescan"}),
    ("chaos_recovery_storm/observed", "chaos_recovery_storm", {"observe": "full"}),
    ("trace_replay_philly/profile_phases", "trace_replay_philly", {"profile_phases": True}),
)
REPLAY_WINDOW_S = 60.0
#: scenario overrides of a host cell: the paper run under the gating rescan
#: at half its registered depth (iterations 500-3000), as chip_smoke.py runs
#: it since its phase-50 pool stage was bound by that run
HOST_CUTS = {"paper/gating=rescan": {"min_iters": 500, "max_iters": 3000}}


def finish_digest(res) -> str:
    return hashlib.sha256(repr(list(res.finish.items())).encode()).hexdigest()


def record_digest(rec, fields) -> str:
    return hashlib.sha256(
        repr(tuple(getattr(rec, f) for f in fields if f != "wall_s")).encode()).hexdigest()


def _host_cell(cell):
    from repro.obs import ObsConfig
    from repro.scenarios import get_scenario, run_scenario_event
    from repro.scenarios.metrics import replay_summary

    tag, name, kw = cell
    kw = dict(kw)
    if kw.get("observe") == "full":
        kw["observe"] = ObsConfig.full()
    t0 = time.perf_counter()
    res = run_scenario_event(get_scenario(name, seed=0, **HOST_CUTS.get(tag, {})), comm="ada",
                             **kw)
    wall = time.perf_counter() - t0
    row = {"avg_jct": res.avg_jct(), "events": res.events_processed,
           "preemptions": res.preemptions, "comm_contended": res.comm_started_contended,
           "comm_clean": res.comm_started_clean, "censored": res.censored,
           "finish_sha256": finish_digest(res)}
    if res.obs is not None:
        row["mean_parts"] = res.obs.mean_parts()
        row["trace_events"] = len(res.obs.to_chrome_trace()["traceEvents"])
    if res.phase_seconds is not None:
        summary = replay_summary(res, window_s=REPLAY_WINDOW_S)
        row["replay_keys"] = list(summary)
        row["replay_values"] = {k: v for k, v in summary.items() if not k.startswith("phase_")}
    return tag, row, wall


def _host_cpu() -> str:
    try:
        name = next((ln.split(":", 1)[1].strip()
                     for ln in Path("/proc/cpuinfo").read_text().splitlines()
                     if ln.startswith("model name")), "model name not reported")
    except OSError:
        name = "model name not reported"
    return f"{name}, {platform.machine()}"


def main() -> None:
    from repro.scenarios import QUICK_OVERRIDES, sweep
    from repro.scenarios.metrics import CSV_FIELDS

    with multiprocessing.get_context("spawn").Pool(6) as pool:
        host = pool.map_async(_host_cell, HOST_CELLS, chunksize=1)

        t0 = time.perf_counter()
        recs = sweep(["fusion_sweep", "model_zoo"], comms=("ada", "srsf2"), seeds=(0, 1),
                     backend="fluid", per_scenario_overrides=FLUID_OVERRIDES)
        fluid = {}
        for r in recs:
            fluid[(r.scenario, r.comm, r.seed)] = tuple(getattr(r, f) for f in FLUID_FIELDS)
        print(json.dumps({"part": "a", "wall_s": time.perf_counter() - t0}), flush=True)

        t0 = time.perf_counter()
        recs = sweep(["paper", "oversub_fabric"], comms=("ada", "srsf1", "srsf2"),
                     per_scenario_overrides=QUICK_OVERRIDES)
        event = {(r.scenario, r.comm): (r.avg_jct, record_digest(r, CSV_FIELDS)) for r in recs}
        print(json.dumps({"part": "c", "wall_s": time.perf_counter() - t0}), flush=True)

        rest = {}
        for tag, row, wall in host.get():
            rest[tag] = row
            print(json.dumps({"part": "b", "cell": tag, **row, "wall_s": wall}), flush=True)

    print("#: " + ", ".join(FLUID_FIELDS))
    print("REFERENCE_SWEEP_FLUID = {")
    for k, v in fluid.items():
        print(f"    {k!r}: {v!r},")
    print("}")
    print("REFERENCE_REST = {")
    for k, v in rest.items():
        print(f"    {k!r}: {v!r},")
    print("}")
    print("REFERENCE_SWEEP_EVENT = {")
    for k, v in event.items():
        print(f"    {k!r}: {v!r},")
    print("}")
    print(f"host: {_host_cpu()}")


if __name__ == "__main__":
    main()
