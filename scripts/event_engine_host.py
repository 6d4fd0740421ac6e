"""Time the port's event engine on this host, without a GPU: the runs of
chip_smoke.py's phases 31 and 32 (``paper`` and ``oversub_fabric`` at
registered size, then the 8 cut paper job lists under ada, srsf1 and
srsf2), in spawned worker processes as chip_smoke.py runs them.

    PYTHONPATH=src python3 scripts/event_engine_host.py [--workers 4]

Prints one JSON line per run (avg JCT, events, wall s, events/s) and the
host CPU.  The engine is Python on Python floats, so avg JCTs and event
counts are the same on every host; only the times differ.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the phases' own worker and cells)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=chip_smoke.EVENT_WORKERS)
    args = ap.parse_args()
    print(f"host: {chip_smoke._host_cpu()}; {args.workers} worker processes", flush=True)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=args.workers, mp_context=ctx) as pool:
        runs = chip_smoke._submit_event_runs(pool)
        for fut in runs["registered"] + list(runs["cut"].values()):
            r = fut.result()
            r["events_per_s"] = r["events"] / r["wall"]
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
