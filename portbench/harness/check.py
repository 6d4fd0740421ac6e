"""Whether what the timed path produced is correct: a sample of the lanes
the window finished (drawn from ``--seed``, the longest always in it),
each simulated again by the plain reference from its scenario seed, in
worker processes once the window has closed.

Three numbers are compared, each against its limit:

* ``finished_mismatch``: jobs finished on one side only;
* ``jct_gap_ticks``: the widest gap of a job's JCT, in ticks, over the
  jobs finished on both sides;
* ``makespan_gap_ticks``: the widest gap of a lane's makespan, in ticks.

The simulation is exact (float32 throughout, and every finish lands on
a tick), so each limit is 0.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import resource_tracker
from typing import Dict, List, Sequence, Tuple

import numpy as np

LIMITS = {"finished_mismatch": 0, "jct_gap_ticks": 0, "makespan_gap_ticks": 0}


def reference_lane(cfg: dict, seed: int, policy: str, placement: str,
                   prec: str = "f32") -> Dict[str, np.ndarray]:
    """One lane of the plain reference (a worker's task)."""
    from portbench.reference import fluid, jobs

    out = fluid.simulate(cfg, jobs.stack([jobs.lane_planes(cfg, seed)]), policy,
                         placement, prec)
    return {k: v[0] for k, v in out.items()}


def run_reference(cfg: dict, seeds: Sequence[int], policy: str, placement: str,
                  prec: str = "f32", workers: int = 0) -> Dict[int, dict]:
    """The reference of each distinct seed, one spawned worker per seed."""
    seeds = sorted(set(seeds))
    workers = workers or max(1, min(len(seeds), (os.cpu_count() or 2) - 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futs = {s: pool.submit(reference_lane, cfg, s, policy, placement, prec) for s in seeds}
        out = {s: f.result() for s, f in futs.items()}
    # The pool's semaphores started multiprocessing's resource tracker, which
    # some Pythons (3.12.3 among them) leave running at exit, to end unreaped.
    # Free the semaphores, whose finalizers message the tracker, then end the
    # tracker and wait for it, so that no process of the run outlives it.
    del pool, futs
    gc.collect()
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    return out


def compare(got: Sequence[dict], want: Sequence[dict], dt: float) -> Dict[str, float]:
    """The three compared numbers over lanes paired in order."""
    mismatch, jct_gap, mk_gap = 0, 0.0, 0.0
    for g, w in zip(got, want):
        gf, wf = np.asarray(g["finished"], bool), np.asarray(w["finished"], bool)
        mismatch += int((gf != wf).sum())
        both = gf & wf
        if both.any():
            gap = np.abs(np.asarray(g["jct"], np.float64)[both]
                         - np.asarray(w["jct"], np.float64)[both]).max()
            jct_gap = max(jct_gap, float(gap) / dt)
        mk_gap = max(mk_gap, abs(float(g["makespan"]) - float(w["makespan"])) / dt)
    return {"finished_mismatch": mismatch, "jct_gap_ticks": jct_gap,
            "makespan_gap_ticks": mk_gap}


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def check_lanes(cfg: dict, traffic: dict, pairs: List[Tuple[int, int]],
                seeds_of: Dict[Tuple[int, int], int], results: Dict[tuple, dict],
                prec: str = "f32") -> Dict[str, float]:
    ref = run_reference(cfg, [seeds_of[p] for p in pairs], traffic["policy"],
                        traffic["placement"], prec)
    return compare([results[p] for p in pairs], [ref[seeds_of[p]] for p in pairs], cfg["dt"])
