"""Job lists and trace planes of a configuration, made again from the
scenario seed: the plain reference's own generators (NumPy and the
standard library only).

A configuration file (``portbench/configs/<name>.json``) names its
``generator`` and carries every number it needs: the cluster, the job
count, the arrival horizon, the iteration range and the model table.
:func:`lane_planes` turns one seed into the float32 struct-of-arrays
planes the fluid tick reads.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: (arrival, n_gpus, iterations, model name) of one job
Job = Tuple[float, int, int, str]


def _paper_trace(cfg: dict, seed: int) -> List[Job]:
    """The paper's Sec. V-A workload: GPU counts from the published
    distribution (scaled to ``n_jobs``), arrivals in whole seconds over
    the horizon, iterations uniform, models uniform over the table."""
    rng = random.Random(seed)
    n_jobs = cfg["n_jobs"]
    models = list(cfg["models"])
    dist = cfg["gpu_distribution"]
    total = sum(c for _, c in dist)
    gpus: List[int] = []
    for g, count in dist:
        gpus.extend([g] * (max(1, round(count * n_jobs / total)) if count else 0))
    rng.shuffle(gpus)
    gpus = gpus[:n_jobs]
    gpus += [1] * (n_jobs - len(gpus))
    jobs = []
    for k in range(n_jobs):
        arrival = float(int(rng.uniform(1.0, cfg["horizon_s"])))
        iters = rng.randint(cfg["min_iters"], cfg["max_iters"])
        jobs.append((arrival, k, gpus[k], iters, rng.choice(models)))
    jobs.sort(key=lambda j: (j[0], j[1]))
    return [(a, g, it, m) for a, _, g, it, m in jobs]


GENERATORS = {"paper_trace": _paper_trace}


def job_list(cfg: dict, seed: int) -> List[Job]:
    return GENERATORS[cfg["generator"]](cfg, seed)


def lane_planes(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """float32/int32 planes of one seed's jobs: ``arrival``, ``iters``,
    ``t_iter`` (forward + backward seconds), ``msg_bytes`` and ``n_gpus``."""
    jobs = job_list(cfg, seed)
    models = cfg["models"]
    return {
        "arrival": np.array([j[0] for j in jobs], np.float32),
        "n_gpus": np.array([j[1] for j in jobs], np.int32),
        "iters": np.array([j[2] for j in jobs], np.float32),
        "t_iter": np.array([models[j[3]]["t_f"] + models[j[3]]["t_b"] for j in jobs],
                           np.float32),
        "msg_bytes": np.array([models[j[3]]["size_bytes"] for j in jobs], np.float32),
    }


def stack(planes: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Lanes of equal job count stacked on a leading axis."""
    return {k: np.stack([p[k] for p in planes])
            for k in ("arrival", "n_gpus", "iters", "t_iter", "msg_bytes")}
