"""The one traffic generator: batches of Monte-Carlo seeds for a closed
loop with one caller.

A traffic file fixes the batch width (``lanes``).  The scenario seeds of
each batch are drawn from ``--seed`` and the batch index, so no two
batches of a run, and no two runs of different seeds, simulate the same
scenarios: nothing that remembers a scenario or its traces can pass for
speed.  Two runs of one ``--seed`` do the same work.  ``--seed`` alone
chooses which finished lanes the reference checks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *salt])


def batch_seeds(traffic: dict, seed: int, batch: int) -> List[int]:
    """The scenario seed of each lane of batch ``batch``: ``lanes``
    distinct seeds below 2**31."""
    picks = _rng(seed, 1, batch).choice(1 << 31, size=traffic["lanes"], replace=False)
    return [int(s) for s in picks]


def check_sample(makespans: Sequence[np.ndarray], k: int, seed: int) -> List[Tuple[int, int]]:
    """(batch, lane) pairs the reference checks: the lane with the longest
    makespan in the window, and ``k - 1`` more drawn from ``seed``."""
    pairs = [(b, l) for b, m in enumerate(makespans) for l in range(len(m))]
    longest = max(pairs, key=lambda p: (makespans[p[0]][p[1]], -p[0], -p[1]))
    rest = [p for p in pairs if p != longest]
    picks = _rng(seed, 2).choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(picks)]
