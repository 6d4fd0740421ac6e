"""Per-run scheduling metrics of the fluid backend (port of
``repro/scenarios/metrics.py``, trimmed to the fields a fluid run fills).

One :class:`RunMetrics` per (scenario, seed, placement, comm policy) run;
:class:`CellCI` aggregates the seeds of one cell into mean +/- std.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple


def median(xs: Sequence[float]) -> float:
    """Median (mean of the middle two for even-length lists)."""
    if not xs:
        return math.nan
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile, q in [0, 1]."""
    if not xs:
        return math.nan
    ys = sorted(xs)
    idx = min(len(ys) - 1, int(math.ceil(q * len(ys))) - 1)
    return ys[max(0, idx)]


@dataclasses.dataclass(frozen=True)
class RunMetrics:
    scenario: str
    backend: str
    placement: str
    comm: str
    seed: int
    n_jobs: int
    n_finished: int
    avg_jct: float
    median_jct: float
    p95_jct: float
    makespan: float
    wall_s: float = 0.0
    #: jobs with no finish time (horizon cutoff) — never silent
    censored: int = 0
    p99_jct: float = math.nan
    #: chunks the fluid driver ran for the batch this run belonged to
    #: (``chunk_steps`` executed ticks each)
    chunks: int = 0


def from_jcts(
    jcts: Sequence[float],
    *,
    scenario: str,
    backend: str,
    placement: str,
    comm: str,
    seed: int,
    n_jobs: int,
    makespan: float,
    wall_s: float = 0.0,
    chunks: int = 0,
) -> RunMetrics:
    jcts = [float(x) for x in jcts]
    n_fin = len(jcts)
    return RunMetrics(
        scenario=scenario,
        backend=backend,
        placement=placement,
        comm=comm,
        seed=seed,
        n_jobs=n_jobs,
        n_finished=n_fin,
        avg_jct=(sum(jcts) / n_fin) if n_fin else math.nan,
        median_jct=median(jcts),
        p95_jct=percentile(jcts, 0.95),
        makespan=float(makespan),
        wall_s=wall_s,
        censored=n_jobs - n_fin,
        p99_jct=percentile(jcts, 0.99),
        chunks=chunks,
    )


@dataclasses.dataclass(frozen=True)
class CellCI:
    """Mean +/- std over seeds for one scenario x backend x placement x
    comm cell."""

    scenario: str
    backend: str
    placement: str
    comm: str
    n_seeds: int
    avg_jct_mean: float
    avg_jct_std: float
    p95_jct_mean: float
    makespan_mean: float
    makespan_std: float
    finished_frac: float
    wall_s: float


def _mean_std(xs: Sequence[float]) -> Tuple[float, float]:
    if not xs:
        return math.nan, math.nan
    mu = sum(xs) / len(xs)
    var = sum((x - mu) ** 2 for x in xs) / len(xs)
    return mu, math.sqrt(var)


def ci_from_runs(records: Sequence[RunMetrics]) -> List[CellCI]:
    """Collapse per-seed records into one :class:`CellCI` per (scenario,
    backend, placement, comm) cell — population std over seeds."""
    groups: Dict[Tuple[str, str, str, str], List[RunMetrics]] = {}
    for r in records:
        groups.setdefault((r.scenario, r.backend, r.placement, r.comm), []).append(r)
    out: List[CellCI] = []
    for (scn, backend, placement, comm), rs in sorted(groups.items()):
        avg_mu, avg_sd = _mean_std([r.avg_jct for r in rs])
        p95_mu, _ = _mean_std([r.p95_jct for r in rs])
        mk_mu, mk_sd = _mean_std([r.makespan for r in rs])
        out.append(
            CellCI(
                scenario=scn,
                backend=backend,
                placement=placement,
                comm=comm,
                n_seeds=len(rs),
                avg_jct_mean=avg_mu,
                avg_jct_std=avg_sd,
                p95_jct_mean=p95_mu,
                makespan_mean=mk_mu,
                makespan_std=mk_sd,
                finished_frac=sum(r.n_finished for r in rs)
                / max(1, sum(r.n_jobs for r in rs)),
                wall_s=sum(r.wall_s for r in rs),
            )
        )
    return out
