"""Per-run scheduling metrics of both backends (port of
``repro/scenarios/metrics.py``).

One :class:`RunMetrics` per (scenario, seed, placement, comm policy,
backend) run, printable as a CSV row; :class:`CellCI` aggregates the
seeds of one cell into mean +/- std; :func:`summarize` averages a sweep's
records per cell; :func:`replay_summary` flattens one replay's windowed
steady-state view.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.engine import SimResult, median, percentile

#: the reference's CSV columns, in its order
CSV_FIELDS = (
    "scenario",
    "backend",
    "placement",
    "comm",
    "sched",
    "seed",
    "n_jobs",
    "n_finished",
    "censored",
    "avg_jct",
    "median_jct",
    "p95_jct",
    "makespan",
    "gpu_util",
    "comm_contended",
    "comm_clean",
    "preemptions",
    "resizes",
    "faults",
    "cancelled",
    "work_lost",
    "p99_jct",
    "goodput",
    "wall_s",
    "peak_calendar",
    "stretch_frac",
    "gating_frac",
)


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
    #: the event engine's fields (NaN / 0 on a fluid run): utilization,
    #: contended and clean comm starts, the scheduling policy, its
    #: preemption, resize, fault and cancellation counts, goodput and the
    #: calendar's high-water mark
    gpu_util: float = math.nan
    comm_contended: int = 0
    comm_clean: int = 0
    sched: str = "static"
    preemptions: int = 0
    resizes: int = 0
    faults: int = 0
    cancelled: int = 0
    work_lost: int = 0
    goodput: float = 0.0
    peak_calendar: int = 0
    #: mean fraction of a finished job's JCT lost to contention stretch /
    #: gating wait (the observability decomposition); NaN when the run was
    #: not observed — absent data, not zero
    stretch_frac: float = math.nan
    gating_frac: float = math.nan

    def as_csv_row(self) -> str:
        vals = []
        for f in CSV_FIELDS:
            v = getattr(self, f)
            if isinstance(v, float):
                # fractions are small: two decimals would round them to 0
                vals.append(f"{v:.4f}" if f.endswith("_frac") else f"{v:.2f}")
            else:
                vals.append(str(v))
        return ",".join(vals)

    @staticmethod
    def csv_header() -> str:
        return ",".join(CSV_FIELDS)


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
    gpu_util: float = math.nan,
    comm_contended: int = 0,
    comm_clean: int = 0,
    sched: str = "static",
    censored: Optional[int] = None,
    preemptions: int = 0,
    resizes: int = 0,
    faults: int = 0,
    cancelled: int = 0,
    work_lost: int = 0,
    p99_jct: Optional[float] = None,
    goodput: float = 0.0,
    peak_calendar: int = 0,
    stretch_frac: float = math.nan,
    gating_frac: float = math.nan,
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
        censored=(n_jobs - n_fin) if censored is None else censored,
        p99_jct=percentile(jcts, 0.99) if p99_jct is None else float(p99_jct),
        chunks=chunks,
        gpu_util=float(gpu_util),
        comm_contended=comm_contended,
        comm_clean=comm_clean,
        sched=sched,
        preemptions=preemptions,
        resizes=resizes,
        faults=faults,
        cancelled=cancelled,
        work_lost=work_lost,
        goodput=goodput,
        peak_calendar=peak_calendar,
        stretch_frac=stretch_frac,
        gating_frac=gating_frac,
    )


def from_event_result(
    res: SimResult,
    *,
    scenario: str,
    seed: int,
    n_jobs: int,
    wall_s: float = 0.0,
) -> RunMetrics:
    """The record of one event-engine run; ``stretch_frac`` and
    ``gating_frac`` come from the observability report, NaN when the run
    was not observed."""
    return from_jcts(
        list(res.jct.values()),
        scenario=scenario,
        backend="event",
        placement=res.placement_name,
        comm=res.policy_name,
        seed=seed,
        n_jobs=n_jobs,
        makespan=res.makespan,
        gpu_util=res.gpu_util,
        comm_contended=res.comm_started_contended,
        comm_clean=res.comm_started_clean,
        wall_s=wall_s,
        sched=res.sched_name,
        censored=res.censored,
        preemptions=res.preemptions,
        resizes=res.resizes,
        faults=res.faults,
        cancelled=res.cancelled,
        work_lost=res.work_lost_samples,
        p99_jct=res.p99_jct(),
        goodput=res.goodput,
        peak_calendar=res.peak_calendar,
        stretch_frac=(
            res.obs.mean_stretch_frac() if res.obs is not None else math.nan
        ),
        gating_frac=(
            res.obs.mean_gating_frac() if res.obs is not None else math.nan
        ),
    )


def replay_summary(
    res: SimResult, window_s: float, warmup_frac: float = 0.1
) -> Dict[str, float]:
    """Flat windowed steady-state summary of one (typically streamed)
    replay: ``SimResult.steady_state``'s sustained goodput, finish rate,
    p99 JCT and queueing delay, the run-level scale counters and, under
    ``profile_phases=True``, the engine's wall seconds per phase, in one
    JSON-ready dict."""
    out = dict(res.steady_state(window_s, warmup_frac=warmup_frac))
    out.update(
        makespan=res.makespan,
        n_finished=float(len(res.jct)),
        censored=float(res.censored),
        goodput=res.goodput,
        events=float(res.events_processed),
        peak_calendar=float(res.peak_calendar),
    )
    if res.phase_seconds:
        out.update({f"phase_{k}_s": float(v) for k, v in res.phase_seconds.items()})
    return out


CI_CSV_FIELDS = (
    "scenario",
    "backend",
    "placement",
    "comm",
    "n_seeds",
    "avg_jct_mean",
    "avg_jct_std",
    "p95_jct_mean",
    "makespan_mean",
    "makespan_std",
    "finished_frac",
    "wall_s",
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

    def as_csv_row(self) -> str:
        vals = []
        for f in CI_CSV_FIELDS:
            v = getattr(self, f)
            vals.append(f"{v:.2f}" if isinstance(v, float) else str(v))
        return ",".join(vals)

    @staticmethod
    def csv_header() -> str:
        return ",".join(CI_CSV_FIELDS)


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


def summarize(records: Sequence[RunMetrics]) -> Dict[str, Dict[str, float]]:
    """Aggregate per (scenario, backend, placement, comm): mean avg-JCT,
    mean makespan, mean utilization and total finished over seeds."""
    groups: Dict[str, List[RunMetrics]] = {}
    for r in records:
        groups.setdefault(
            f"{r.scenario}/{r.backend}/{r.placement}/{r.comm}", []
        ).append(r)
    out: Dict[str, Dict[str, float]] = {}
    for key, rs in sorted(groups.items()):
        out[key] = {
            "avg_jct": sum(r.avg_jct for r in rs) / len(rs),
            "p95_jct": sum(r.p95_jct for r in rs) / len(rs),
            "makespan": sum(r.makespan for r in rs) / len(rs),
            "gpu_util": sum(r.gpu_util for r in rs) / len(rs),
            "finished_frac": sum(r.n_finished for r in rs)
            / max(1, sum(r.n_jobs for r in rs)),
            "n_runs": float(len(rs)),
        }
    return out
