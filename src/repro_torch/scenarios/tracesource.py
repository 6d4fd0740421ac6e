"""Trace-replay sources (port of ``repro/scenarios/tracesource.py``):
streamed arrival feeds behind the :class:`~repro_torch.core.trace.TraceSource`
protocol, so the event engine's calendar holds O(live jobs + cluster)
entries at any trace length.

* :class:`SyntheticTraceSource` — a lazy paper-style workload: Poisson
  arrivals, the Table III model mix, Philly-flavoured GPU requests;
  deterministic per seed and restartable.
* :class:`CsvTraceSource` — Philly- or Alibaba-style CSV replays, streamed
  row by row; wall-clock durations become iteration counts through each
  model's per-iteration compute time.

Importing this module registers the ``trace_replay_synth``,
``trace_replay_philly`` and ``trace_replay_alibaba`` scenarios, which read
the port's own copies of the two bundled 40-row samples (``data/``).  At
registry scale the job tuple is materialized too; ``run_scenario_event``
feeds the engine the source.  :func:`trace_source_from_spec` parses
``"synth"``, ``"philly"``, ``"alibaba"`` or ``"csv:<dialect>:<path>"``.
"""

from __future__ import annotations

import csv
import pathlib
import random
from typing import Iterator, Optional, Sequence, Tuple

from repro_torch.core.cluster import TABLE_III, JobSpec, ModelProfile
from repro_torch.core.contention import ContentionParams
from repro_torch.core.trace import TraceSource
from repro_torch.scenarios.registry import Scenario, register

#: The bundled sample replays (40-row CSVs in the published column
#: conventions, byte-equal copies of the reference's) the registered CSV
#: scenarios read.
DATA_DIR = pathlib.Path(__file__).parent / "data"

#: GPU-request mix of the synthetic replay stream: single-GPU dominated
#: (Philly-flavoured) so a sustained open-arrival stream drains on a
#: moderate cluster while multi-server gangs still exercise the comm path.
REPLAY_GPU_WEIGHTS: Tuple[Tuple[int, float], ...] = (
    (1, 0.55),
    (2, 0.20),
    (4, 0.14),
    (8, 0.09),
    (16, 0.02),
)


def _default_models() -> Tuple[ModelProfile, ...]:
    """Table III profiles in sorted-name order (deterministic: dict order
    is insertion order, but sorting decouples the stream from it)."""
    return tuple(TABLE_III[k] for k in sorted(TABLE_III))


class SyntheticTraceSource(TraceSource):
    """Lazy paper-style workload at open-ended scale.

    Arrivals form a Poisson process of ``rate`` jobs/s (floored to the
    trace generator's 1 s submission ticks, hence nondecreasing);
    iterations ~ U{min_iters..max_iters}; models sampled from Table III;
    GPU requests from ``gpu_weights``.  Every draw derives from ``seed``,
    so one ``(n_jobs, seed)`` pair pins the stream bitwise and
    ``arrivals()`` can be replayed any number of times.
    """

    def __init__(
        self,
        n_jobs: int,
        seed: int = 0,
        rate: float = 1.0,
        min_iters: int = 30,
        max_iters: int = 120,
        gpu_weights: Tuple[Tuple[int, float], ...] = REPLAY_GPU_WEIGHTS,
        models: Optional[Sequence[ModelProfile]] = None,
        start_at: float = 1.0,
    ) -> None:
        if n_jobs < 1:
            raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
        if rate <= 0.0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.n_jobs = int(n_jobs)
        self.seed = seed
        self.rate = float(rate)
        self.min_iters = int(min_iters)
        self.max_iters = int(max_iters)
        self.gpu_weights = tuple(gpu_weights)
        self.models = tuple(models) if models is not None else _default_models()
        self.start_at = float(start_at)

    def arrivals(self) -> Iterator[JobSpec]:
        rng = random.Random(self.seed)
        sizes = [g for g, _ in self.gpu_weights]
        weights = [w for _, w in self.gpu_weights]
        t = self.start_at
        for k in range(self.n_jobs):
            t += rng.expovariate(self.rate)
            yield JobSpec(
                job_id=k,
                arrival=float(int(t)),  # 1 s submission ticks
                n_gpus=rng.choices(sizes, weights)[0],
                iterations=rng.randint(self.min_iters, self.max_iters),
                model=rng.choice(self.models),
            )

    def n_jobs_hint(self) -> Optional[int]:
        return self.n_jobs


#: CSV dialects: column names for (arrival, gpus, duration) in the two
#: published trace conventions.  ``gpu_scale`` divides the raw GPU column
#: (Alibaba's ``plan_gpu`` is a percentage: 800 -> 8 GPUs).
CSV_DIALECTS = {
    "philly": dict(
        arrival="submit_time", gpus="ngpus", duration="runtime_s",
        gpu_scale=1.0,
    ),
    "alibaba": dict(
        arrival="submit_time", gpus="plan_gpu", duration=None,
        end="end_time", gpu_scale=100.0,
    ),
}


class CsvTraceSource(TraceSource):
    """Philly/Alibaba-style CSV replay, streamed row by row.

    The file must be sorted by arrival (the real published traces are;
    the engine validates and raises otherwise).  Rows map to jobs as:

    * ``job_id`` — the 0-based row index (stable across replays),
    * ``arrival`` — the dialect's submit column times ``time_scale``,
    * ``n_gpus`` — the dialect's GPU column over its ``gpu_scale``
      (rounded up to >= 1),
    * ``model`` — Table III profile ``index % len(models)`` (a
      deterministic round-robin; NOT ``hash()``, which is salted),
    * ``iterations`` — the row's wall-clock duration times ``time_scale``
      divided by the model's per-iteration compute time (>= 1).

    ``time_scale`` compresses day-long production traces into simulation
    budgets; ``max_jobs`` truncates the stream (for smoke runs against a
    full-size file).  Only the path/dialect/knobs are held in memory —
    each ``arrivals()`` call re-opens the file.
    """

    def __init__(
        self,
        path: str,
        dialect: str = "philly",
        time_scale: float = 1.0,
        max_jobs: Optional[int] = None,
        models: Optional[Sequence[ModelProfile]] = None,
    ) -> None:
        if dialect not in CSV_DIALECTS:
            raise ValueError(
                f"unknown CSV dialect {dialect!r}; known: {sorted(CSV_DIALECTS)}"
            )
        if time_scale <= 0.0:
            raise ValueError(f"time_scale must be > 0, got {time_scale}")
        self.path = str(path)
        self.dialect = dialect
        self.time_scale = float(time_scale)
        self.max_jobs = max_jobs
        self.models = tuple(models) if models is not None else _default_models()

    def arrivals(self) -> Iterator[JobSpec]:
        spec = CSV_DIALECTS[self.dialect]
        with open(self.path, newline="") as fh:
            reader = csv.DictReader(fh)
            for k, row in enumerate(reader):
                if self.max_jobs is not None and k >= self.max_jobs:
                    return
                arrival = float(row[spec["arrival"]]) * self.time_scale
                if spec["duration"] is not None:
                    duration = float(row[spec["duration"]])
                else:
                    duration = float(row[spec["end"]]) - float(
                        row[spec["arrival"]]
                    )
                raw_gpus = float(row[spec["gpus"]]) / spec["gpu_scale"]
                n_gpus = max(1, int(round(raw_gpus)))
                model = self.models[k % len(self.models)]
                iters = max(
                    1,
                    int(duration * self.time_scale / model.t_iter_compute),
                )
                yield JobSpec(
                    job_id=k,
                    arrival=arrival,
                    n_gpus=n_gpus,
                    iterations=iters,
                    model=model,
                )


def trace_source_from_spec(
    spec: str, n_jobs: int = 100_000, seed: int = 0
) -> TraceSource:
    """Parse a ``--trace-source`` CLI string into a source.

    ``"synth"`` — :class:`SyntheticTraceSource` of ``n_jobs`` jobs at the
    reference's replay sizing: short jobs (3-9 iterations) arriving at 6/s,
    just above a 16x2 cluster's service capacity, so the wait queue is
    busy while the calendar stays O(live jobs) (queued jobs hold no
    calendar entries).
    ``"philly"`` / ``"alibaba"`` — the bundled sample CSV of that dialect
    (``max_jobs=n_jobs``); ``"csv:<dialect>:<path>"`` — an external CSV.
    """
    if spec == "synth":
        return SyntheticTraceSource(
            n_jobs=n_jobs, seed=seed, rate=6.0, min_iters=3, max_iters=9
        )
    if spec in CSV_DIALECTS:
        return CsvTraceSource(
            str(DATA_DIR / f"{spec}_sample.csv"), dialect=spec, max_jobs=n_jobs
        )
    if spec.startswith("csv:"):
        try:
            _, dialect, path = spec.split(":", 2)
        except ValueError:
            raise ValueError(
                f"bad --trace-source {spec!r}: expected csv:<dialect>:<path>"
            ) from None
        return CsvTraceSource(path, dialect=dialect, max_jobs=n_jobs)
    raise ValueError(
        f"unknown trace source {spec!r}: expected 'synth', "
        f"{sorted(CSV_DIALECTS)}, or 'csv:<dialect>:<path>'"
    )


# ---------------------------------------------------------------------------
# Registered trace-replay scenarios
# ---------------------------------------------------------------------------

#: Above this job count the registered builders do not materialize the job
#: tuple: the scenario carries only the lazy source and memory stays
#: O(live jobs).
MATERIALIZE_BELOW = 20_000


def _replay_scenario(
    name: str, source: TraceSource, seed: int, materialize: bool, **kw
) -> Scenario:
    jobs: Tuple[JobSpec, ...] = ()
    if materialize:
        jobs = tuple(source.materialize())
    return Scenario(
        name=name,
        seed=seed,
        jobs=jobs,
        source=source,
        params=ContentionParams(),
        **kw,
    )


@register(
    "trace_replay_synth",
    "Streaming synthetic replay: Poisson open arrivals of Philly-mix jobs "
    "consumed lazily through the TraceSource protocol — the event calendar "
    "holds O(live jobs + cluster) entries, so the same scenario scales from "
    "the seconds-long regression cell to the nightly 100k-job replay",
)
def trace_replay_synth(
    seed: int = 0,
    n_jobs: int = 400,
    rate: float = 1.0,
    min_iters: int = 30,
    max_iters: int = 120,
    n_servers: int = 8,
    gpus_per_server: int = 4,
) -> Scenario:
    """Streamed synthetic replay: Poisson open arrivals of Philly-mix jobs
    consumed lazily through the TraceSource protocol; the event calendar
    holds O(live jobs + cluster) entries, so the same scenario scales from
    a seconds-long cell to a 100k-job replay."""
    src = SyntheticTraceSource(
        n_jobs=n_jobs,
        seed=seed,
        rate=rate,
        min_iters=min_iters,
        max_iters=max_iters,
    )
    return _replay_scenario(
        "trace_replay_synth",
        src,
        seed,
        materialize=n_jobs <= MATERIALIZE_BELOW,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
    )


@register(
    "trace_replay_philly",
    "Philly-dialect CSV replay (bundled sample in the published "
    "submit/ngpus/runtime column convention), streamed row by row through "
    "the TraceSource protocol; point ``path=`` at a full cluster_job_log "
    "export for production-scale replays",
)
def trace_replay_philly(
    seed: int = 0,
    path: Optional[str] = None,
    time_scale: float = 1.0,
    max_jobs: Optional[int] = None,
    n_servers: int = 8,
    gpus_per_server: int = 4,
) -> Scenario:
    """Philly-dialect CSV replay (the bundled sample in the published
    submit/ngpus/runtime column convention), streamed row by row; ``path``
    points it at a full cluster job log export."""
    src = CsvTraceSource(
        path or str(DATA_DIR / "philly_sample.csv"),
        dialect="philly",
        time_scale=time_scale,
        max_jobs=max_jobs,
    )
    return _replay_scenario(
        "trace_replay_philly",
        src,
        seed,
        # bundled sample: tiny; an external file is materialized only when
        # max_jobs bounds it to regression scale
        materialize=path is None
        or (max_jobs is not None and max_jobs <= MATERIALIZE_BELOW),
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
    )


@register(
    "trace_replay_alibaba",
    "Alibaba-dialect CSV replay (bundled sample in the cluster-trace "
    "submit/end/plan_gpu convention, plan_gpu in GPU-percent), streamed "
    "through the TraceSource protocol",
)
def trace_replay_alibaba(
    seed: int = 0,
    path: Optional[str] = None,
    time_scale: float = 1.0,
    max_jobs: Optional[int] = None,
    n_servers: int = 8,
    gpus_per_server: int = 4,
) -> Scenario:
    """Alibaba-dialect CSV replay (the bundled sample in the cluster-trace
    submit/end/plan_gpu convention, plan_gpu in GPU-percent), streamed row
    by row."""
    src = CsvTraceSource(
        path or str(DATA_DIR / "alibaba_sample.csv"),
        dialect="alibaba",
        time_scale=time_scale,
        max_jobs=max_jobs,
    )
    return _replay_scenario(
        "trace_replay_alibaba",
        src,
        seed,
        materialize=path is None
        or (max_jobs is not None and max_jobs <= MATERIALIZE_BELOW),
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
    )
