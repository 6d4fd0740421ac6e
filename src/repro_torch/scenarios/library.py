"""The scenario library (port of ``repro/scenarios/library.py``; importing
this module registers every scenario the reference's fluid path accepts):

* ``paper``               — the paper's Section V-A 160-job trace.
* ``philly_heavy_tail``   — Philly-calibrated Pareto iterations, mostly
                            single-GPU jobs.
* ``bursty_diurnal``      — diurnal arrivals plus synchronized bursts.
* ``hetero_bandwidth``    — paper workload, heterogeneous per-server NICs.
* ``large_job_dominated`` — mostly 8..32-GPU multi-server jobs.
* ``adversarial_allbig``  — identical big-message jobs arriving at once.
* ``contended_residue``   — 5-GPU jobs on 4-GPU servers: placements share
                            servers and all-reduces collide.
* ``oversub_fabric``      — paper workload on a two-tier fabric with 3x
                            oversubscribed rack uplinks.
* ``rack_locality``       — rack-sized jobs behind 6x oversubscribed uplinks.
* ``model_zoo``           — jobs of the config-derived model zoo
                            (:mod:`repro_torch.workloads`) with WFBP fusion
                            at 64 MB buckets.
* ``fusion_sweep``        — many-layer zoo jobs forced to span servers: the
                            fusion threshold x policy cell.
* ``preemption_gain``, ``elastic_surge`` — the event engine's preemptive and
                            elastic workloads; the fluid path runs their
                            static mode.
* ``smoke``               — tiny, deterministic.
* ``chaos_steady``, ``chaos_recovery_storm``, ``chaos_stragglers`` — fault
                            injection (breakdowns, a rack-wide recovery
                            storm, stragglers and NIC windows); event
                            engine only.

The ``trace_replay_*`` scenarios are registered by
:mod:`repro_torch.scenarios.tracesource`.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.chaos import ChaosSpec
from repro_torch.core.cluster import TABLE_III, JobSpec, ModelProfile
from repro_torch.core.contention import ContentionParams
from repro_torch.core.topology import two_tier
from repro_torch.core.trace import paper_trace
from repro_torch.scenarios.registry import Scenario, register
from repro_torch.workloads import ZOO_GPU_MEM_MB, zoo_profiles

#: The reference's downsized overrides for the registered scenarios.
QUICK_OVERRIDES = {
    "paper": dict(n_jobs=40, min_iters=100, max_iters=600),
    "philly_heavy_tail": dict(n_jobs=32, min_iters=80, max_iters=1500),
    "bursty_diurnal": dict(n_jobs=32, min_iters=100, max_iters=600),
    "hetero_bandwidth": dict(n_jobs=28, min_iters=100, max_iters=600),
    "large_job_dominated": dict(n_jobs=14, min_iters=100, max_iters=500),
    "adversarial_allbig": dict(n_jobs=8, base_iters=120),
    "contended_residue": {},
    "oversub_fabric": dict(n_jobs=32, min_iters=100, max_iters=600),
    "rack_locality": {},
    "model_zoo": dict(n_jobs=12, min_iters=15, max_iters=60, horizon_s=600.0),
    "fusion_sweep": dict(base_iters=25),
    "preemption_gain": {},
    "elastic_surge": {},
    "smoke": {},
    "chaos_steady": {},
    "chaos_recovery_storm": {},
    "chaos_stragglers": {},
    "trace_replay_synth": dict(n_jobs=64),
    "trace_replay_philly": {},
    "trace_replay_alibaba": {},
}


def _finalize(jobs: List[JobSpec]) -> tuple:
    return tuple(sorted(jobs, key=lambda j: (j.arrival, j.job_id)))


def _sample_models(rng: random.Random) -> ModelProfile:
    return rng.choice(list(TABLE_III.values()))


@register("paper", "Paper Section V-A Microsoft-like trace (160 jobs / 20 min)")
def paper_scenario(
    seed: int = 0,
    n_jobs: int = 160,
    horizon_s: float = 1200.0,
    min_iters: int = 1000,
    max_iters: int = 6000,
    n_servers: int = 16,
    gpus_per_server: int = 4,
    params: Optional[ContentionParams] = None,
) -> Scenario:
    """Paper Section V-A Microsoft-like trace (160 jobs / 20 min)."""
    jobs = paper_trace(
        seed=seed, n_jobs=n_jobs, horizon_s=horizon_s,
        min_iters=min_iters, max_iters=max_iters,
    )
    return Scenario(
        name="paper",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=tuple(jobs),
        params=params or ContentionParams(),
    )


@register(
    "hetero_bandwidth",
    "Paper workload on a cluster with heterogeneous per-server NIC bandwidth",
)
def hetero_bandwidth(
    seed: int = 0,
    n_jobs: int = 100,
    horizon_s: float = 1200.0,
    min_iters: int = 1000,
    max_iters: int = 6000,
    slow_fraction: float = 0.5,
    slow_scale: float = 0.4,
    n_servers: int = 16,
    gpus_per_server: int = 4,
) -> Scenario:
    """Paper workload on a cluster with heterogeneous per-server NIC
    bandwidth (slow servers spread evenly)."""
    jobs = paper_trace(
        seed=seed, n_jobs=n_jobs, horizon_s=horizon_s,
        min_iters=min_iters, max_iters=max_iters,
    )
    n_slow = int(round(slow_fraction * n_servers))
    slow_ids = {int(i * n_servers / max(1, n_slow)) for i in range(n_slow)}
    bandwidth = tuple(slow_scale if s in slow_ids else 1.0 for s in range(n_servers))
    return Scenario(
        name="hetero_bandwidth",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=tuple(jobs),
        params=ContentionParams(server_bandwidth=bandwidth),
    )


@register(
    "contended_residue",
    "Jobs one GPU wider than a server: every placement leaves a cross-server "
    "residue, so resident jobs share servers and their all-reduces collide — "
    "the cell where comm gating policies differentiate on both backends",
)
def contended_residue(
    seed: int = 0,
    n_jobs: int = 6,
    n_gpus_per_job: int = 5,
    base_iters: int = 40,
    iter_jitter: float = 0.2,
    wave_size: int = 3,
    model: str = "vgg16",
    n_servers: int = 4,
    gpus_per_server: int = 4,
) -> Scenario:
    """Jobs one GPU wider than a server, arriving in waves: every placement
    leaves a cross-server residue, so all-reduces collide."""
    rng = random.Random(seed)
    profile = TABLE_III[model]
    jobs = []
    for k in range(n_jobs):
        iters = int(base_iters * (1.0 + rng.uniform(-iter_jitter, iter_jitter)))
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(k // wave_size),
                n_gpus=n_gpus_per_job,
                iterations=max(1, iters),
                model=profile,
            )
        )
    return Scenario(
        name="contended_residue",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
    )


@register(
    "oversub_fabric",
    "Paper workload on a blocking two-tier fabric: per-server NICs plus "
    "oversubscribed rack (ToR) uplinks — cross-rack all-reduces drain at the "
    "oversub-weighted Eq. (5) rate, so topology-blind placement pays",
)
def oversub_fabric(
    seed: int = 0,
    n_jobs: int = 120,
    horizon_s: float = 1200.0,
    min_iters: int = 1000,
    max_iters: int = 6000,
    n_servers: int = 16,
    gpus_per_server: int = 4,
    servers_per_rack: int = 4,
    oversub: float = 3.0,
) -> Scenario:
    """Paper workload on a blocking two-tier fabric: per-server NICs plus
    oversubscribed rack uplinks."""
    jobs = paper_trace(
        seed=seed, n_jobs=n_jobs, horizon_s=horizon_s,
        min_iters=min_iters, max_iters=max_iters,
    )
    return Scenario(
        name="oversub_fabric",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=tuple(jobs),
        params=ContentionParams(),
        topology=two_tier(n_servers, servers_per_rack, oversub=oversub),
    )


@register(
    "smoke",
    "Tiny deterministic 6-job / 8-GPU scenario for differential + CI tests",
)
def smoke(seed: int = 0, n_servers: int = 4, gpus_per_server: int = 2) -> Scenario:
    """Tiny deterministic 6-job / 8-GPU scenario."""
    t3 = TABLE_III
    jobs = (
        # (job_id, arrival, n_gpus, iterations, model)
        JobSpec(0, 0.0, 4, 30, t3["resnet50"]),      # spans 2 servers -> comm
        JobSpec(1, 0.0, 4, 25, t3["vgg16"]),         # big message, spans 2
        JobSpec(2, 1.0, 1, 60, t3["lstm_ptb"]),      # single GPU, no comm
        JobSpec(3, 2.0, 2, 40, t3["inception_v3"]),  # fits one server
        JobSpec(4, 3.0, 4, 20, t3["resnet50"]),      # queued until GPUs free
        JobSpec(5, 5.0, 1, 50, t3["resnet50"]),
    )
    return Scenario(
        name="smoke",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=jobs,
        params=ContentionParams(),
    )


#: Published Philly-trace job statistics (Jeon et al., "Analysis of
#: Large-Scale Multi-Tenant GPU Clusters for DNN Training Workloads",
#: USENIX ATC 2019; approximate values read off the duration CDF and the
#: GPU-request distribution).  We calibrate the *shape* of the generator
#: against the scale-free duration-quantile ratios (median ~13 min,
#: p90 ~3.8 h, p95 ~12 h) rather than absolute seconds, since every
#: scenario here is rescaled for simulation budget anyway.  Locked by the
#: fixed-seed quantile test in tests/test_scenarios.py.
PHILLY_DURATION_P90_OVER_P50 = 17.5
PHILLY_DURATION_P95_OVER_P50 = 55.0
#: Pareto tail index alpha solving the untruncated-Pareto identity
#: p90/p50 = 5**(1/alpha) for the published ratio (~0.56: much heavier
#: than the previous hand-picked 1.2 — the real trace's mean is dominated
#: by the rare day-long jobs).
PHILLY_PARETO_ALPHA = math.log(5.0) / math.log(PHILLY_DURATION_P90_OVER_P50)
#: GPU-request mix (same source): single-GPU jobs dominate.
PHILLY_GPU_WEIGHTS = (
    (1, 0.80),
    (2, 0.055),
    (4, 0.065),
    (8, 0.06),
    (16, 0.015),
    (32, 0.005),
)


@register(
    "philly_heavy_tail",
    "Philly-calibrated heavy tails: Pareto iterations matching the published "
    "duration-quantile ratios, single-GPU-dominated request mix",
)
def philly_heavy_tail(
    seed: int = 0,
    n_jobs: int = 120,
    horizon_s: float = 1200.0,
    min_iters: int = 100,
    max_iters: int = 35000,
    pareto_alpha: float = PHILLY_PARETO_ALPHA,
    n_servers: int = 16,
    gpus_per_server: int = 4,
) -> Scenario:
    """Philly-calibrated heavy tails: Pareto iterations matching the
    published duration-quantile ratios, single-GPU-dominated request mix."""
    rng = random.Random(seed)
    sizes = [g for g, _ in PHILLY_GPU_WEIGHTS]
    weights = [w for _, w in PHILLY_GPU_WEIGHTS]
    jobs = []
    for k in range(n_jobs):
        arrival = float(int(rng.uniform(1.0, horizon_s)))
        iters = min(max_iters, int(min_iters * rng.paretovariate(pareto_alpha)))
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=arrival,
                n_gpus=rng.choices(sizes, weights)[0],
                iterations=iters,
                model=_sample_models(rng),
            )
        )
    return Scenario(
        name="philly_heavy_tail",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
    )


#: Calibrated default arrival intensity for ``bursty_diurnal``: the ratio
#: of the peak arrival rate (at a burst center) to the horizon-mean rate.
#: 4.0 reproduces the previous hand-picked ``burst_frac=0.6`` at the
#: default shape (H=1200, 4 bursts, sigma=H/60) via the identity below —
#: locked by the fixed-seed intensity test in tests/test_scenarios.py.
BURSTY_PEAK_TO_MEAN = 4.0


def burst_fraction(
    peak_to_mean: float, horizon_s: float, n_bursts: int, sigma: float
) -> float:
    """Fraction of jobs routed into bursts so the realized peak-to-mean
    arrival-rate ratio hits ``peak_to_mean``.

    With a fraction ``f`` of N jobs split over ``n_bursts`` Gaussian bursts
    of width ``sigma`` and the rest at roughly the mean baseline rate, the
    rate at a burst center is ``f*N/(n_bursts*sigma*sqrt(2*pi)) +
    (1-f)*N/H``; dividing by the mean ``N/H`` and solving for ``f``:

        f = (P - 1) / (H / (n_bursts*sigma*sqrt(2*pi)) - 1)

    (clipped to [0, 0.95]).  P=1 means no bursts; the ceiling keeps a
    nonzero diurnal baseline."""
    if peak_to_mean < 1.0:
        raise ValueError(f"peak_to_mean must be >= 1, got {peak_to_mean}")
    gain = horizon_s / (n_bursts * sigma * math.sqrt(2.0 * math.pi))
    if gain <= 1.0:
        return 0.0  # bursts wider than the horizon cannot exceed the mean
    return min(0.95, max(0.0, (peak_to_mean - 1.0) / (gain - 1.0)))


@register(
    "bursty_diurnal",
    "Diurnal arrival baseline plus synchronized submission bursts; burst "
    "mass set by the calibrated peak-to-mean arrival-intensity knob",
)
def bursty_diurnal(
    seed: int = 0,
    n_jobs: int = 120,
    horizon_s: float = 1200.0,
    n_bursts: int = 4,
    peak_to_mean: float = BURSTY_PEAK_TO_MEAN,
    min_iters: int = 500,
    max_iters: int = 4000,
    n_servers: int = 16,
    gpus_per_server: int = 4,
) -> Scenario:
    """Diurnal arrival baseline plus synchronized submission bursts; burst
    mass set by the calibrated peak-to-mean arrival-intensity knob."""
    rng = random.Random(seed)
    centers = [rng.uniform(0.1, 0.9) * horizon_s for _ in range(n_bursts)]
    sigma = horizon_s / 60.0
    frac = burst_fraction(peak_to_mean, horizon_s, n_bursts, sigma)
    jobs = []
    for k in range(n_jobs):
        if rng.random() < frac:
            c = rng.choice(centers)
            arrival = min(horizon_s - 1.0, max(1.0, rng.gauss(c, sigma)))
        else:
            # diurnal baseline: accept-reject against a raised sine
            while True:
                t = rng.uniform(1.0, horizon_s)
                if rng.random() < 0.5 * (1.0 + math.sin(2 * math.pi * t / horizon_s)):
                    arrival = t
                    break
        gpus = rng.choices([1, 2, 4, 8], [0.45, 0.2, 0.2, 0.15])[0]
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(int(arrival)),
                n_gpus=gpus,
                iterations=rng.randint(min_iters, max_iters),
                model=_sample_models(rng),
            )
        )
    return Scenario(
        name="bursty_diurnal",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
    )


@register(
    "large_job_dominated",
    "Majority 8..32-GPU multi-server jobs — communication dominates",
)
def large_job_dominated(
    seed: int = 0,
    n_jobs: int = 48,
    horizon_s: float = 900.0,
    min_iters: int = 500,
    max_iters: int = 3000,
    n_servers: int = 16,
    gpus_per_server: int = 4,
) -> Scenario:
    """Majority 8..32-GPU multi-server jobs — communication dominates."""
    rng = random.Random(seed)
    jobs = []
    for k in range(n_jobs):
        gpus = rng.choices([4, 8, 16, 32], [0.15, 0.45, 0.28, 0.12])[0]
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(int(rng.uniform(1.0, horizon_s))),
                n_gpus=gpus,
                iterations=rng.randint(min_iters, max_iters),
                model=_sample_models(rng),
            )
        )
    return Scenario(
        name="large_job_dominated",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
    )


@register(
    "adversarial_allbig",
    "All identical big-message multi-server jobs arriving at once — every "
    "all-reduce collides; worst case for blind comm acceptance",
)
def adversarial_allbig(
    seed: int = 0,
    n_jobs: int = 12,
    n_gpus_per_job: int = 8,
    base_iters: int = 300,
    iter_jitter: float = 0.2,
    model: str = "vgg16",
    n_servers: int = 4,
    gpus_per_server: int = 4,
) -> Scenario:
    """All identical big-message multi-server jobs arriving at once — every
    all-reduce collides; worst case for blind comm acceptance."""
    rng = random.Random(seed)
    profile = TABLE_III[model]
    jobs = []
    for k in range(n_jobs):
        iters = int(base_iters * (1.0 + rng.uniform(-iter_jitter, iter_jitter)))
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(k % 2),  # two back-to-back waves, 1 s apart
                n_gpus=n_gpus_per_job,
                iterations=max(1, iters),
                model=profile,
            )
        )
    return Scenario(
        name="adversarial_allbig",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
    )


@register(
    "rack_locality",
    "Small racks behind heavily oversubscribed uplinks, with a job mix of "
    "rack-sized multi-server jobs plus fragmenting small jobs: rack-aware "
    "placement (lwf_rack / rack_pack) keeps the big jobs off the uplinks, "
    "topology-blind placement splits them across racks",
)
def rack_locality(
    seed: int = 0,
    n_jobs: int = 24,
    horizon_s: float = 240.0,
    min_iters: int = 60,
    max_iters: int = 300,
    n_servers: int = 8,
    gpus_per_server: int = 4,
    servers_per_rack: int = 2,
    oversub: float = 6.0,
) -> Scenario:
    """Small racks behind heavily oversubscribed uplinks, with a job mix of
    rack-sized multi-server jobs plus fragmenting small jobs: rack-aware
    placement (lwf_rack / rack_pack) keeps the big jobs off the uplinks,
    topology-blind placement splits them across racks."""
    rng = random.Random(seed)
    jobs = []
    for k in range(n_jobs):
        if rng.random() < 0.5:
            # fragmenters: odd-sized small jobs that leave partial servers
            gpus = rng.choice([1, 2, 3])
        else:
            # rack-sized: spans servers but fits inside one 2-server rack
            # (8 GPUs) when placed with locality in mind
            gpus = rng.choice([6, 8])
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(int(rng.uniform(0.0, horizon_s))),
                n_gpus=gpus,
                iterations=rng.randint(min_iters, max_iters),
                model=_sample_models(rng),
            )
        )
    return Scenario(
        name="rack_locality",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        topology=two_tier(n_servers, servers_per_rack, oversub=oversub),
    )


@register(
    "model_zoo",
    "Jobs sampled from the config-derived model zoo (repro.workloads): "
    "layer-granular profiles of the real architectures under "
    "src/repro/configs/ on an A100-80G-class data-parallel cluster, with "
    "WFBP tensor fusion at a finite bucket threshold",
)
def model_zoo(
    seed: int = 0,
    n_jobs: int = 48,
    horizon_s: float = 2400.0,
    min_iters: int = 60,
    max_iters: int = 400,
    fusion: object = 64e6,
    n_servers: int = 8,
    gpus_per_server: int = 4,
) -> Scenario:
    """Jobs sampled from the config-derived model zoo
    (repro_torch.workloads): layer-granular profiles of the real
    architectures on an A100-80G-class data-parallel cluster, with WFBP
    tensor fusion at a finite bucket threshold."""
    zoo = zoo_profiles()
    #: small models arrive often, 7-9B trainings are rarer (survey-flavoured
    #: mix) — and GPU requests skew single-digit like the Philly trace
    archs = list(zoo)
    weights = [0.30, 0.25, 0.15, 0.12, 0.09, 0.09][: len(archs)]
    rng = random.Random(seed)
    jobs = []
    for k in range(n_jobs):
        arch = rng.choices(archs, weights)[0]
        gpus = rng.choices([1, 2, 4, 8, 16], [0.35, 0.2, 0.2, 0.17, 0.08])[0]
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(int(rng.uniform(1.0, horizon_s))),
                n_gpus=gpus,
                iterations=rng.randint(min_iters, max_iters),
                model=zoo[arch],
            )
        )
    return Scenario(
        name="model_zoo",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        gpu_mem_mb=ZOO_GPU_MEM_MB,
        fusion=fusion,
    )


@register(
    "fusion_sweep",
    "Alternating many-layer zoo jobs (mamba2-130m / llama3.2-1b) forced to "
    "span servers: the cell where the WFBP fusion threshold matters — a "
    "finite threshold overlaps comm with backward while avoiding the "
    "per-layer latency tax, beating both fusion='all' and fully unfused "
    "under Ada-SRSF (regression-locked in tests/test_wfbp.py)",
)
def fusion_sweep(
    seed: int = 0,
    n_jobs: int = 6,
    n_gpus_per_job: int = 8,
    base_iters: int = 40,
    iter_jitter: float = 0.2,
    wave_size: int = 3,
    fusion: object = 32e6,
    archs: Sequence[str] = ("mamba2_130m", "llama32_1b"),
    n_servers: int = 4,
    gpus_per_server: int = 4,
) -> Scenario:
    """Alternating many-layer zoo jobs (mamba2-130m / llama3.2-1b) forced
    to span servers: the cell where the WFBP fusion threshold matters — a
    finite threshold overlaps comm with backward while avoiding the per-
    layer latency tax, beating both fusion='all' and fully unfused under
    Ada-SRSF (regression-locked in tests/test_wfbp.py)."""
    zoo = zoo_profiles()
    rng = random.Random(seed)
    jobs = []
    for k in range(n_jobs):
        iters = int(base_iters * (1.0 + rng.uniform(-iter_jitter, iter_jitter)))
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(k // wave_size),  # waves of simultaneous barriers
                n_gpus=n_gpus_per_job,
                iterations=max(1, iters),
                # alternating message sizes: AdaDUAL's ratio test gets real
                # small-vs-big decisions (identical sizes always refuse)
                model=zoo[archs[k % len(archs)]],
            )
        )
    return Scenario(
        name="fusion_sweep",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        gpu_mem_mb=ZOO_GPU_MEM_MB,
        fusion=fusion,
    )


@register(
    "preemption_gain",
    "Heavy-tailed service mix on an exclusive-GPU cluster: early elephants "
    "(multi-GPU, long) grab every GPU, then a stream of mice (small, short) "
    "arrives — the cell where Tiresias-style gang preemption "
    "(sched='preemptive_srsf') beats hold-until-completion static SRSF "
    "(regression-locked in tests/test_engine.py)",
)
def preemption_gain(
    seed: int = 0,
    n_elephants: int = 4,
    n_mice: int = 24,
    horizon_s: float = 120.0,
    elephant_iters: Tuple[int, int] = (600, 1200),
    mouse_iters: Tuple[int, int] = (20, 80),
    preemption_quantum: float = 10.0,
    n_servers: int = 4,
    gpus_per_server: int = 4,
) -> Scenario:
    """Heavy-tailed service mix on an exclusive-GPU cluster: early
    elephants (multi-GPU, long) grab every GPU, then a stream of mice
    (small, short) arrives — the cell where Tiresias-style gang preemption
    (sched='preemptive_srsf') beats hold-until-completion static SRSF
    (regression-locked in tests/test_engine.py)."""
    rng = random.Random(seed)
    jobs = []
    jid = 0
    for k in range(n_elephants):
        # elephants arrive first and fill the cluster; every other one
        # spans two servers so preemption also exercises the comm path
        gpus = gpus_per_server if k % 2 == 0 else 2 * gpus_per_server
        jobs.append(
            JobSpec(
                job_id=jid,
                arrival=float(k),
                n_gpus=gpus,
                iterations=rng.randint(*elephant_iters),
                model=TABLE_III["vgg16"],
            )
        )
        jid += 1
    for _ in range(n_mice):
        jobs.append(
            JobSpec(
                job_id=jid,
                arrival=float(int(rng.uniform(5.0, horizon_s))),
                n_gpus=rng.choices([1, 2], [0.7, 0.3])[0],
                iterations=rng.randint(*mouse_iters),
                model=TABLE_III["resnet50"],
            )
        )
        jid += 1
    return Scenario(
        name="preemption_gain",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        exclusive_gpus=True,
        preemption_quantum=preemption_quantum,
    )


@register(
    "elastic_surge",
    "Elastic trainings (min/max GPU bounds) on big exclusive servers, hit "
    "by a mid-run burst of rigid small jobs: sched='elastic' grows the "
    "gangs across idle capacity (2x iteration throughput inside a server), "
    "shrinks them to min at the surge, and regrows afterwards — the "
    "workload where boundary resizes pay for their checkpoint cost",
)
def elastic_surge(
    seed: int = 0,
    n_elastic: int = 4,
    n_surge: int = 12,
    surge_at: float = 12.0,
    elastic_iters: Tuple[int, int] = (700, 1000),
    surge_iters: Tuple[int, int] = (40, 120),
    n_servers: int = 4,
    gpus_per_server: int = 8,
) -> Scenario:
    """Elastic trainings (min/max GPU bounds) on big exclusive servers, hit
    by a mid-run burst of rigid small jobs: sched='elastic' grows the gangs
    across idle capacity (2x iteration throughput inside a server), shrinks
    them to min at the surge, and regrows afterwards — the workload where
    boundary resizes pay for their checkpoint cost."""
    rng = random.Random(seed)
    jobs = []
    jid = 0
    for k in range(n_elastic):
        jobs.append(
            JobSpec(
                job_id=jid,
                arrival=float(k),
                n_gpus=4,
                iterations=rng.randint(*elastic_iters),
                model=TABLE_III["resnet50"],
                min_gpus=2,
                max_gpus=gpus_per_server,  # growth stays inside one server
            )
        )
        jid += 1
    for _ in range(n_surge):
        jobs.append(
            JobSpec(
                job_id=jid,
                arrival=float(int(surge_at + rng.uniform(0.0, 20.0))),
                n_gpus=rng.choices([1, 2], [0.5, 0.5])[0],
                iterations=rng.randint(*surge_iters),
                model=TABLE_III["inception_v3"],
            )
        )
        jid += 1
    return Scenario(
        name="elastic_surge",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        exclusive_gpus=True,
    )


# ---------------------------------------------------------------------------


def _chaos_mixed_jobs(
    rng: random.Random,
    n_jobs: int,
    horizon_s: float,
    iters: Tuple[int, int],
    big_frac: float,
    gpus_per_server: int,
) -> List[JobSpec]:
    """Seed-random mix of single-GPU mice and multi-server gangs (the jobs
    whose all-reduce a breakdown actually aborts)."""
    jobs = []
    for jid in range(n_jobs):
        if rng.random() < big_frac:
            n_gpus = gpus_per_server * rng.choice((1, 2))
            model = _sample_models(rng)
        else:
            n_gpus = rng.choice((1, 2))
            model = TABLE_III["resnet50"]
        jobs.append(
            JobSpec(
                job_id=jid,
                arrival=float(int(rng.uniform(0.0, horizon_s))),
                n_gpus=n_gpus,
                iterations=rng.randint(*iters),
                model=model,
            )
        )
    return jobs


@register(
    "chaos_steady",
    "Steady-state faults: stochastic per-server exponential MTBF/MTTR "
    "breakdowns plus mild straggler jitter over a mixed mouse/gang "
    "workload — the SLO cell (goodput under faults, work lost to "
    "restarts, p99 JCT) of the nightly chaos grid",
)
def chaos_steady(
    seed: int = 0,
    n_jobs: int = 24,
    horizon_s: float = 120.0,
    min_iters: int = 60,
    max_iters: int = 300,
    server_mtbf_s: float = 900.0,
    server_mttr_s: float = 25.0,
    straggler_prob: float = 0.02,
    straggler_slowdown: float = 0.5,
    n_servers: int = 8,
    gpus_per_server: int = 4,
) -> Scenario:
    """Steady-state faults: stochastic per-server exponential MTBF/MTTR
    breakdowns plus mild straggler jitter over a mixed mouse/gang workload —
    the SLO cell (goodput under faults, work lost to restarts, p99 JCT) of
    the nightly chaos grid."""
    rng = random.Random(seed)
    jobs = _chaos_mixed_jobs(
        rng, n_jobs, horizon_s, (min_iters, max_iters), 0.4, gpus_per_server
    )
    return Scenario(
        name="chaos_steady",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        chaos=ChaosSpec(
            seed=seed,
            server_mtbf_s=server_mtbf_s,
            server_mttr_s=server_mttr_s,
            straggler_prob=straggler_prob,
            straggler_slowdown=straggler_slowdown,
        ),
    )


@register(
    "chaos_recovery_storm",
    "Rack-repair recovery storm: half the servers fail at one scripted "
    "instant and all repair together, so every preempted gang re-admits "
    "simultaneously and their catch-up all-reduces collide — the cell "
    "behind the regression-locked finding on whether contention-aware "
    "gating helps or hurts synchronized re-admission "
    "(tests/test_chaos.py::TestRecoveryStormFinding)",
)
def chaos_recovery_storm(
    seed: int = 0,
    n_jobs: int = 20,
    horizon_s: float = 60.0,
    min_iters: int = 80,
    max_iters: int = 260,
    fail_at: float = 70.0,
    repair_at: float = 100.0,
    n_servers: int = 8,
    gpus_per_server: int = 4,
) -> Scenario:
    """Rack-repair recovery storm: half the servers fail at one scripted
    instant and all repair together, so every preempted gang re-admits
    simultaneously and their catch-up all-reduces collide — the cell behind
    the regression-locked finding on whether contention-aware gating helps
    or hurts synchronized re-admission
    (tests/test_chaos.py::TestRecoveryStormFinding)."""
    rng = random.Random(seed)
    # gang-heavy mix: the storm is about colliding catch-up all-reduces
    jobs = _chaos_mixed_jobs(
        rng, n_jobs, horizon_s, (min_iters, max_iters), 0.7, gpus_per_server
    )
    dead_rack = tuple(range(n_servers // 2))
    return Scenario(
        name="chaos_recovery_storm",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        chaos=ChaosSpec(
            seed=seed,
            scripted_failures=tuple(
                (s, fail_at, repair_at) for s in dead_rack
            ),
        ),
    )


@register(
    "chaos_stragglers",
    "Straggler-heavy cell: frequent large compute jitter plus transient "
    "NIC degradation windows, no breakdowns — isolates the slow-worker / "
    "slow-link tail (every gang iterates at its slowest member) from the "
    "fault-restart dynamics of chaos_steady",
)
def chaos_stragglers(
    seed: int = 0,
    n_jobs: int = 24,
    horizon_s: float = 120.0,
    min_iters: int = 60,
    max_iters: int = 300,
    straggler_prob: float = 0.15,
    straggler_slowdown: float = 2.0,
    nic_mtbf_s: float = 600.0,
    nic_mttr_s: float = 40.0,
    nic_degraded_scale: float = 0.3,
    n_servers: int = 8,
    gpus_per_server: int = 4,
) -> Scenario:
    """Straggler-heavy cell: frequent large compute jitter plus transient
    NIC degradation windows, no breakdowns — isolates the slow-worker /
    slow-link tail (every gang iterates at its slowest member) from the
    fault-restart dynamics of chaos_steady."""
    rng = random.Random(seed)
    jobs = _chaos_mixed_jobs(
        rng, n_jobs, horizon_s, (min_iters, max_iters), 0.5, gpus_per_server
    )
    return Scenario(
        name="chaos_stragglers",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
        chaos=ChaosSpec(
            seed=seed,
            straggler_prob=straggler_prob,
            straggler_slowdown=straggler_slowdown,
            nic_mtbf_s=nic_mtbf_s,
            nic_mttr_s=nic_mttr_s,
            nic_degraded_scale=nic_degraded_scale,
        ),
    )
