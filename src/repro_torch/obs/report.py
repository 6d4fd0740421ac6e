"""Decomposition-driven analysis of two findings of the scheduler (port of
``repro/obs/report.py``).

Aggregates like avg JCT can *detect* that one gating policy beats another
on a cell; the JCT decomposition (``repro_torch.obs.recorder``) says *why* — it
splits every job's completion time into queue wait, compute, serial comm,
contention stretch, gating wait and preemption/fault overhead, so two
policies on the same workload differ only in the buckets their mechanisms
touch.  This module runs the observed A/B and prints the side-by-side
mean-parts table plus a one-line verdict naming the dominant component.

Two findings ship with explainers (the reference records their tables in
its ``docs/observability.md``):

* :func:`explain_recovery_storm` — the seed-2 inversion: the recovery
  storm flips Ada-SRSF from winning to losing against ungated SRSF(2).
* :func:`explain_fusion_sweep` — the fine-fusion regime shift: fine-grained
  WFBP bucketing erases AdaDUAL's edge over exclusive-link SRSF(1).

Run both from the CLI (event engine, on the host)::

    PYTHONPATH=src python -m repro_torch.obs.report

This module imports the scenario registry, so it is intentionally NOT
re-exported from ``repro_torch.obs`` (the engine imports
``repro_torch.obs.recorder``; pulling scenarios in at that level would be
an import cycle).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs.config import ObsConfig

#: mean-parts table rows, in print order
_PART_KEYS = (
    "jct",
    "queue_wait",
    "compute",
    "comm_serial",
    "comm_stretch",
    "gating_wait",
    "overhead_pf",
)


def observed_run(scenario, comm: str, **sim_kw):
    """One event-backend run of ``scenario`` with the JCT decomposition
    armed; returns the :class:`~repro_torch.obs.recorder.ObsReport`."""
    from repro_torch.scenarios import run_scenario_event

    sim_kw.setdefault("observe", ObsConfig(decompose=True))
    return run_scenario_event(scenario, comm=comm, **sim_kw).obs


def mean_parts_table(
    columns: Dict[str, Dict[str, float]], title: str = ""
) -> str:
    """Markdown table of mean decomposition seconds, one column per run
    label (each value dict comes from ``ObsReport.mean_parts()``)."""
    labels = list(columns)
    lines = []
    if title:
        lines.append(title)
    lines.append("| component | " + " | ".join(labels) + " |")
    lines.append("|---|" + "---|" * len(labels))
    for key in _PART_KEYS:
        row = [f"{columns[lb].get(key, float('nan')):10.2f}" for lb in labels]
        lines.append(f"| {key} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def dominant_component(
    parts_a: Dict[str, float], parts_b: Dict[str, float]
) -> Tuple[str, float]:
    """The decomposition bucket with the largest absolute mean-seconds gap
    between two runs (JCT itself excluded) and that gap (A minus B)."""
    best, gap = "", 0.0
    for key in _PART_KEYS[1:]:
        d = parts_a.get(key, 0.0) - parts_b.get(key, 0.0)
        if abs(d) > abs(gap):
            best, gap = key, d
    return best, gap


def compare_comms(
    scenario,
    comms: Sequence[str] = ("ada", "srsf2"),
    **sim_kw,
) -> Dict[str, Dict[str, float]]:
    """Mean decomposition parts of ``scenario`` under each gating policy."""
    return {
        comm: observed_run(scenario, comm, **sim_kw).mean_parts()
        for comm in comms
    }


def explain_recovery_storm(seed: int = 2, out=print) -> Dict[str, object]:
    """Decompose the recovery-storm finding on one seed.

    Runs ``chaos_recovery_storm`` under Ada-SRSF and SRSF(2), with the
    storm and fault-free (``chaos=None``), and names the component whose
    swing produces the avg-JCT ordering.  Seed 2 is the locked inversion
    (gating loses under the storm); seed 11 the locked amplification.
    """
    import dataclasses

    from repro_torch.scenarios import get_scenario

    storm = get_scenario("chaos_recovery_storm", seed=seed)
    clean = dataclasses.replace(storm, chaos=None)
    cols = {
        "ada (storm)": observed_run(storm, "ada").mean_parts(),
        "srsf2 (storm)": observed_run(storm, "srsf2").mean_parts(),
        "ada (clean)": observed_run(clean, "ada").mean_parts(),
        "srsf2 (clean)": observed_run(clean, "srsf2").mean_parts(),
    }
    out(
        mean_parts_table(
            cols,
            title=(
                f"chaos_recovery_storm seed={seed}: mean JCT decomposition "
                "(seconds/job)"
            ),
        )
    )
    comp, gap = dominant_component(cols["ada (storm)"], cols["srsf2 (storm)"])
    ratio = cols["ada (storm)"]["jct"] / cols["srsf2 (storm)"]["jct"]
    ratio_clean = cols["ada (clean)"]["jct"] / cols["srsf2 (clean)"]["jct"]
    out(
        f"\nada/srsf2 avg-JCT ratio: storm {ratio:.3f}, fault-free "
        f"{ratio_clean:.3f}."
    )
    out(
        f"Dominant component under the storm: {comp} "
        f"({gap:+.2f} s/job, ada minus srsf2)."
    )
    return {"columns": cols, "dominant": comp, "gap_s": gap, "ratio": ratio}


def explain_fusion_sweep(seed: int = 1, out=print) -> Dict[str, object]:
    """Decompose the fine-fusion finding.

    On ``fusion_sweep`` compares Ada-SRSF against exclusive-link SRSF(1)
    at the cell's finite fusion threshold and fully-unfused
    (``fusion='none'``), showing which bucket absorbs AdaDUAL's edge when
    transfers become fine-grained.
    """
    import dataclasses

    from repro_torch.scenarios import QUICK_OVERRIDES, get_scenario

    base = get_scenario(
        "fusion_sweep", seed=seed, **QUICK_OVERRIDES["fusion_sweep"]
    )
    none = dataclasses.replace(base, fusion="none")
    cols = {
        "ada (fused)": observed_run(base, "ada").mean_parts(),
        "srsf1 (fused)": observed_run(base, "srsf1").mean_parts(),
        "ada (unfused)": observed_run(none, "ada").mean_parts(),
        "srsf1 (unfused)": observed_run(none, "srsf1").mean_parts(),
    }
    out(
        mean_parts_table(
            cols,
            title=(
                f"fusion_sweep seed={seed}: mean JCT decomposition "
                "(seconds/job)"
            ),
        )
    )
    comp, gap = dominant_component(cols["ada (fused)"], cols["srsf1 (fused)"])
    ratio = cols["ada (fused)"]["jct"] / cols["srsf1 (fused)"]["jct"]
    out(f"\nada/srsf1 avg-JCT ratio at the finite threshold: {ratio:.3f}.")
    out(
        f"Dominant component at the finite threshold: {comp} "
        f"({gap:+.2f} s/job, ada minus srsf1)."
    )
    return {"columns": cols, "dominant": comp, "gap_s": gap, "ratio": ratio}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--finding",
        choices=("recovery_storm", "fusion_sweep", "all"),
        default="all",
    )
    ap.add_argument("--seed", type=int, default=None)
    ns = ap.parse_args(argv)
    if ns.finding in ("recovery_storm", "all"):
        explain_recovery_storm(seed=2 if ns.seed is None else ns.seed)
        print()
    if ns.finding in ("fusion_sweep", "all"):
        explain_fusion_sweep(seed=1 if ns.seed is None else ns.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
