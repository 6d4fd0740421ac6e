"""Contention observability layer of the port (port of ``repro/obs``;
zero overhead when off).

The paper's whole argument is about *where time goes* — contention
stretches communication (Eq. 5), and AdaDUAL trades a bounded amount of
accepted contention against waiting (Theorems 1-2) — yet aggregates like
avg/p99 JCT cannot say *which* mechanism produced a result.  This package
is the attribution layer:

* :class:`ObsConfig` / :class:`ObsRecorder` — the engine-facing recorder,
  armed via ``simulate(observe=ObsConfig(...))``.  Follows the chaos
  ``active`` pattern: an absent or inactive config keeps every hook cold,
  so the event stream is bit-exact with an unobserved run (held in
  ``tests/test_torch_obs.py``).
* :class:`JctParts` — exact per-job JCT decomposition: queue wait,
  compute, serial comm at the uncontended Eq. 5 rate, contention stretch
  (integrated from the engine's piecewise-constant-rate windows), gating
  wait, and preemption/fault overhead.  The parts sum to the JCT by
  construction.
* :class:`ObsReport` — what ``SimResult.obs`` carries: the decomposition
  table, per-domain timelines (active-comm count ``k`` per fabric cut),
  the gating-decision audit log, span records, and the Chrome
  trace-event exporter (``repro_torch.obs.perfetto``) that opens any run in
  ``ui.perfetto.dev``.
* ``repro_torch.obs.report`` — analysis helpers (imported explicitly; it pulls
  in the scenario registry) that print the decomposition tables used to
  explain the recovery-storm inversion and the fine-fusion finding.
"""

from repro_torch.obs.config import ObsConfig
from repro_torch.obs.perfetto import chrome_trace_events, write_chrome_trace
from repro_torch.obs.recorder import (
    DECOMP_CSV_FIELDS,
    GateDecision,
    JctParts,
    ObsRecorder,
    ObsReport,
)

__all__ = [
    "ObsConfig",
    "ObsRecorder",
    "ObsReport",
    "JctParts",
    "GateDecision",
    "DECOMP_CSV_FIELDS",
    "chrome_trace_events",
    "write_chrome_trace",
]
