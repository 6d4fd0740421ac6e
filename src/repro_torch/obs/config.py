"""Observability configuration (port of ``repro/obs/config.py``; the
chaos ``active`` pattern).

``EventEngine`` keeps its recorder only when ``observe is not None and
observe.active`` — with all four channels off (or no config at all) every
observability hook stays cold and the engine is bit-exact with an
unobserved run, at zero overhead.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What to record during a run.

    Channels (each independently switchable):

    * ``decompose`` — per-job JCT decomposition (queue wait / compute /
      serial comm / contention stretch / gating wait / preemption-fault
      overhead), integrated exactly from the engine's piecewise-rate
      comm windows.  The cheapest channel: O(active comm) per window.
    * ``timelines`` — per-contention-domain time series of the active
      transfer count ``k`` (one sample per domain-load change).
    * ``audit`` — the gating decision log: every AdaDUAL / SRSF(n) /
      k-way accept *and reject* with the evaluated terms
      (``CommPolicy.explain``), domain state, and queue position.
    * ``spans`` — compute / comm / gating-wait span records, the input
      of the Chrome trace-event (Perfetto) exporter.  Unlike
      ``record_trace=True`` this does NOT unfuse f+b, so the event
      stream is unchanged (fused runs show one ``fb`` span).

    The ``*_cap`` bounds keep a 100k-job replay from holding an unbounded
    log; entries past a cap are counted (``ObsReport.*_dropped``), never
    silently discarded.
    """

    decompose: bool = True
    timelines: bool = False
    audit: bool = False
    spans: bool = False
    audit_cap: int = 200_000
    timeline_cap: int = 500_000
    span_cap: int = 500_000

    @property
    def active(self) -> bool:
        return self.decompose or self.timelines or self.audit or self.spans

    @classmethod
    def full(cls, **kw) -> "ObsConfig":
        """Everything on — what a Perfetto export needs."""
        return cls(decompose=True, timelines=True, audit=True, spans=True, **kw)
