"""Engine-facing observability recorder and the report it produces (port
of ``repro/obs/recorder.py``: plain Python floats in the reference's order
of operations, so every record, part and span equals the reference's).

The recorder is pure bookkeeping: it never mutates engine state, so a run
with observability on is bit-exact with the same run observed-off (held
in ``tests/test_torch_obs.py``).

Hot-path design — **record raw, analyze lazily**.  Every high-frequency
hook (piecewise-rate comm windows, transfer start/end/abort, gating
enqueue/dequeue, audit entries, compute spans) is a ``list.extend`` of a
few scalars onto one flat append-only log (see the record-tag table
below); no dict lookups, float math, dataclass construction or policy
``explain`` calls happen while the engine runs.
All processing — the per-job ledgers, the domain timelines, the Perfetto
spans, the :class:`GateDecision` audit — is a deterministic replay of
that log, run the first time a :class:`ObsReport` field is read (i.e.
after ``SimResult`` is returned, outside any timed region), which keeps
the cost of full observability inside the run small.  Memory stays
bounded on huge replays:
when the raw log exceeds a flush threshold it is folded into the replay
state incrementally (amortized O(1) per record).

The JCT decomposition is an *exact wall-clock partition* of each finished
job's lifetime.  Every second between arrival and finish lands in exactly
one bucket:

* ``queue_wait``    — arrival to first placement (the paper's queueing
  delay, unchanged).
* ``gating_wait``   — time the job's comm stream sat in the gating queue
  (barrier reached / WFBP bucket ready, transfer not yet admitted).
  Under WFBP a gated bucket may overlap the remaining backward pass; the
  gating/comm attribution takes priority and ``compute`` is the residual
  (the reference documents it in its ``docs/observability.md``).
* ``comm_serial``   — the part of in-flight comm time the job would have
  paid at the *uncontended* Eq. 5 rate: per piecewise-constant-rate
  window, the latency slice plus ``drain_dt * rate(k)/rate(1)``.
* ``comm_stretch``  — the contention stretch: ``drain_dt * (1 -
  rate(k)/rate(1))``.  Serial + stretch sum to the window's wall time
  exactly, so comm attribution inherits the integrator's exactness.
* ``overhead_pf``   — preemption/fault overhead: requeue time after a
  teardown, checkpoint-restore penalties, and comm time of transfers
  that were aborted mid-flight (reattributed out of serial/stretch —
  that bandwidth was spent but delivered nothing).
* ``compute``       — the residual placed time: forward/backward work,
  intra-iteration GPU time-sharing waits, and WFBP backward overlapped
  with comm.

``compute`` being the residual makes the closure ``sum(parts) == jct``
hold to float addition error (< 1e-6 relative, asserted across the
regression grid); the replay additionally tracks enough state that each
part is individually nonnegative.

The replay reproduces the engine's latency handling bit-for-bit: a
transfer's start record carries its ``latency_left`` (the Eq. 5 ``a``
term), and each window consumes ``min(lat_left, dt)`` of it exactly as
``EventEngine._advance_comm`` does.  ``b`` and ``eta`` are captured at
engine construction — NIC chaos only rewrites ``server_bandwidth``, and
``bandwidth_scale`` cancels out of ``rate(k)/rate(1)`` anyway (degraded
NICs slow the uncontended baseline too, so NIC-fault slowdown lands in
``comm_serial``, not stretch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

#: column order of ``ObsReport.decomposition_csv`` rows
DECOMP_CSV_FIELDS = (
    "job_id",
    "jct",
    "queue_wait",
    "compute",
    "comm_serial",
    "comm_stretch",
    "gating_wait",
    "overhead_pf",
    "stretch_frac",
    "gating_frac",
    "n_preempts",
    "lost_samples",
)

# Raw-log record tags.  The log is ONE FLAT list of scalars (plus interned
# strings and pre-existing frozenset/str refs): each record is a fixed- or
# counted-stride run of elements starting with its tag, appended atomically
# via a single ``list.extend`` per part.  Flat scalars are the point — a
# tuple-per-record design retains one GC-tracked container per record,
# and on contended cells the resulting young-generation scans cost 3x the
# appends themselves.  Scalars (floats/ints/str) carry no GC head, so the
# hot path produces zero collector pressure.  The log is strictly
# chronological (appends happen in event order).
_WINDOW = 0  # 0, dt, n, jid_1..jid_n, k_1..k_n     one piecewise-rate window
_START = 1  # 1, now, jid, bucket, lat_left, domains  transfer admitted
_END = 2  # 2, now, jid                             transfer drained
_ABORT = 3  # 3, now, jid                           transfer died mid-flight
_GATE_IN = 4  # 4, now, jid                         entered the gating queue
_GATE_OUT = 5  # 5, now, jid                        left the gating queue
_PLACED = 6  # 6, now, jid, arrival, restore_inc, model, n_gpus
_PREEMPT = 7  # 7, now, jid, lost_samples
_CANCEL = 8  # 8, now, jid, lost_samples
_RESIZE = 9  # 9, now, jid
_FINISH = 10  # 10, now, jid

# The gating audit gets its OWN flat stream (``ObsRecorder.audit_raw``):
# it is by far the densest hook on contended cells (one record per gate
# evaluation, several per event), its records are self-contained (the
# deferred GateDecision build needs nothing else from the log), and its
# total size is already bounded by ``audit_cap`` — so keeping it out of
# the unified log removes both the record tag and the mid-run flush
# copying entirely.  Untagged stride: now, jid, bucket, new_bytes,
# max_conc, ok, qpos, n_waiting, n_old, old_1..old_n.

#: fold the raw log into the replay state when it grows past this many
#: elements — bounds memory on 100k-job streaming replays without touching
#: the common case (a QUICK-size cell never reaches it)
_FLUSH_AT = 1 << 19


@dataclasses.dataclass(frozen=True)
class JctParts:
    """Exact decomposition of one finished job's completion time."""

    job_id: int
    jct: float
    queue_wait: float
    compute: float
    comm_serial: float
    comm_stretch: float
    gating_wait: float
    overhead_pf: float
    n_preempts: int = 0
    lost_samples: int = 0

    @property
    def parts_sum(self) -> float:
        return (
            self.queue_wait
            + self.compute
            + self.comm_serial
            + self.comm_stretch
            + self.gating_wait
            + self.overhead_pf
        )

    @property
    def stretch_frac(self) -> float:
        return self.comm_stretch / self.jct if self.jct > 0 else 0.0

    @property
    def gating_frac(self) -> float:
        return self.gating_wait / self.jct if self.jct > 0 else 0.0

    def as_csv_row(self) -> str:
        vals = []
        for f in DECOMP_CSV_FIELDS:
            v = getattr(self, f)
            vals.append(f"{v:.6f}" if isinstance(v, float) else str(v))
        return ",".join(vals)


@dataclasses.dataclass(frozen=True)
class GateDecision:
    """One gating evaluation (accept or reject) from the audit log.

    ``terms`` is the policy's :meth:`CommPolicy.explain` output — for
    AdaDUAL the Theorem-2 ratio vs threshold, for SRSF(n) the concurrency
    test, for the k-way lookahead the integrated start-now vs wait costs.
    """

    t: float
    job_id: int
    bucket: int  # -1 = monolithic all-reduce
    new_bytes: float
    min_old_bytes: float  # inf when no in-flight task shares a domain
    n_old: int
    max_concurrent: int
    accepted: bool
    queue_pos: int  # rank in the SRSF evaluation order of this pass
    n_waiting: int
    policy: str
    terms: Optional[Dict[str, float]] = None


class _Ledger:
    """Mutable per-job wall-clock ledger (closed into JctParts at finish)."""

    __slots__ = (
        "arrival",
        "first_placed",
        "requeued_since",
        "requeue_wait",
        "gating_wait",
        "comm_serial",
        "comm_stretch",
        "aborted_comm",
        "restore_total",
        "n_preempts",
        "lost_samples",
    )

    def __init__(self, arrival: float) -> None:
        self.arrival = arrival
        self.first_placed: Optional[float] = None
        self.requeued_since: Optional[float] = None
        self.requeue_wait = 0.0
        self.gating_wait = 0.0
        self.comm_serial = 0.0
        self.comm_stretch = 0.0
        self.aborted_comm = 0.0
        self.restore_total = 0.0
        self.n_preempts = 0
        self.lost_samples = 0


class _Replay:
    """Streaming reducer over the raw log: consumes chronological chunks
    (so the recorder can flush mid-run) and owns all derived state."""

    def __init__(self, config, b: float, eta: float, policy, params) -> None:
        self.decompose_on = bool(config.decompose)
        self.timelines_on = bool(config.timelines)
        self.spans_on = bool(config.spans)
        self._b = b
        self._eta = eta
        self._policy = policy
        self._params = params
        self._timeline_cap = config.timeline_cap
        # decomposition
        self.ledgers: Dict[int, _Ledger] = {}
        self.open_tx: Dict[int, List[float]] = {}  # jid -> [lat_left, serial, stretch]
        self.gate_since: Dict[int, float] = {}
        self.decomp: Dict[int, JctParts] = {}
        # domain timelines — flat at stride 3 (t, domain_key, load):
        # mid-run flushes fold into this, and retaining one tuple per
        # sample would recreate the GC scan pressure the flat log avoids
        self.timeline_flat: List = []
        self.timeline_dropped = 0
        self._domain_load: Dict[object, int] = {}
        self._tx_domains: Dict[int, object] = {}  # jid -> frozenset
        # closed comm/gating spans, flat at stride 6 (jid, track, name,
        # t0, t1, aborted); open ones live in the scalar-valued dicts
        # below until their close record (or the horizon) arrives.
        # Compute spans are appended by the report finalizer from the
        # raw compute stream against the same shared span budget.
        self.spans_flat: List = []
        self.span_dropped = 0
        self._span_budget = config.span_cap
        self._open_comm: Dict[int, Tuple[float, int]] = {}  # jid -> (t0, bucket)
        self._open_gate: Dict[int, float] = {}  # jid -> t0
        self._bucket_names: Dict[int, str] = {}
        # lifecycle instants and Perfetto metadata
        self.job_events: List[Tuple[float, str, int]] = []
        self.job_meta: Dict[int, Tuple[str, int, float]] = {}

    # -- timeline / span helpers ------------------------------------------
    def _domain_step(self, now: float, domains, delta: int) -> None:
        loads = self._domain_load
        tl = self.timeline_flat
        cap = self._timeline_cap * 3
        for d in domains:
            k = loads.get(d, 0) + delta
            if k:
                loads[d] = k
            else:
                loads.pop(d, None)
            if len(tl) >= cap:
                self.timeline_dropped += 1
            else:
                tl.extend((now, d, k))

    def _bucket_name(self, bucket: int) -> str:
        # cache the formatted label so repeat buckets share one str ref
        name = self._bucket_names.get(bucket)
        if name is None:
            name = "allreduce" if bucket < 0 else f"allreduce[b{bucket}]"
            self._bucket_names[bucket] = name
        return name

    def _close_span(
        self, jid: int, track: int, name: str, t0: float, t1: float,
        aborted: bool,
    ) -> None:
        budget = self._span_budget
        if budget <= 0:
            self.span_dropped += 1
            return
        self._span_budget = budget - 1
        self.spans_flat.extend((jid, track, name, t0, t1, aborted))

    # -- the reducer -------------------------------------------------------
    def consume(self, log: List) -> None:
        """Cursor-walk one chronological chunk of the flat record stream.
        Chunks always end on a record boundary (every record is appended
        atomically before any flush check runs)."""
        b, eta = self._b, self._eta
        ledgers = self.ledgers
        open_tx = self.open_tx
        i, n = 0, len(log)
        while i < n:
            tag = log[i]
            if tag == _WINDOW:
                dt = log[i + 1]
                cnt = log[i + 2]
                j0 = i + 3
                k0 = j0 + cnt
                for o in range(cnt):
                    jid = log[j0 + o]
                    tx = open_tx.get(jid)
                    if tx is None:  # transfer predates the recorder: skip
                        continue
                    lat = tx[0]
                    if lat > dt:
                        lat = dt
                    tx[0] -= lat
                    drain = dt - lat
                    if drain > 0.0:
                        k = log[k0 + o]
                        ratio = b / (k * b + (k - 1.0) * eta)
                        stretch = drain * (1.0 - ratio)
                    else:
                        stretch = 0.0
                    tx[1] += dt - stretch
                    tx[2] += stretch
                i = k0 + cnt
            elif tag == _START:
                now, jid, bucket, lat0, domains = log[i + 1 : i + 6]
                i += 6
                if self.decompose_on:
                    open_tx[jid] = [lat0, 0.0, 0.0]
                if self.timelines_on:
                    self._tx_domains[jid] = domains
                    self._domain_step(now, domains, +1)
                if self.spans_on:
                    self._open_comm[jid] = (now, bucket)
            elif tag == _END or tag == _ABORT:
                now, jid = log[i + 1], log[i + 2]
                i += 3
                tx = open_tx.pop(jid, None)
                if tx is not None:
                    led = ledgers.get(jid)
                    if led is not None:
                        if tag == _END:
                            led.comm_serial += tx[1]
                            led.comm_stretch += tx[2]
                        else:
                            # aborted mid-flight: the accrued comm time
                            # delivered nothing — preemption/fault overhead
                            led.aborted_comm += tx[1] + tx[2]
                if self.timelines_on:
                    domains = self._tx_domains.pop(jid, None)
                    if domains is not None:
                        self._domain_step(now, domains, -1)
                oc = self._open_comm.pop(jid, None)
                if oc is not None:
                    self._close_span(
                        jid, -1, self._bucket_name(oc[1]), oc[0], now,
                        tag == _ABORT,
                    )
            elif tag == _GATE_IN:
                now, jid = log[i + 1], log[i + 2]
                i += 3
                self.gate_since[jid] = now
                if self.spans_on:
                    self._open_gate[jid] = now
            elif tag == _GATE_OUT:
                now, jid = log[i + 1], log[i + 2]
                i += 3
                t0 = self.gate_since.pop(jid, None)
                if t0 is not None:
                    led = ledgers.get(jid)
                    if led is not None:
                        led.gating_wait += now - t0
                g0 = self._open_gate.pop(jid, None)
                if g0 is not None:
                    self._close_span(jid, -1, "gated", g0, now, False)
            elif tag == _PLACED:
                now, jid, arrival, restore_inc, model, n_gpus = log[i + 1 : i + 7]
                i += 7
                led = ledgers.get(jid)
                if led is None:
                    led = _Ledger(arrival)
                    ledgers[jid] = led
                if led.first_placed is None:
                    led.first_placed = now
                if led.requeued_since is not None:
                    led.requeue_wait += now - led.requeued_since
                    led.requeued_since = None
                led.restore_total += restore_inc
                if jid not in self.job_meta:
                    self.job_meta[jid] = (model, n_gpus, arrival)
            elif tag == _PREEMPT:
                now, jid, lost = log[i + 1], log[i + 2], log[i + 3]
                i += 4
                led = ledgers.get(jid)
                if led is not None:
                    led.n_preempts += 1
                    led.lost_samples += lost
                    led.requeued_since = now
                self.job_events.append((now, "preempt", jid))
            elif tag == _CANCEL:
                now, jid, lost = log[i + 1], log[i + 2], log[i + 3]
                i += 4
                led = ledgers.pop(jid, None)
                if led is not None:
                    led.lost_samples += lost
                self.gate_since.pop(jid, None)
                open_tx.pop(jid, None)
                self.job_events.append((now, "cancel", jid))
            elif tag == _RESIZE:
                self.job_events.append((log[i + 1], "resize", log[i + 2]))
                i += 3
            elif tag == _FINISH:
                now, jid = log[i + 1], log[i + 2]
                i += 3
                led = ledgers.pop(jid, None)
                if led is None or not self.decompose_on:
                    continue
                jct = now - led.arrival
                queue_wait = (
                    (led.first_placed - led.arrival)
                    if led.first_placed is not None
                    else 0.0
                )
                placed_resid = (
                    jct
                    - queue_wait
                    - led.requeue_wait
                    - led.gating_wait
                    - led.comm_serial
                    - led.comm_stretch
                    - led.aborted_comm
                )
                # The restore penalty is paid per worker in parallel, so
                # its wall-clock extension is ~one restore_cost per
                # re-placement; clamp to the available residual so compute
                # stays nonnegative under extreme GPU time-sharing.
                restore = min(led.restore_total, max(0.0, placed_resid))
                self.decomp[jid] = JctParts(
                    job_id=jid,
                    jct=jct,
                    queue_wait=queue_wait,
                    compute=placed_resid - restore,
                    comm_serial=led.comm_serial,
                    comm_stretch=led.comm_stretch,
                    gating_wait=led.gating_wait,
                    overhead_pf=led.requeue_wait + led.aborted_comm + restore,
                    n_preempts=led.n_preempts,
                    lost_samples=led.lost_samples,
                )
            else:  # pragma: no cover - corrupted stream
                raise ValueError(f"bad obs record tag {tag!r} at {i}")


def _build_audit(raw: List, policy, params) -> List[GateDecision]:
    """Build the :class:`GateDecision` list (dataclass + ``explain`` terms
    per decision) from the raw audit stream — called once by
    ``ObsReport._materialize``, never inside ``run()``."""
    audit: List[GateDecision] = []
    i, n = 0, len(raw)
    while i < n:
        (now, jid, bucket, new_bytes, max_conc, ok, qpos, n_waiting,
         n_old) = raw[i : i + 9]
        old_rem = raw[i + 9 : i + 9 + n_old]
        i += 9 + n_old
        audit.append(
            GateDecision(
                t=now,
                job_id=jid,
                bucket=bucket,
                new_bytes=new_bytes,
                min_old_bytes=min(old_rem) if old_rem else math.inf,
                n_old=n_old,
                max_concurrent=max_conc,
                accepted=ok,
                queue_pos=qpos,
                n_waiting=n_waiting,
                policy=policy.name,
                terms=policy.explain(new_bytes, old_rem, max_conc, params),
            )
        )
    return audit


class ObsRecorder:
    """The engine's observability sink (armed via ``observe=ObsConfig``).

    The highest-frequency streams are not even method calls: the engine
    caches direct references to :attr:`log` / :attr:`raw_compute` (plus
    the per-family channel gates) at construction and extends flat
    scalar records inline — see ``EventEngine.__init__``.  :meth:`_flush`
    folds the log into the replay state *in place* (``del log[:]``) so
    those cached references never go stale.  Lower-frequency hooks (transfer
    starts, audit entries, job lifecycle, faults) stay methods.  The
    engine calls :meth:`bind` right after construction so the replay
    knows the Eq. 5 constants and the gating policy.
    """

    def __init__(self, config) -> None:
        self.config = config
        self.decompose_on = bool(config.decompose)
        self.timelines_on = bool(config.timelines)
        self.audit_on = bool(config.audit)
        self.spans_on = bool(config.spans)
        #: which record families the unified log needs
        self.log_comm = self.decompose_on or self.timelines_on or self.spans_on
        self.log_gate = self.decompose_on or self.spans_on
        self.flush_at = _FLUSH_AT
        #: the unified flat record stream (scalars only — see the tag
        #: table above; no retained containers = no GC scan pressure)
        self.log: List = []
        #: raw compute spans, flat at stride 6: jid, worker, kind, seg,
        #: t0, t1 — extended inline by the engine (cap-checked there
        #: against ``span_cap * 6`` elements)
        self.raw_compute: List = []
        self.span_dropped = 0
        #: raw gating-audit stream (dedicated; see the stride note above) —
        #: extended inline by the engine, which also owns the budget
        #: countdown against ``audit_cap``
        self.audit_raw: List = []
        self.audit_dropped = 0
        #: fault timeline: (t, kind, server) — rare, recorded eagerly
        self.fault_events: List[Tuple[float, str, int]] = []
        #: eager conservation counter (checked against
        #: ``SimResult.work_lost_samples``; same additions, so equality
        #: is exact)
        self.work_lost_total = 0
        self._replay: Optional[_Replay] = None
        self._b = 0.0
        self._eta = 0.0
        self._policy = None
        self._params = None

    def bind(self, params, policy) -> None:
        """Capture the Eq. 5 constants and the gating policy for the
        deferred replay.  ``b``/``eta`` never change mid-run (NIC chaos
        only rewrites ``server_bandwidth``)."""
        self._b = params.b
        self._eta = params.eta
        self._params = params
        self._policy = policy

    def _flush(self) -> None:
        """Fold the raw log into the replay state and clear it IN PLACE —
        the engine holds direct references to the list."""
        if self._replay is None:
            self._replay = _Replay(
                self.config, self._b, self._eta, self._policy, self._params
            )
        self._replay.consume(self.log)
        del self.log[:]

    # -- warm hooks (low frequency; the hot streams are engine-inlined) ----
    def comm_start(self, jid: int, bucket: int, now: float, task) -> None:
        if self.log_comm:
            log = self.log
            log.extend(
                (_START, now, jid, bucket, task.latency_left, task.domains)
            )
            if len(log) >= self.flush_at:
                self._flush()

    def comm_abort(self, jid: int, now: float) -> None:
        if self.log_comm:
            self.log.extend((_ABORT, now, jid))

    # -- job lifecycle (rare) ----------------------------------------------
    def placed(self, jid: int, run, now: float) -> None:
        spec = run.spec
        restore_inc = (
            run.restore_cost
            if (run.restore_cost > 0.0 and run.restore_need)
            else 0.0
        )
        self.log.extend(
            (
                _PLACED,
                now,
                jid,
                spec.arrival,
                restore_inc,
                getattr(spec.model, "name", "model"),
                spec.n_gpus,
            )
        )

    def preempted(self, jid: int, now: float, lost_samples: int) -> None:
        self.work_lost_total += lost_samples
        self.log.extend((_PREEMPT, now, jid, lost_samples))

    def cancelled(self, jid: int, now: float, lost_samples: int) -> None:
        self.work_lost_total += lost_samples
        self.log.extend((_CANCEL, now, jid, lost_samples))

    def resized(self, jid: int, now: float) -> None:
        self.log.extend((_RESIZE, now, jid))

    def finished(self, jid: int, run, now: float) -> None:
        self.log.extend((_FINISH, now, jid))

    def fault(self, kind: str, server: int, now: float) -> None:
        self.fault_events.append((now, kind, server))

    # -- report ------------------------------------------------------------
    def build_report(
        self, topology, params, makespan: float, horizon: float
    ) -> "ObsReport":
        """Hand the raw streams to a lazy :class:`ObsReport`.  No replay
        happens here — ``run()`` wall time stays free of analysis cost."""
        if self._replay is None:
            self._replay = _Replay(
                self.config, self._b, self._eta, self._policy, self._params
            )
        return ObsReport(
            config=self.config,
            _replay=self._replay,
            _log=self.log,
            _raw_compute=self.raw_compute,
            _audit_raw=self.audit_raw,
            _topology=topology,
            _horizon=horizon,
            work_lost_total=self.work_lost_total,
            fault_events=self.fault_events,
            makespan=makespan,
            _audit_dropped0=self.audit_dropped,
            _span_dropped0=self.span_dropped,
        )


class ObsReport:
    """What ``SimResult.obs`` carries when observability was on.

    All derived views (``decomp``, ``timeline``, ``audit``, ``spans``,
    ...) are materialized from the raw record streams on first access —
    constructing the report is free, so the simulation's wall-clock
    (``SimResult``-timed runs) excludes analysis cost.
    """

    def __init__(
        self,
        config,
        _replay: _Replay,
        _log: List,
        _raw_compute: List,
        _audit_raw: List,
        _topology,
        _horizon: float,
        work_lost_total: int,
        fault_events: List[Tuple[float, str, int]],
        makespan: float,
        _audit_dropped0: int = 0,
        _span_dropped0: int = 0,
    ) -> None:
        self.config = config
        #: samples of in-progress work lost to teardowns — conservation-
        #: checked against ``SimResult.work_lost_samples``
        self.work_lost_total = work_lost_total
        self.fault_events = fault_events
        self.makespan = makespan
        self._replay = _replay
        self._log = _log
        self._raw_compute = _raw_compute
        self._audit_raw = _audit_raw
        self._topology = _topology
        self._horizon = _horizon
        self._audit_dropped0 = _audit_dropped0
        self._span_dropped0 = _span_dropped0
        self._done = False

    def _materialize(self) -> None:
        if self._done:
            return
        self._done = True
        rp = self._replay
        rp.consume(self._log)
        self._log = []
        self.audit = _build_audit(self._audit_raw, rp._policy, rp._params)
        self._audit_raw = []
        horizon = self._horizon
        if rp.spans_on:
            # close comm/gating spans left open at the horizon
            for jid, (t0, bucket) in sorted(rp._open_comm.items()):
                rp._close_span(
                    jid, -1, rp._bucket_name(bucket), t0, horizon, False
                )
            rp._open_comm.clear()
            for jid, t0 in sorted(rp._open_gate.items()):
                rp._close_span(jid, -1, "gated", t0, horizon, False)
            rp._open_gate.clear()
            # compute spans from the raw stream, teardowns clipping any
            # span still open (or scheduled past) the teardown instant —
            # the engine records gpu_done spans optimistically at
            # schedule time
            tears: Dict[int, List[float]] = {}
            for t, kind, jid in rp.job_events:
                tears.setdefault(jid, []).append(t)
            rc = self._raw_compute
            sf = rp.spans_flat
            for i in range(0, len(rc), 6):
                if rp._span_budget <= 0:
                    rp.span_dropped += (len(rc) - i) // 6
                    break
                rp._span_budget -= 1
                jid, worker, kind, seg, t0, t1 = rc[i : i + 6]
                name = kind if seg < 0 else f"{kind}{seg}"
                aborted = False
                ts = tears.get(jid)
                if ts is not None:
                    for tt in ts:
                        if t0 <= tt < t1:
                            t1 = tt
                            aborted = True
                            break
                sf.extend((jid, worker, name, t0, t1, aborted))
            self.spans = [
                tuple(sf[i : i + 6]) for i in range(0, len(sf), 6)
            ]
            rp.spans_flat = []
        else:
            self.spans = []
        self._raw_compute = []
        self.decomp = rp.decomp
        tf = rp.timeline_flat
        self.timeline = [
            (tf[i], tf[i + 1], tf[i + 2]) for i in range(0, len(tf), 3)
        ]
        rp.timeline_flat = []
        self.timeline_dropped = rp.timeline_dropped
        self.audit_dropped = self._audit_dropped0
        self.span_dropped = self._span_dropped0 + rp.span_dropped
        self.job_events = rp.job_events
        self.job_meta = rp.job_meta
        names: Dict[object, str] = {}
        topology = self._topology
        for (_, d, _) in self.timeline:
            if d in names:
                continue
            if isinstance(d, int) and 0 <= d < len(topology.domains):
                names[d] = topology.domains[d].name
            else:
                names[d] = str(d)
        self.domain_names = names

    def __getattr__(self, name: str):
        # lazy fields: first access triggers the replay
        if name in (
            "decomp",
            "timeline",
            "timeline_dropped",
            "audit",
            "audit_dropped",
            "spans",
            "span_dropped",
            "job_events",
            "job_meta",
            "domain_names",
        ):
            self._materialize()
            return self.__dict__[name]
        raise AttributeError(name)

    # -- aggregates (the new metrics CSV columns) --------------------------
    def mean_stretch_frac(self) -> float:
        if not self.decomp:
            return math.nan
        return sum(p.stretch_frac for p in self.decomp.values()) / len(self.decomp)

    def mean_gating_frac(self) -> float:
        if not self.decomp:
            return math.nan
        return sum(p.gating_frac for p in self.decomp.values()) / len(self.decomp)

    def mean_parts(self) -> Dict[str, float]:
        """Mean seconds per decomposition bucket over finished jobs."""
        n = max(1, len(self.decomp))
        out = {f: 0.0 for f in DECOMP_CSV_FIELDS[1:8]}
        for p in self.decomp.values():
            for f in out:
                out[f] += getattr(p, f)
        return {f: v / n for f, v in out.items()}

    # -- per-domain utilization from the k timeline ------------------------
    def domain_utilization(self) -> Dict[object, Dict[str, float]]:
        """Per-domain ``busy_frac`` (fraction of the makespan with k >= 1),
        ``mean_k`` (time-averaged active transfers) and ``peak_k`` from the
        step timeline."""
        horizon = self.makespan if self.makespan > 0 else 0.0
        series: Dict[object, List[Tuple[float, int]]] = {}
        for t, d, k in self.timeline:
            series.setdefault(d, []).append((t, k))
        out: Dict[object, Dict[str, float]] = {}
        for d, steps in series.items():
            busy = 0.0
            k_time = 0.0
            peak = 0
            last_t, last_k = 0.0, 0
            for t, k in steps:
                dt = t - last_t
                if dt > 0:
                    if last_k > 0:
                        busy += dt
                    k_time += last_k * dt
                last_t, last_k = t, k
                peak = max(peak, k)
            if horizon > last_t and last_k > 0:
                busy += horizon - last_t
                k_time += last_k * (horizon - last_t)
            out[d] = {
                "busy_frac": busy / horizon if horizon > 0 else 0.0,
                "mean_k": k_time / horizon if horizon > 0 else 0.0,
                "peak_k": float(peak),
            }
        return out

    # -- artifacts ---------------------------------------------------------
    def decomposition_csv(self) -> str:
        rows = [",".join(DECOMP_CSV_FIELDS)]
        for jid in sorted(self.decomp):
            rows.append(self.decomp[jid].as_csv_row())
        return "\n".join(rows) + "\n"

    def to_chrome_trace(self, path: Optional[str] = None):
        """Chrome trace-event (Perfetto-compatible) export; see
        ``repro_torch.obs.perfetto``.  Returns the trace dict; writes JSON to
        ``path`` when given."""
        from repro_torch.obs.perfetto import chrome_trace_dict, write_chrome_trace

        if path is not None:
            return write_chrome_trace(self, path)
        return chrome_trace_dict(self)
