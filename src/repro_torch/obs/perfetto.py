"""Chrome trace-event (Perfetto-compatible) exporter (port of
``repro/obs/perfetto.py``).

Maps one run's :class:`~repro_torch.obs.recorder.ObsReport` onto the Chrome
trace-event JSON format that ``ui.perfetto.dev`` (and ``chrome://tracing``)
load directly:

* each **job** becomes a *process* (pid = job_id + 1) named after its
  model and gang size;
* each job's **workers** become threads (tid = worker + 1, named
  ``gpu w<k>``) carrying the forward/backward (or fused ``fb``) duration
  spans, and tid 0 is the job's **comm stream** carrying ``gated`` waits
  and ``allreduce`` transfer spans (WFBP buckets are ``allreduce[bK]``);
* the **contention domains** become one counter track per fabric cut
  (process 0) plotting the active-transfer count ``k`` over time — the
  Eq. 5 contention input;
* preemptions / resizes / cancellations are instant events on the job's
  track; server breakdown / repair / NIC windows are global instants.

Timestamps are microseconds (the format's unit); simulated seconds map
1:1 onto trace seconds.
"""

from __future__ import annotations

import json
from typing import Dict, List

#: pid of the pseudo-process that carries the per-domain counter tracks
DOMAIN_PID = 0

_CAT = {"f": "compute", "b": "compute", "fb": "compute"}


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def _span_cat(name: str) -> str:
    if name == "gated":
        return "gating"
    if name.startswith("allreduce"):
        return "comm"
    return _CAT.get(name[0], "compute")


def chrome_trace_events(report) -> List[dict]:
    """The flat ``traceEvents`` list for one report."""
    ev: List[dict] = []
    pids_seen: Dict[int, bool] = {}

    def ensure_process(jid: int) -> int:
        pid = jid + 1
        if jid not in pids_seen:
            pids_seen[jid] = True
            name, n_gpus, arrival = report.job_meta.get(
                jid, ("job", 0, 0.0)
            )
            label = f"job {jid} ({name} x{n_gpus})" if n_gpus else f"job {jid}"
            ev.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": label},
                }
            )
            ev.append(
                {
                    "ph": "M",
                    "name": "process_sort_index",
                    "pid": pid,
                    "tid": 0,
                    "args": {"sort_index": jid},
                }
            )
            ev.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": "comm stream"},
                }
            )
        return pid

    tids_named: Dict[tuple, bool] = {}
    for jid, track, name, t0, t1, aborted in report.spans:
        pid = ensure_process(jid)
        tid = 0 if track < 0 else track + 1
        if track >= 0 and (jid, tid) not in tids_named:
            tids_named[(jid, tid)] = True
            ev.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": f"gpu w{track}"},
                }
            )
        args = {}
        if aborted:
            args["aborted"] = True
        ev.append(
            {
                "ph": "X",
                "name": name,
                "cat": _span_cat(name),
                "pid": pid,
                "tid": tid,
                "ts": _us(t0),
                "dur": max(0.0, _us(t1) - _us(t0)),
                **({"args": args} if args else {}),
            }
        )

    for t, kind, jid in report.job_events:
        pid = ensure_process(jid)
        ev.append(
            {
                "ph": "i",
                "s": "p",
                "name": kind,
                "cat": "lifecycle",
                "pid": pid,
                "tid": 0,
                "ts": _us(t),
            }
        )

    if report.timeline:
        ev.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": DOMAIN_PID,
                "tid": 0,
                "args": {"name": "contention domains (active comm k)"},
            }
        )
        for t, d, k in report.timeline:
            ev.append(
                {
                    "ph": "C",
                    "name": f"k @ {report.domain_names.get(d, str(d))}",
                    "cat": "contention",
                    "pid": DOMAIN_PID,
                    "tid": 0,
                    "ts": _us(t),
                    "args": {"k": k},
                }
            )

    for t, kind, server in report.fault_events:
        ev.append(
            {
                "ph": "i",
                "s": "g",
                "name": f"{kind} s{server}",
                "cat": "fault",
                "pid": DOMAIN_PID,
                "tid": 0,
                "ts": _us(t),
            }
        )
    return ev


def chrome_trace_dict(report) -> dict:
    return {
        "traceEvents": chrome_trace_events(report),
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro_torch.obs.perfetto",
            "makespan_s": report.makespan,
            "n_jobs_decomposed": len(report.decomp),
            "span_dropped": report.span_dropped,
            "timeline_dropped": report.timeline_dropped,
        },
    }


def write_chrome_trace(report, path: str) -> dict:
    """Serialize the report to a Perfetto-loadable JSON file at ``path``."""
    trace = chrome_trace_dict(report)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace
