"""DAG representation of DDL training jobs (port of ``repro/core/dag.py``;
paper Section III, Fig. 3), extended to layer granularity for the WFBP
communication subsystem.

A job running ``I_k`` iterations on ``n`` workers is the chain of ``I_k``
child DAGs; child DAG ``i`` contains, per worker ``w``:

    f(i, w)  ->  b(i, w)  ->  c(i)          (c only if the job spans servers)

with ``c(i)`` a synchronization barrier over all workers' ``b(i, w)`` and
``c(i) -> f(i+1, w)`` for every worker.  A virtual global entry precedes all
jobs' first forwards and a virtual global exit follows all last all-reduces
(Fig. 3(b)).

**Layer-granular extension** (``n_buckets > 1``): wait-free backpropagation
with tensor fusion splits the backward pass into per-bucket segments and
the all-reduce into per-bucket transfers:

    f(i, w) -> b(i, w, 0) -> b(i, w, 1) -> ... -> b(i, w, B-1)
    c(i, l) <- { b(i, w, l) for every w }  ∪  { c(i, l-1) }
    f(i+1, w) <- c(i, B-1)

``c(i, l)`` is a barrier over all workers' segment-``l`` backwards plus the
previous bucket's transfer (the comm stream serializes buckets FIFO, the
PyTorch-DDP model), and **only the last bucket's transfer blocks the next
iteration's forward** — earlier transfers overlap the remaining backward
segments.  ``n_buckets=1`` degenerates task-for-task to the monolithic
Fig. 3 DAG above (segments carry index -1, the legacy naming).

The event-driven simulator does not literally walk this graph (it exploits
the chain structure for speed); this module provides the *formal* object so
tests can assert that any simulated execution trace — fused or WFBP — is a
valid linear extension of the DAG, i.e. the fast simulator and the formal
model agree.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterator, List, Sequence, Tuple


class TaskKind(enum.Enum):
    FORWARD = "f"
    BACKWARD = "b"
    ALLREDUCE = "c"


@dataclasses.dataclass(frozen=True)
class TaskRef:
    """tau^k_{l,m}: task of job ``job_id``, iteration ``iteration``; compute
    tasks carry the worker index, the all-reduce carries worker=-1.

    ``segment`` indexes the WFBP bucket (backward segment / per-bucket
    transfer) in the layer-granular DAG; -1 is the monolithic reading
    (``n_buckets == 1``), keeping legacy task identities unchanged."""

    job_id: int
    iteration: int
    kind: TaskKind
    worker: int = -1
    segment: int = -1

    def __str__(self) -> str:
        w = "" if self.worker < 0 else f"w{self.worker}"
        s = "" if self.segment < 0 else f"s{self.segment}"
        return f"J{self.job_id}.i{self.iteration}.{self.kind.value}{w}{s}"


@dataclasses.dataclass(frozen=True)
class JobDag:
    job_id: int
    n_workers: int
    iterations: int
    has_comm: bool
    #: WFBP bucket count: 1 = the monolithic Fig. 3 DAG (segment index -1
    #: everywhere, preserving legacy task identities); B > 1 = the
    #: layer-granular extension with B backward segments and B per-bucket
    #: transfers per iteration (requires has_comm).
    n_buckets: int = 1

    def __post_init__(self) -> None:
        if self.n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {self.n_buckets}")
        if self.n_buckets > 1 and not self.has_comm:
            raise ValueError("layer-granular DAG (n_buckets > 1) needs comm")

    def _seg(self, l: int) -> int:
        """Segment index as stored on tasks: -1 in the monolithic DAG."""
        return -1 if self.n_buckets == 1 else l

    def tasks(self) -> Iterator[TaskRef]:
        for i in range(self.iterations):
            for w in range(self.n_workers):
                yield TaskRef(self.job_id, i, TaskKind.FORWARD, w)
                for l in range(self.n_buckets):
                    yield TaskRef(self.job_id, i, TaskKind.BACKWARD, w, self._seg(l))
            if self.has_comm:
                for l in range(self.n_buckets):
                    yield TaskRef(self.job_id, i, TaskKind.ALLREDUCE, -1, self._seg(l))

    def predecessors(self, task: TaskRef) -> List[TaskRef]:
        """Direct predecessors of ``task`` within this job's DAG."""
        i, w, s = task.iteration, task.worker, task.segment
        last = self._seg(self.n_buckets - 1)
        if task.kind is TaskKind.FORWARD:
            if i == 0:
                return []
            if self.has_comm:
                # only the LAST bucket's transfer blocks the next forward —
                # earlier buckets overlap the remaining backward segments.
                return [TaskRef(self.job_id, i - 1, TaskKind.ALLREDUCE, -1, last)]
            # without a comm task, the barrier degenerates to: next forward
            # of worker w follows its own backward (workers run free).
            return [TaskRef(self.job_id, i - 1, TaskKind.BACKWARD, w, last)]
        if task.kind is TaskKind.BACKWARD:
            if self.n_buckets > 1 and s > 0:
                return [TaskRef(self.job_id, i, TaskKind.BACKWARD, w, s - 1)]
            return [TaskRef(self.job_id, i, TaskKind.FORWARD, w)]
        # ALLREDUCE(i, l): barrier over all workers' segment-l backwards,
        # plus the previous bucket's transfer (FIFO comm stream).
        preds = [
            TaskRef(self.job_id, i, TaskKind.BACKWARD, ww, s)
            for ww in range(self.n_workers)
        ]
        if self.n_buckets > 1 and s > 0:
            preds.append(TaskRef(self.job_id, i, TaskKind.ALLREDUCE, -1, s - 1))
        return preds

    def n_tasks(self) -> int:
        per_iter = self.n_workers * (1 + self.n_buckets) + (
            self.n_buckets if self.has_comm else 0
        )
        return per_iter * self.iterations


def build_job_dag(
    job_id: int,
    n_workers: int,
    iterations: int,
    spans_servers: bool,
    n_buckets: int = 1,
) -> JobDag:
    return JobDag(job_id, n_workers, iterations, has_comm=spans_servers,
                  n_buckets=n_buckets)


def validate_schedule(
    dag: JobDag, intervals: Dict[TaskRef, Tuple[float, float]], eps: float = 1e-9
) -> Tuple[bool, str]:
    """Check a simulated schedule against the formal DAG: every task of the
    DAG must appear exactly once with ``start <= end``, and each task may
    start only after *all* its predecessors have ended (precedence edges of
    Fig. 3, including the all-reduce barrier).

    Used by the property tests to certify that the fast chain-structured
    simulator executes a valid schedule of the formal DAG.
    """
    expected = set(dag.tasks())
    got = set(intervals)
    if got != expected:
        missing = expected - got
        extra = got - expected
        return False, (
            f"task set mismatch: missing={[str(t) for t in list(missing)[:3]]} "
            f"extra={[str(t) for t in list(extra)[:3]]}"
        )
    for t, (start, end) in intervals.items():
        if end < start - eps:
            return False, f"task {t} ends before it starts"
        for p in dag.predecessors(t):
            if intervals[p][1] > start + eps:
                return False, f"edge violated: {p} (end {intervals[p][1]}) !<= {t} (start {start})"
    return True, "ok"
