"""The port's formal job DAG (``repro_torch.core.dag``, the paper's Fig. 3
with the WFBP bucket extension) and the event engine's recorded task
trace, against the JAX package's, on the CPU.

* Ports of ``tests/test_dag.py`` (structure and ``validate_schedule``),
  plus the layer-granular DAG at several bucket counts against the
  reference's, task for task and edge for edge.
* ``record_trace=True`` records ``==`` the reference's on the paper QUICK
  run, a ``model_zoo`` WFBP run, a preempted run (``preemption_gain``
  under ``preemptive_srsf``), a resized run (``elastic_surge`` under
  ``elastic``) and a broken-down run (``chaos_recovery_storm``); and each
  job's records, split at its preempt/resize markers, are a valid linear
  extension of the job DAG of each incarnation under ``validate_schedule``
  (iterations covered once, buckets from the records).
"""

import pytest

import repro.scenarios as R
import repro_torch.scenarios as P
from repro.core import dag as rdag
from repro_torch.core.dag import JobDag, TaskKind, TaskRef, build_job_dag, validate_schedule

from test_torch_engine import assert_same_result


class TestStructure:
    def test_task_count(self):
        dag = build_job_dag(0, n_workers=4, iterations=3, spans_servers=True)
        assert dag.n_tasks() == 3 * (2 * 4 + 1)
        dag2 = build_job_dag(0, n_workers=2, iterations=5, spans_servers=False)
        assert dag2.n_tasks() == 5 * 4

    def test_forward_has_no_predecessor_at_start(self):
        dag = build_job_dag(0, 2, 2, True)
        assert dag.predecessors(TaskRef(0, 0, TaskKind.FORWARD, 0)) == []

    def test_allreduce_barrier_over_all_workers(self):
        dag = build_job_dag(0, 3, 2, True)
        preds = dag.predecessors(TaskRef(0, 1, TaskKind.ALLREDUCE))
        assert len(preds) == 3
        assert all(p.kind is TaskKind.BACKWARD and p.iteration == 1 for p in preds)

    def test_next_iteration_waits_for_allreduce(self):
        dag = build_job_dag(0, 2, 3, True)
        preds = dag.predecessors(TaskRef(0, 2, TaskKind.FORWARD, 1))
        assert preds == [TaskRef(0, 1, TaskKind.ALLREDUCE)]

    def test_no_comm_chain_is_per_worker(self):
        dag = build_job_dag(0, 2, 3, False)
        preds = dag.predecessors(TaskRef(0, 1, TaskKind.FORWARD, 1))
        assert preds == [TaskRef(0, 0, TaskKind.BACKWARD, 1)]

    def test_bucket_validation(self):
        with pytest.raises(ValueError, match="n_buckets"):
            JobDag(0, 2, 1, True, n_buckets=0)
        with pytest.raises(ValueError, match="needs comm"):
            JobDag(0, 2, 1, False, n_buckets=3)

    @pytest.mark.parametrize("workers, iters, comm, buckets", [
        (1, 2, False, 1), (3, 2, True, 1), (2, 3, True, 4), (4, 1, True, 2)])
    def test_tasks_and_edges_equal_reference(self, workers, iters, comm, buckets):
        dag = build_job_dag(5, workers, iters, comm, buckets)
        ref = rdag.build_job_dag(5, workers, iters, comm, buckets)

        def key(t):
            return (t.job_id, t.iteration, t.kind.value, t.worker, t.segment)

        tasks, ref_tasks = list(dag.tasks()), list(ref.tasks())
        assert [key(t) for t in tasks] == [key(t) for t in ref_tasks]
        assert [str(t) for t in tasks] == [str(t) for t in ref_tasks]
        for t, rt in zip(tasks, ref_tasks):
            assert [key(p) for p in dag.predecessors(t)] == [key(p) for p in ref.predecessors(rt)]
        assert dag.n_tasks() == ref.n_tasks() == len(tasks)


class TestValidation:
    def _valid_intervals(self, dag):
        t = 0.0
        out = {}
        for task in dag.tasks():
            out[task] = (t, t + 1.0)
            t += 1.0
        return out

    def test_accepts_valid_schedule(self):
        dag = build_job_dag(0, 2, 2, True)
        ok, msg = validate_schedule(dag, self._valid_intervals(dag))
        assert ok, msg

    def test_accepts_valid_bucketed_schedule(self):
        dag = build_job_dag(0, 2, 2, True, n_buckets=3)
        ok, msg = validate_schedule(dag, self._valid_intervals(dag))
        assert ok, msg

    def test_rejects_barrier_violation(self):
        dag = build_job_dag(0, 2, 1, True)
        iv = self._valid_intervals(dag)
        c = TaskRef(0, 0, TaskKind.ALLREDUCE)
        b1 = TaskRef(0, 0, TaskKind.BACKWARD, 1)
        iv[c] = (iv[b1][1] - 0.5, iv[b1][1] + 1.0)
        ok, msg = validate_schedule(dag, iv)
        assert not ok and "edge violated" in msg

    def test_rejects_missing_task(self):
        dag = build_job_dag(0, 2, 1, True)
        iv = self._valid_intervals(dag)
        iv.pop(TaskRef(0, 0, TaskKind.ALLREDUCE))
        ok, msg = validate_schedule(dag, iv)
        assert not ok and "mismatch" in msg

    def test_rejects_reversed_interval(self):
        dag = build_job_dag(0, 1, 1, False)
        iv = self._valid_intervals(dag)
        iv[TaskRef(0, 0, TaskKind.FORWARD, 0)] = (5.0, 1.0)
        ok, _ = validate_schedule(dag, iv)
        assert not ok


# ---------------------------------------------------------------------------
# Recorded traces: the reference's, and valid schedules of the DAG
# ---------------------------------------------------------------------------

MARKERS = ("preempt", "resize", "cancel")


def _parse(kind):
    """'f' | 'b' | 'c' | 'b3' | 'c3' -> (TaskKind, segment)."""
    seg = int(kind[1:]) if len(kind) > 1 else -1
    return TaskKind(kind[0]), seg


def validate_job(spec, trace):
    """Split a job's records at its preempt/resize markers; each
    incarnation must be a valid linear extension of the DAG of the
    iterations it ran (workers and buckets read from its records).  The
    incarnations cover 0..n-1 once, each iteration worth its world size in
    samples, adding up to ``total_samples`` (an elastic job's last one may
    run over); n is ``spec.iterations`` for a rigid job."""
    jid = spec.job_id
    recs = [r for r in trace if r[0] == jid and r[2] not in MARKERS]
    cuts = sorted(r[4] for r in trace if r[0] == jid and r[2] in ("preempt", "resize"))
    segs = [[] for _ in range(len(cuts) + 1)]
    for r in recs:
        segs[sum(1 for t in cuts if r[4] >= t)].append(r)
    covered, samples = [], 0
    for seg in (s for s in segs if s):
        iters = sorted({r[1] for r in seg})
        assert iters == list(range(iters[0], iters[-1] + 1)), (jid, iters)
        covered.extend(iters)
        workers = {r[3] for r in seg if r[3] >= 0}
        assert workers == set(range(len(workers))), (jid, workers)
        samples += len(iters) * len(workers)
        n_buckets = 1 + max((_parse(r[2])[1] for r in seg), default=0)
        has_comm = any(r[2].startswith("c") for r in seg)
        dag = build_job_dag(jid, len(workers), len(iters), has_comm, max(1, n_buckets))
        intervals = {}
        for (_, it, kind, w, t0, t1) in seg:
            k, s = _parse(kind)
            ref = TaskRef(jid, it - iters[0], k, w if k is not TaskKind.ALLREDUCE else -1, s)
            assert ref not in intervals, f"duplicate task {ref}"
            intervals[ref] = (t0, t1)
        ok, msg = validate_schedule(dag, intervals)
        assert ok, f"job {jid} incarnation at iteration {iters[0]}: {msg}"
    assert covered == list(range(len(covered))), (jid, covered)
    assert 0 <= samples - spec.total_samples < max(spec.gpu_bounds), (jid, samples)
    if not spec.is_elastic:
        assert covered == list(range(spec.iterations)), (jid, covered)


TRACE_CELLS = {
    "paper": dict(name="paper", quick=True, kw={}),
    "model_zoo_wfbp": dict(name="model_zoo", quick=True, kw={}),
    "preempted": dict(name="preemption_gain", quick=True, kw=dict(sched="preemptive_srsf")),
    "resized": dict(name="elastic_surge", quick=True, kw=dict(sched="elastic")),
    "broken_down": dict(name="chaos_recovery_storm", quick=False, kw={}, seed=3),
}


@pytest.mark.parametrize("cell", list(TRACE_CELLS))
def test_recorded_trace_equals_reference_and_validates(cell):
    c = TRACE_CELLS[cell]
    seed = c.get("seed", 0)
    over = P.QUICK_OVERRIDES[c["name"]] if c["quick"] else {}
    got_scn = P.get_scenario(c["name"], seed=seed, **over)
    kw = dict(comm="ada", record_trace=True, fuse_fb=False, **c["kw"])
    got = P.run_scenario_event(got_scn, **kw)
    ref = R.run_scenario_event(R.get_scenario(c["name"], seed=seed, **over), **kw)
    assert_same_result(got, ref)  # task_trace included, record by record
    trace = got.task_trace
    assert trace and got.censored == 0
    kinds = {r[2] for r in trace}
    if cell == "model_zoo_wfbp":
        assert any(k.startswith("c") and len(k) > 1 for k in kinds), "no WFBP bucket records"
    if cell in ("preempted", "broken_down"):
        assert "preempt" in kinds and got.preemptions > 0
    if cell == "resized":
        assert "resize" in kinds and got.resizes > 0
    if cell == "broken_down":
        assert got.faults > 0
    for spec in got_scn.job_list():
        validate_job(spec, trace)


def test_record_trace_turns_fuse_fb_off():
    """``record_trace=True`` keeps forward and backward apart, as the
    reference's: ``fuse_fb=True`` with a trace runs the unfused engine."""
    scn = P.get_scenario("smoke")
    fused = P.run_scenario_event(scn, record_trace=True)
    unfused = P.run_scenario_event(scn, record_trace=True, fuse_fb=False)
    assert_same_result(fused, unfused)
    assert "fb" not in {r[2] for r in fused.task_trace}
