"""The port's dynamic scheduling (``repro_torch.core.schedpolicy``'s
``PreemptiveSrsfPolicy`` and ``ElasticPolicy``, ``EventEngine.preempt_job``
and ``request_resize``) against the JAX package's engine, on the CPU.

Ports of ``tests/test_engine.py``'s ``TestPreemptionMechanics``,
``TestPreemptionInvariants``, ``TestPreemptionGainRegression``,
``TestElasticSurgeRegression``, ``TestElasticResizeRebuild``,
``TestCensoredHorizon`` and ``TestPolicyFactory``, with the scripted
preempt and resize policies, run on the port; and beside them the bar of
the port's engine: every ``SimResult`` field (the recorded task trace
included) ``==`` the reference's on the same jobs — ``preemption_gain``
and ``elastic_surge`` under ``sched`` static, ``preemptive_srsf`` and
``elastic`` with comm ada and srsf1, the scripted runs, and every
Hypothesis draw.  The engine is plain Python floats in the reference's
order of operations, so a ulp would move an event.
"""

import dataclasses

import pytest

import repro.scenarios as R
import repro_torch.scenarios as P
from repro.core import netmodel as rnetmodel
from repro_torch.core import netmodel
from repro_torch.core.cluster import TABLE_III, Cluster, JobSpec
from repro_torch.core.dag import TaskKind, TaskRef, build_job_dag, validate_schedule
from repro_torch.core.engine import EventEngine
from repro_torch.core.placement import PlacementPolicy
from repro_torch.core.schedpolicy import (
    ElasticPolicy,
    PreemptiveSrsfPolicy,
    StaticGangPolicy,
    comm_policy_from_name,
    sched_policy_from_name,
)
from repro_torch.core.simulator import simulate
from repro_torch.core.topology import two_tier

from _hypothesis_compat import given, settings, st
from test_engine import ScriptedPreemptPolicy as RefScriptedPreempt
from test_engine import ScriptedResizePolicy as RefScriptedResize
from test_engine import make_engine as ref_make_engine
from test_scenarios import REGRESSION_SEEDS
from test_torch_engine import assert_same_result


# ---------------------------------------------------------------------------
# Scripted policies (test instrumentation, the reference's on the port)
# ---------------------------------------------------------------------------


class ScriptedResizePolicy(StaticGangPolicy):
    """Static admission plus a scripted sequence of resize requests for
    one job, issued one per quantum tick."""

    def __init__(self, job_id, sizes, quantum=0.4):
        self.job_id = job_id
        self.sizes = list(sizes)
        self.quantum = quantum

    def on_quantum(self, now):
        self._place_queue(now)
        if self.sizes and self.job_id in self.engine.runs:
            self.engine.request_resize(self.job_id, self.sizes.pop(0))


class ScriptedPreemptPolicy(StaticGangPolicy):
    """Static admission plus a scripted sequence of preemption victims, one
    per quantum tick; victims not running, or placed at this very tick,
    wait for a later tick."""

    def __init__(self, victims, quantum=0.08):
        self.victims = list(victims)
        self.quantum = quantum

    def on_quantum(self, now):
        self._place_queue(now)
        remaining, acted = [], False
        for vid in self.victims:
            run = self.engine.runs.get(vid)
            if run is not None and run.finished_at is not None:
                continue  # finished: can never be preempted, drop it
            if (
                not acted
                and run is not None
                and run.finished_at is None
                and run.placed_at < now
            ):
                self.engine.preempt_job(vid, now)
                acted = True
                continue
            remaining.append(vid)  # queued or same-tick: retry next tick
        self.victims = remaining


def make_engine(jobs, sched, n_servers=2, gpus_per_server=2, comm="ada", **kw):
    return EventEngine(
        jobs,
        cluster=Cluster(
            n_servers=n_servers,
            gpus_per_server=gpus_per_server,
            gpu_mem_mb=kw.pop("gpu_mem_mb", 16160.0),
        ),
        placement=PlacementPolicy("lwf", kappa=1),
        comm_policy=comm_policy_from_name(comm),
        sched=sched,
        **kw,
    )


def ref_jobs(jobs):
    """The same job list in the reference's classes (same Table III model
    by name; a model outside it is rebuilt field by field)."""
    from repro.core import TABLE_III as RTABLE
    from repro.core.cluster import JobSpec as RJobSpec
    from repro.core.cluster import ModelProfile as RModel

    out = []
    for j in jobs:
        m = j.model
        rm = RTABLE.get(m.name)
        if rm is None or dataclasses.astuple(rm) != dataclasses.astuple(m):
            rm = RModel(*dataclasses.astuple(m))
        out.append(RJobSpec(j.job_id, j.arrival, j.n_gpus, j.iterations, rm,
                            min_gpus=j.min_gpus, max_gpus=j.max_gpus))
    return out


def simulate_ref(jobs, **kw):
    from repro.core.simulator import simulate as rsimulate

    return rsimulate(ref_jobs(jobs), **kw)


# ---------------------------------------------------------------------------
# Trace helpers: per-incarnation DAG validation (the port's core/dag.py)
# ---------------------------------------------------------------------------


def split_segments(records, markers):
    """Partition one job's surviving task records into per-incarnation
    segments at the preempt/resize marker times."""
    times = sorted(t for (t, _it) in markers)
    segs = [[] for _ in range(len(times) + 1)]
    for rec in records:
        t0 = rec[4]
        idx = sum(1 for t in times if t0 >= t)
        segs[idx].append(rec)
    return segs


def validate_preempted_job_trace(spec, records, markers, n_workers=None):
    """Every incarnation's records are a valid linear extension of a job
    DAG over exactly the iterations it executed; together the
    incarnations cover 0..iterations-1 exactly once."""
    n_workers = n_workers if n_workers is not None else spec.n_gpus
    segs = [s for s in split_segments(records, markers) if s]
    covered = []
    for seg in segs:
        iters = sorted({r[1] for r in seg})
        assert iters == list(range(iters[0], iters[-1] + 1)), (
            f"job {spec.job_id}: incarnation covers non-contiguous iterations {iters}"
        )
        covered.extend(iters)
        it0 = iters[0]
        has_comm = any(r[2].startswith("c") for r in seg)
        dag = build_job_dag(spec.job_id, n_workers, len(iters), has_comm)
        intervals = {}
        for (jid, it, kind, w, t0, t1) in seg:
            ref = TaskRef(jid, it - it0, TaskKind(kind), w if kind != "c" else -1)
            assert ref not in intervals, f"duplicate task {ref}"
            intervals[ref] = (t0, t1)
        ok, msg = validate_schedule(dag, intervals)
        assert ok, f"job {spec.job_id} incarnation at iter {it0}: {msg}"
    assert covered == list(range(spec.iterations)), (
        f"job {spec.job_id}: iterations covered {covered} != 0..{spec.iterations - 1}"
    )


def job_records(trace, jid):
    recs = [r for r in trace if r[0] == jid and r[2] not in ("preempt", "resize")]
    markers = [(r[4], r[1]) for r in trace if r[0] == jid and r[2] == "preempt"]
    return recs, markers


# ---------------------------------------------------------------------------
# The registered cells against the reference
# ---------------------------------------------------------------------------

SCHEDS = ("static", "preemptive_srsf", "elastic")


@pytest.mark.parametrize("comm", ["ada", "srsf1"])
@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("name", ["preemption_gain", "elastic_surge"])
def test_cell_equals_reference(name, quick, sched, comm):
    """At the registered size (seed 0) and at ``QUICK_OVERRIDES`` with the
    regression seed, every field equal to the reference's."""
    seed = REGRESSION_SEEDS[name] if quick else 0
    over = R.QUICK_OVERRIDES[name] if quick else {}
    ref = R.run_scenario_event(R.get_scenario(name, seed=seed, **over), comm=comm, sched=sched)
    got = P.run_scenario_event(P.get_scenario(name, seed=seed, **over), comm=comm, sched=sched)
    assert_same_result(got, ref)
    assert got.sched_name == sched and got.censored == 0


@pytest.mark.parametrize("name", ["preemption_gain", "elastic_surge"])
def test_scenario_fields_equal_reference(name):
    got, ref = P.get_scenario(name), R.get_scenario(name)
    for f in ("sched", "preemption_quantum", "checkpoint_cost", "exclusive_gpus", "chaos",
              "source"):
        assert getattr(got, f) == getattr(ref, f), f


@pytest.mark.parametrize("kw", [
    dict(state_bytes=0.0), dict(state_bytes=1.2e9), dict(state_bytes=548e6),
    dict(state_bytes=97.5e6, save_bps=3e9, restore_bps=0.7e9, fixed_s=0.25),
])
def test_preemption_cost_equals_reference(kw):
    assert netmodel.preemption_cost(**kw) == rnetmodel.preemption_cost(**kw)
    for c in ("CHECKPOINT_SAVE_BPS", "CHECKPOINT_RESTORE_BPS", "CHECKPOINT_FIXED_S"):
        assert getattr(netmodel, c) == getattr(rnetmodel, c)


# ---------------------------------------------------------------------------
# Preemption mechanics
# ---------------------------------------------------------------------------


class TestPreemptionMechanics:
    def _jobs(self):
        # job 0 spans both servers (its comm crosses the preemption); job 1
        # is the single-GPU bystander that keeps running throughout
        return [
            JobSpec(0, 0.0, 4, 12, TABLE_III["resnet50"]),
            JobSpec(1, 0.0, 1, 30, TABLE_III["lstm_ptb"]),
        ]

    def _run(self, victims, side="port"):
        mk, pol = ((make_engine, ScriptedPreemptPolicy) if side == "port"
                   else (ref_make_engine, RefScriptedPreempt))
        jobs = self._jobs() if side == "port" else ref_jobs(self._jobs())
        eng = mk(jobs, pol(victims, quantum=0.11), n_servers=2, gpus_per_server=4,
                 record_trace=True, fuse_fb=False, checkpoint_cost=0.05)
        return eng, eng.run()

    @pytest.mark.parametrize("victims", [[0], [0, 0], [1, 0]])
    def test_scripted_run_equals_reference(self, victims):
        _, got = self._run(victims)
        _, ref = self._run(victims, "ref")
        assert got.preemptions == len(victims)
        assert_same_result(got, ref)

    def test_preempted_job_finishes_with_all_iterations(self):
        eng, res = self._run([0, 0])
        assert len(res.jct) == 2 and res.censored == 0
        assert res.preemptions == 2
        recs, markers = job_records(res.task_trace, 0)
        assert len(markers) == 2
        validate_preempted_job_trace(self._jobs()[0], recs, markers)
        # the untouched bystander is still one clean incarnation
        recs1, markers1 = job_records(res.task_trace, 1)
        assert markers1 == []
        validate_preempted_job_trace(self._jobs()[1], recs1, markers1)

    def test_gang_teardown_is_atomic(self):
        """No surviving task interval of the victim straddles a preemption
        instant: the whole gang stops together."""
        _, res = self._run([0])
        recs, markers = job_records(res.task_trace, 0)
        (t_pre, _), = markers
        for (_, _, _, _, t0, t1) in recs:
            assert t1 <= t_pre + 1e-9 or t0 >= t_pre - 1e-9, (
                f"interval [{t0}, {t1}] straddles preemption at {t_pre}"
            )

    def test_restore_penalty_delays_resume(self):
        """The preempted job's JCT grows by at least the checkpoint cost."""
        base = make_engine(self._jobs(), StaticGangPolicy(), n_servers=2,
                           gpus_per_server=4).run()
        _, res = self._run([0])
        assert res.jct[0] > base.jct[0] + 0.05 - 1e-9

    def test_preemption_cost_model(self):
        c = netmodel.preemption_cost(1.2e9)
        assert c == pytest.approx(
            netmodel.CHECKPOINT_FIXED_S
            + 1.2e9 / netmodel.CHECKPOINT_SAVE_BPS
            + 1.2e9 / netmodel.CHECKPOINT_RESTORE_BPS
        )
        assert netmodel.preemption_cost(0.0) == netmodel.CHECKPOINT_FIXED_S
        with pytest.raises(ValueError):
            netmodel.preemption_cost(-1.0)
        with pytest.raises(ValueError):
            netmodel.preemption_cost(1.0, save_bps=0.0)

    def test_preempting_finished_job_raises(self):
        eng = make_engine([JobSpec(0, 0.0, 1, 2, TABLE_III["resnet50"])], StaticGangPolicy())
        eng.run()
        with pytest.raises((ValueError, KeyError)):
            eng.preempt_job(0, 99.0)


# ---------------------------------------------------------------------------
# Preemption invariants (Hypothesis)
# ---------------------------------------------------------------------------

MODELS = ("resnet50", "inception_v3")


class TestPreemptionInvariants:
    @given(
        jobs=st.lists(
            st.tuples(
                st.integers(min_value=1, max_value=4),  # n_gpus
                st.integers(min_value=2, max_value=5),  # iterations
                st.sampled_from(MODELS),
                st.integers(min_value=0, max_value=2),  # arrival second
            ),
            min_size=1,
            max_size=3,
        ),
        victims=st.lists(st.integers(min_value=0, max_value=2), max_size=5),
        quantum=st.floats(min_value=0.03, max_value=0.3),
    )
    @settings(max_examples=25, deadline=None)
    def test_chaotic_preemption_trace_stays_valid(self, jobs, victims, quantum):
        specs = [
            JobSpec(i, float(arr), n, iters, TABLE_III[m])
            for i, (n, iters, m, arr) in enumerate(jobs)
        ]
        kw = dict(n_servers=2, gpus_per_server=2, record_trace=True, fuse_fb=False,
                  checkpoint_cost=0.02)
        res = make_engine(specs, ScriptedPreemptPolicy(victims, quantum=quantum), **kw).run()
        ref = ref_make_engine(ref_jobs(specs), RefScriptedPreempt(victims, quantum=quantum),
                              **kw).run()
        assert_same_result(res, ref)
        # completed iterations are never lost: every job finishes all its
        # work despite arbitrary mid-iteration gang teardowns
        assert len(res.jct) == len(specs)
        assert res.censored == 0
        for spec in specs:
            recs, markers = job_records(res.task_trace, spec.job_id)
            for (t_pre, _) in markers:
                for (_, _, _, _, t0, t1) in recs:
                    assert t1 <= t_pre + 1e-9 or t0 >= t_pre - 1e-9
            validate_preempted_job_trace(spec, recs, markers)


# ---------------------------------------------------------------------------
# Preemptive SRSF regression
# ---------------------------------------------------------------------------


class TestPreemptionGainRegression:
    """PreemptiveSrsfPolicy < static SRSF on the heavy-tailed fixed seed
    (preemption_gain, seed 2), the reference's 25 % floor."""

    @pytest.fixture(scope="class")
    def scn(self):
        return P.get_scenario("preemption_gain", seed=2)

    @pytest.mark.parametrize("comm", ["ada", "srsf1"])
    def test_preemptive_beats_static(self, scn, comm):
        static = P.run_scenario_event(scn, comm=comm)
        pre = P.run_scenario_event(scn, comm=comm, sched="preemptive_srsf")
        assert len(static.jct) == len(pre.jct) == scn.n_jobs
        assert pre.censored == 0
        assert pre.preemptions > 0
        assert pre.sched_name == "preemptive_srsf"
        assert pre.avg_jct() < static.avg_jct() * 0.75, (
            f"preemptive {pre.avg_jct():.1f} vs static {static.avg_jct():.1f}"
        )

    def test_preemptive_is_deterministic(self, scn):
        a = P.run_scenario_event(scn, comm="ada", sched="preemptive_srsf")
        b = P.run_scenario_event(scn, comm="ada", sched="preemptive_srsf")
        assert a.finish == b.finish and a.preemptions == b.preemptions


# ---------------------------------------------------------------------------
# Elastic scheduling
# ---------------------------------------------------------------------------


class TestElasticSurgeRegression:
    def test_elastic_beats_static_on_surge(self):
        scn = P.get_scenario("elastic_surge", seed=1)
        static = P.run_scenario_event(scn, comm="ada")
        el = P.run_scenario_event(scn, comm="ada", sched="elastic")
        assert len(el.jct) == scn.n_jobs and el.censored == 0
        assert el.resizes > 0
        assert el.avg_jct() < static.avg_jct() * 0.95, (
            f"elastic {el.avg_jct():.1f} vs static {static.avg_jct():.1f}"
        )


class TestElasticResizeRebuild:
    """A boundary resize rebuilds everything placement-derived: the WFBP
    fusion plan and the member-server/topology-domain sets for the new
    world size."""

    FUSION = 32e6

    def _run_scripted(self, sizes, side="port"):
        if side == "port":
            from repro_torch.workloads import ZOO_GPU_MEM_MB, zoo_profiles

            mk, pol, spec_cls, topo_fn = make_engine, ScriptedResizePolicy, JobSpec, two_tier
        else:
            from repro.core.cluster import JobSpec as spec_cls
            from repro.core.topology import two_tier as topo_fn
            from repro.workloads import ZOO_GPU_MEM_MB, zoo_profiles

            mk, pol = ref_make_engine, RefScriptedResize
        model = zoo_profiles()["mamba2_130m"]
        spec = spec_cls(0, 0.0, 4, 40, model, min_gpus=2, max_gpus=8)
        topo = topo_fn(2, 1, oversub=2.0)
        eng = mk([spec], pol(0, sizes, quantum=0.4), n_servers=2, gpus_per_server=4,
                 gpu_mem_mb=ZOO_GPU_MEM_MB, fusion=self.FUSION, topology=topo,
                 checkpoint_cost=0.01)
        snapshots = []
        orig = eng.place_job

        def recording_place(jid, gpu_ids, now):
            run = orig(jid, gpu_ids, now)
            snapshots.append(
                dict(
                    now=now,
                    n_world=run.n_world,
                    servers=frozenset(run.servers),
                    n_buckets=None if run.plan is None else len(run.plan[0]),
                    b_prog_len=len(run.b_prog),
                    target=run.target_iters,
                    iter_done=run.iter_done,
                    samples_done=run.samples_done,
                    domains=eng._domains_of(run.servers),
                )
            )
            return run

        eng.place_job = recording_place
        res = eng.run()
        return spec, topo, snapshots, res

    @pytest.fixture(scope="class")
    def scripted(self):
        """One scripted 4 -> 8 -> 2 resize run shared by the checks below."""
        return self._run_scripted([8, 2])

    def test_scripted_resizes_equal_reference(self, scripted):
        _, _, snaps, res = scripted
        _, _, ref_snaps, ref = self._run_scripted([8, 2], "ref")
        assert_same_result(res, ref)
        assert snaps == ref_snaps

    def test_resize_rebuilds_buckets_and_domains(self, scripted):
        spec, topo, snaps, res = scripted
        assert res.resizes == 2
        assert len(res.jct) == 1 and res.censored == 0
        assert [s["n_world"] for s in snaps] == [4, 8, 2]
        expected_buckets = len(
            netmodel.fusion_plan(spec.model.layer_grad_bytes, spec.model.layer_t_b,
                                 self.FUSION)[0]
        )
        # 4 GPUs consolidate on one server: no comm, no fusion plan
        assert len(snaps[0]["servers"]) == 1
        assert snaps[0]["n_buckets"] is None
        assert snaps[0]["domains"] == frozenset()
        # grown to 8: spans both servers, the plan rebuilt at the new world
        assert len(snaps[1]["servers"]) == 2
        assert snaps[1]["n_buckets"] == expected_buckets
        assert snaps[1]["b_prog_len"] == 8
        assert snaps[1]["domains"] == topo.loaded_domains(snaps[1]["servers"])
        assert len(snaps[1]["domains"]) > 0
        # shrunk to 2: back inside one server, monolithic again
        assert len(snaps[2]["servers"]) == 1
        assert snaps[2]["n_buckets"] is None
        assert snaps[2]["domains"] == frozenset()

    def test_resize_conserves_samples_and_recomputes_target(self, scripted):
        spec, _, snaps, res = scripted
        total = spec.total_samples
        for s in snaps:
            rem = total - s["samples_done"]
            assert 0 < rem <= total
            assert s["target"] == s["iter_done"] + -(-rem // s["n_world"])
        done = [s["samples_done"] for s in snaps]
        assert done == sorted(done) and done[0] == 0 and done[-1] > 0
        assert len(res.jct) == 1 and res.censored == 0

    def test_elastic_bounds_validation(self):
        with pytest.raises(ValueError, match="elastic bounds"):
            JobSpec(0, 0.0, 4, 10, TABLE_III["resnet50"], min_gpus=5)
        with pytest.raises(ValueError, match="elastic bounds"):
            JobSpec(0, 0.0, 4, 10, TABLE_III["resnet50"], max_gpus=2)
        spec = JobSpec(0, 0.0, 4, 10, TABLE_III["resnet50"], min_gpus=2, max_gpus=8)
        assert spec.is_elastic and spec.total_samples == 40
        assert not JobSpec(1, 0.0, 4, 10, TABLE_III["resnet50"]).is_elastic

    def test_request_resize_clamps_to_bounds(self):
        spec = JobSpec(0, 0.0, 4, 50, TABLE_III["resnet50"], min_gpus=2, max_gpus=8)
        eng = make_engine([spec], StaticGangPolicy(), n_servers=2, gpus_per_server=4)
        eng.queue.append(0)
        eng.sched._place_queue(0.0)
        eng.request_resize(0, 64)
        assert eng.runs[0].pending_resize == 8
        eng.request_resize(0, 1)
        assert eng.runs[0].pending_resize == 2
        eng.request_resize(0, 4)  # == current world: request cleared
        assert eng.runs[0].pending_resize is None


# ---------------------------------------------------------------------------
# Horizon censoring
# ---------------------------------------------------------------------------


class TestCensoredHorizon:
    def test_max_time_reports_censored_jobs(self):
        jobs = [
            JobSpec(0, 0.0, 1, 10, TABLE_III["resnet50"]),     # finishes early
            JobSpec(1, 0.0, 1, 100000, TABLE_III["resnet50"]),  # runs past cut
            JobSpec(2, 50.0, 1, 10, TABLE_III["resnet50"]),    # arrives after cut
        ]
        res = simulate(jobs, n_servers=1, gpus_per_server=2, max_time=5.0)
        assert set(res.jct) == {0}
        assert res.censored == 2

    def test_full_drain_has_zero_censored(self):
        jobs = [JobSpec(0, 0.0, 1, 10, TABLE_III["resnet50"])]
        res = simulate(jobs, n_servers=1, gpus_per_server=1)
        assert res.censored == 0

    def test_censored_reaches_metrics_row(self):
        from repro.scenarios.metrics import from_event_result as ref_from_event_result
        from repro_torch.scenarios.metrics import RunMetrics, from_event_result

        jobs = [
            JobSpec(0, 0.0, 1, 10, TABLE_III["resnet50"]),
            JobSpec(1, 0.0, 1, 100000, TABLE_III["resnet50"]),
        ]
        res = simulate(jobs, n_servers=1, gpus_per_server=2, max_time=5.0)
        m = from_event_result(res, scenario="x", seed=0, n_jobs=2)
        assert m.censored == 1
        fields = {f.name for f in dataclasses.fields(RunMetrics)}
        assert {"censored", "preemptions", "resizes", "faults", "cancelled"} <= fields
        ref = ref_from_event_result(
            simulate_ref(jobs, n_servers=1, gpus_per_server=2, max_time=5.0),
            scenario="x", seed=0, n_jobs=2)
        for f in ("censored", "preemptions", "resizes", "faults", "cancelled", "avg_jct"):
            assert getattr(m, f) == getattr(ref, f), f


# ---------------------------------------------------------------------------
# Policy construction
# ---------------------------------------------------------------------------


class TestPolicyFactory:
    def test_names(self):
        assert isinstance(sched_policy_from_name("static"), StaticGangPolicy)
        p = sched_policy_from_name("preemptive_srsf", quantum=7.0)
        assert isinstance(p, PreemptiveSrsfPolicy) and p.quantum == 7.0
        assert isinstance(sched_policy_from_name("preemptive"), PreemptiveSrsfPolicy)
        assert isinstance(sched_policy_from_name("elastic"), ElasticPolicy)
        assert sched_policy_from_name("elastic", quantum=3.0).quantum == 3.0
        with pytest.raises(ValueError, match="unknown scheduling policy"):
            sched_policy_from_name("fifo")

    def test_preemptive_validation(self):
        with pytest.raises(ValueError):
            PreemptiveSrsfPolicy(quantum=0.0)
        with pytest.raises(ValueError):
            PreemptiveSrsfPolicy(margin=0.5)
        p = PreemptiveSrsfPolicy()
        assert (p.quantum, p.margin, p.min_run) == (25.0, 1.25, 25.0)

    def test_static_never_ticks(self):
        assert StaticGangPolicy.quantum is None
