"""The port's streamed arrivals (``repro_torch.core.trace.TraceSource``,
``repro_torch.scenarios.tracesource`` and the event engine's streaming
feed) against the JAX package's, on the CPU.

Ports of ``tests/test_tracesource.py``'s ``TestStreamingEquivalence``,
``TestStreamingTraceRecords``, ``TestSyntheticSource``, ``TestCsvSource``,
``TestSourceSpec`` and ``TestReplayScenarios``, and beside them: the
sources yield ``JobSpec``s equal to the reference's, a streamed run is
``==`` the materialised run and the reference's, and the two bundled CSV
samples are byte-equal copies of the reference's.  The replay-sizing lock
reads ``SimResult.steady_state`` where the reference reads
``replay_summary`` (a wrapper of it).  ``TestWindowedMetrics`` and
``TestPhaseProfiling`` wait with ``replay_summary`` and
``profile_phases`` (ROADMAP queue 1, items 7f and 7h).
"""

import dataclasses
import filecmp

import pytest

import repro.scenarios as R
import repro_torch.scenarios as P
from repro.core.simulator import simulate as rsimulate
from repro.core.trace import ListTraceSource as RListTraceSource
from repro.scenarios.tracesource import DATA_DIR as REF_DATA_DIR
from repro_torch.core.chaos import ChaosSpec
from repro_torch.core.simulator import simulate
from repro_torch.core.trace import ListTraceSource, TraceSource, paper_trace
from repro_torch.scenarios import (
    CsvTraceSource,
    SyntheticTraceSource,
    get_scenario,
    trace_source_from_spec,
)
from repro_torch.scenarios.tracesource import DATA_DIR

from test_torch_engine import assert_same_result
from test_torch_engine_dynamic import ref_jobs

REPLAYS = ("trace_replay_synth", "trace_replay_philly", "trace_replay_alibaba")


def small_trace(seed=0, n_jobs=60):
    return paper_trace(
        seed=seed, n_jobs=n_jobs, horizon_s=90.0, min_iters=3, max_iters=9,
        gpu_distribution=((1, 8), (2, 4), (4, 5), (8, 3)),
    )


def job_tuple(j):
    m = j.model
    return (j.job_id, j.arrival, j.n_gpus, j.iterations, j.min_gpus, j.max_gpus,
            dataclasses.astuple(m))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["alibaba_sample.csv", "philly_sample.csv"])
def test_csv_copies_are_byte_equal(name):
    assert filecmp.cmp(DATA_DIR / name, REF_DATA_DIR / name, shallow=False)
    assert DATA_DIR != REF_DATA_DIR


@pytest.mark.parametrize("spec, n", [("synth", 300), ("philly", 40), ("alibaba", 40),
                                     ("philly", 7)])
@pytest.mark.parametrize("seed", [0, 5])
def test_sources_yield_reference_jobs(spec, n, seed):
    got = trace_source_from_spec(spec, n_jobs=n, seed=seed)
    ref = R.trace_source_from_spec(spec, n_jobs=n, seed=seed)
    assert [job_tuple(j) for j in got.arrivals()] == [job_tuple(j) for j in ref.arrivals()]
    assert got.n_jobs_hint() == ref.n_jobs_hint()


@pytest.mark.parametrize("kw", [dict(n_jobs=50, seed=3), dict(n_jobs=80, seed=1, rate=4.0,
                                                              min_iters=5, max_iters=11)])
def test_synthetic_source_equals_reference(kw):
    got = SyntheticTraceSource(**kw).materialize()
    ref = R.SyntheticTraceSource(**kw).materialize()
    assert [job_tuple(j) for j in got] == [job_tuple(j) for j in ref]


@pytest.mark.parametrize("time_scale, max_jobs", [(1.0, None), (0.5, None), (2.0, 13)])
@pytest.mark.parametrize("dialect", ["philly", "alibaba"])
def test_csv_source_equals_reference(dialect, time_scale, max_jobs):
    path = str(DATA_DIR / f"{dialect}_sample.csv")
    got = CsvTraceSource(path, dialect, time_scale=time_scale, max_jobs=max_jobs)
    ref = R.CsvTraceSource(str(REF_DATA_DIR / f"{dialect}_sample.csv"), dialect,
                           time_scale=time_scale, max_jobs=max_jobs)
    assert [job_tuple(j) for j in got.materialize()] == [
        job_tuple(j) for j in ref.materialize()]


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("name", REPLAYS)
def test_replay_scenario_equals_reference(name, quick):
    """The registered replays (``trace_replay_synth`` streamed through
    ``run_scenario_event``): jobs, scenario fields and the streamed run's
    every field equal to the reference's, and to the port's own run of the
    materialised list but for the calendar's high-water mark."""
    over = R.QUICK_OVERRIDES[name] if quick else {}
    got_scn, ref_scn = P.get_scenario(name, **over), R.get_scenario(name, **over)
    assert [job_tuple(j) for j in got_scn.jobs] == [job_tuple(j) for j in ref_scn.jobs]
    assert (got_scn.n_servers, got_scn.gpus_per_server, got_scn.n_jobs) == (
        ref_scn.n_servers, ref_scn.gpus_per_server, ref_scn.n_jobs)
    assert got_scn.source is not None
    for comm in ("ada", "srsf2"):
        got = P.run_scenario_event(got_scn, comm=comm)
        assert_same_result(got, R.run_scenario_event(ref_scn, comm=comm))
        # the list run: the same values (its dicts in run order, the
        # stream's in finish order), a calendar of every arrival
        listed = P.run_scenario_event(dataclasses.replace(got_scn, source=None), comm=comm)
        assert got.peak_calendar < listed.peak_calendar
        for f in dataclasses.fields(got):
            if f.name != "peak_calendar":
                assert getattr(got, f.name) == getattr(listed, f.name), f.name


@pytest.mark.parametrize("sched", ["static", "preemptive_srsf", "elastic"])
def test_streamed_run_equals_reference(sched):
    jobs = small_trace()
    kw = dict(comm="ada", sched=sched, n_servers=4, gpus_per_server=4)
    got = simulate(ListTraceSource(jobs), **kw)
    assert_same_result(got, rsimulate(RListTraceSource(ref_jobs(jobs)), **kw))


# ---------------------------------------------------------------------------
# Streaming equivalence
# ---------------------------------------------------------------------------


class TestStreamingEquivalence:
    @pytest.mark.parametrize("sched", ["static", "preemptive_srsf"])
    def test_list_vs_streaming(self, sched):
        jobs = small_trace()
        kw = dict(comm="ada", sched=sched, n_servers=4, gpus_per_server=4)
        lst = simulate(jobs, **kw)
        stream = simulate(ListTraceSource(jobs), **kw)
        assert stream.jct == lst.jct
        assert stream.finish == lst.finish
        assert stream.queueing_delay == lst.queueing_delay
        assert stream.events_processed == lst.events_processed
        assert stream.censored == lst.censored == 0
        assert stream.goodput == pytest.approx(lst.goodput)
        assert stream.preemptions == lst.preemptions
        assert stream.peak_calendar < lst.peak_calendar

    def test_streaming_censoring_counts_seen_jobs_only(self):
        jobs = small_trace()
        kw = dict(comm="ada", n_servers=4, gpus_per_server=4, max_time=30.0)
        lst = simulate(jobs, **kw)
        stream = simulate(ListTraceSource(jobs), **kw)
        assert lst.jct == stream.jct
        assert lst.censored == len(jobs) - len(lst.jct)
        assert stream.censored <= lst.censored
        arrived = len([j for j in jobs if j.arrival <= 30.0])
        assert stream.censored <= arrived + 1 - len(stream.jct)
        assert_same_result(stream, rsimulate(RListTraceSource(ref_jobs(jobs)), **kw))

    def test_engine_rejects_unsorted_stream(self):
        class Unsorted(TraceSource):
            def arrivals(self):
                return iter(small_trace()[::-1])

        with pytest.raises(ValueError, match="arrival"):
            simulate(Unsorted(), n_servers=4, gpus_per_server=4)

    def test_engine_rejects_duplicate_job_ids(self):
        class Duped(TraceSource):
            def arrivals(self):
                j = small_trace()[0]
                return iter([j, j])

        with pytest.raises(ValueError, match="job"):
            simulate(Duped(), n_servers=4, gpus_per_server=4)


class TestStreamingTraceRecords:
    def test_streaming_trace_identical_under_preemption_and_chaos(self):
        """A streamed run records the list run's task trace, the preempt
        markers of the breakdowns and the re-run iterations included, and
        both are the reference's."""
        from repro.core.chaos import ChaosSpec as RChaosSpec

        jobs = small_trace(n_jobs=30)
        # failure instants off any round number: coincident event times
        # resolve by insertion order, which streaming permutes
        windows = ((0, 4.0314, 6.0272), (1, 9.0718, 10.0281))
        kw = dict(comm="ada", sched="preemptive_srsf", n_servers=4, gpus_per_server=4,
                  record_trace=True, fuse_fb=False, checkpoint_cost=0.02)
        lst = simulate(jobs, chaos=ChaosSpec(seed=3, scripted_failures=windows), **kw)
        stream = simulate(ListTraceSource(jobs), chaos=ChaosSpec(seed=3,
                                                                  scripted_failures=windows),
                          **kw)
        assert lst.preemptions > 0
        assert lst.work_lost_samples > 0
        assert stream.task_trace == lst.task_trace
        assert stream.finish == lst.finish
        assert [r for r in lst.task_trace if r[2] == "preempt"]
        ref = rsimulate(RListTraceSource(ref_jobs(jobs)),
                        chaos=RChaosSpec(seed=3, scripted_failures=windows), **kw)
        assert_same_result(stream, ref)

    def test_censored_stream_trace_stops_at_horizon(self):
        jobs = small_trace()
        cut = jobs[40].arrival + 0.01
        res = simulate(ListTraceSource(jobs), comm="ada", n_servers=4, gpus_per_server=4,
                       record_trace=True, fuse_fb=False, max_time=cut)
        assert res.censored > 0
        finished = set(res.jct)
        for (jid, _it, kind, _w, t0, t1) in res.task_trace:
            assert t0 <= cut + 1e-9
            if t1 is None:  # comm in flight at the cut
                assert kind.startswith("c")
                assert jid not in finished
            elif t1 > cut + 1e-9:
                assert jid not in finished
        traced = {r[0] for r in res.task_trace}
        assert traced - finished, "censored jobs left no trace records"


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------


class TestSyntheticSource:
    def test_deterministic_and_restartable(self):
        src = SyntheticTraceSource(n_jobs=50, seed=3)
        a, b = src.materialize(), src.materialize()
        assert a == b
        assert len(a) == 50 == src.n_jobs_hint()
        assert [j.job_id for j in a] == list(range(50))
        assert all(a[i].arrival <= a[i + 1].arrival for i in range(len(a) - 1))

    def test_seed_changes_stream(self):
        assert (SyntheticTraceSource(n_jobs=30, seed=0).materialize()
                != SyntheticTraceSource(n_jobs=30, seed=1).materialize())

    def test_validation(self):
        with pytest.raises(ValueError, match="n_jobs"):
            SyntheticTraceSource(n_jobs=0)
        with pytest.raises(ValueError, match="rate"):
            SyntheticTraceSource(n_jobs=1, rate=0.0)


class TestCsvSource:
    def test_philly_sample_parses(self):
        jobs = CsvTraceSource(str(DATA_DIR / "philly_sample.csv"), "philly").materialize()
        assert len(jobs) == 40
        assert [j.job_id for j in jobs] == list(range(40))
        assert all(j.iterations >= 1 for j in jobs)
        assert all(1 <= j.n_gpus <= 8 for j in jobs)
        # a deterministic round-robin over the sorted model names
        assert jobs[0].model.name != jobs[1].model.name
        assert jobs[0].model == jobs[4].model

    def test_alibaba_gpu_percent_scaling(self):
        jobs = CsvTraceSource(str(DATA_DIR / "alibaba_sample.csv"), "alibaba").materialize()
        assert len(jobs) == 40
        assert {j.n_gpus for j in jobs} <= {1, 2, 4, 8}

    def test_time_scale_compresses(self):
        path = str(DATA_DIR / "philly_sample.csv")
        full = CsvTraceSource(path, "philly").materialize()
        half = CsvTraceSource(path, "philly", time_scale=0.5).materialize()
        assert half[-1].arrival == pytest.approx(full[-1].arrival * 0.5)
        assert all(h.iterations <= f.iterations for h, f in zip(half, full))

    def test_max_jobs_truncates(self):
        src = CsvTraceSource(str(DATA_DIR / "philly_sample.csv"), "philly", max_jobs=7)
        assert len(src.materialize()) == 7

    def test_unknown_dialect_raises(self):
        with pytest.raises(ValueError, match="dialect"):
            CsvTraceSource("x.csv", dialect="borg")


class TestSourceSpec:
    def test_synth(self):
        src = trace_source_from_spec("synth", n_jobs=123, seed=9)
        assert isinstance(src, SyntheticTraceSource)
        assert src.n_jobs_hint() == 123

    def test_synth_replay_sizing_exercises_the_queue(self):
        """The replay sizing loads a 16x2 cluster: nonzero queueing delay
        in the steady state while every job finishes and the calendar
        stays far below the job count (20,000 jobs, ~6 s)."""
        src = trace_source_from_spec("synth", n_jobs=20_000, seed=0)
        res = simulate(src, placement="lwf", comm="ada", n_servers=16, gpus_per_server=2)
        ss = res.steady_state(60.0)
        assert len(res.jct) == 20_000
        assert ss["queueing_delay_mean"] > 0.0
        assert ss["queueing_delay_p99"] > 0.0
        assert res.peak_calendar < 500

    def test_overloaded_source_queues(self):
        src = SyntheticTraceSource(n_jobs=300, seed=1, rate=50.0, min_iters=3, max_iters=9)
        res = simulate(src, placement="lwf", comm="ada", n_servers=4, gpus_per_server=2)
        assert res.queueing_delay
        assert max(res.queueing_delay.values()) > 0.0
        ref = rsimulate(R.SyntheticTraceSource(n_jobs=300, seed=1, rate=50.0, min_iters=3,
                                               max_iters=9),
                        placement="lwf", comm="ada", n_servers=4, gpus_per_server=2)
        assert_same_result(res, ref)

    def test_bundled_csvs(self):
        for name in ("philly", "alibaba"):
            src = trace_source_from_spec(name, n_jobs=5)
            assert isinstance(src, CsvTraceSource)
            assert len(src.materialize()) == 5

    def test_csv_spec(self):
        src = trace_source_from_spec(f"csv:alibaba:{DATA_DIR / 'alibaba_sample.csv'}", n_jobs=3)
        assert src.dialect == "alibaba"
        assert len(src.materialize()) == 3

    def test_bad_specs_raise(self):
        with pytest.raises(ValueError, match="trace source"):
            trace_source_from_spec("nope")
        with pytest.raises(ValueError, match="csv"):
            trace_source_from_spec("csv:only-one-colon")


class TestReplayScenarios:
    def test_materialized_jobs_match_source(self):
        scn = get_scenario("trace_replay_synth", seed=0, n_jobs=40)
        assert scn.source is not None
        assert list(scn.jobs) == scn.source.materialize()
        assert scn.n_jobs == 40

    def test_large_scale_stays_lazy(self):
        scn = get_scenario("trace_replay_synth", seed=0, n_jobs=50_000)
        assert scn.jobs == ()
        assert scn.n_jobs == 50_000  # from the hint, nothing materialized

    def test_event_sweep_runs_streaming(self):
        scn = get_scenario("trace_replay_synth", seed=0, n_jobs=40)
        res = P.run_scenario_event(scn, comm="ada")
        assert len(res.jct) == 40
        assert res.censored == 0
        assert res.peak_calendar < 40 + 2 * scn.total_gpus

    def test_fluid_raises_on_unmaterialized_source(self):
        scn = get_scenario("trace_replay_synth", seed=0, n_jobs=50_000)
        with pytest.raises(ValueError, match="streaming"):
            P.fluid_config(scn, comm="ada", device="cpu")
