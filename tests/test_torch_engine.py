"""The port's event engine (``repro_torch.core.engine``) against the JAX
package's (``repro.core.engine``), on the same interpreter, cell by cell.

Every scenario the port registers (all of the reference's, the chaos
ones with their fault specs and the trace replays streamed), at
``QUICK_OVERRIDES`` and the regression seed of ``tests/test_scenarios.py``,
runs under ada, srsf1 and srsf2 with LWF-1 placement (``sched="static"``);
the k-way cells are in ``tests/test_torch_engine_kway.py``, the preemptive
and elastic policies in ``tests/test_torch_engine_dynamic.py``.  The engine is plain
Python floats in the reference's order of operations, so the bar is exact
equality of every ``SimResult`` field — a ulp moves an event.  The
reference's paper-ordering lock runs on the port's results of the same
cells.  ``tests/test_torch_engine_knobs.py`` holds the placement, fusion
and engine-option cells.  (Three files, so that the suite's workers share
them.)
"""

import dataclasses
import functools
import math

import pytest

import repro.scenarios as R
import repro_torch.scenarios as P
from repro_torch.core import engine as pengine
from repro_torch.core import simulator as psim
from test_scenarios import REGRESSION_SEEDS, RTOL
from test_scenarios import TestPaperOrderings as _RefOrderings

NAMES = P.scenario_names()
COMMS = ("ada", "srsf1", "srsf2")


def scenario(side, name):
    mod = P if side == "port" else R
    return mod.get_scenario(name, seed=REGRESSION_SEEDS[name], **mod.QUICK_OVERRIDES[name])


@functools.lru_cache(maxsize=None)
def run(side, name, comm="ada", placement="lwf", kappa=1, **kw):
    mod = P if side == "port" else R
    return mod.run_scenario_event(scenario(side, name), placement=placement, kappa=kappa,
                                  comm=comm, sched="static", **kw)


def assert_same_result(got, ref):
    """Every field of the reference's SimResult, exactly (dicts per key)."""
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert list(got.jct) == list(ref.jct), "finish order of the result dicts"


def test_registers_every_fluid_scenario():
    """The port registers every scenario of the reference, the fluid path's
    and the event-only chaos and trace-replay ones alike."""
    assert set(NAMES) == set(R.scenario_names())
    assert set(NAMES) <= set(REGRESSION_SEEDS)


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name", NAMES)
def test_cell_equals_reference(name, comm):
    got, ref = run("port", name, comm), run("ref", name, comm)
    assert got.censored == 0 and len(got.jct) == scenario("port", name).n_jobs
    assert_same_result(got, ref)


@pytest.mark.parametrize("name", ["paper", "hetero_bandwidth", "fusion_sweep"])
def test_event_record_equals_reference(name):
    """``from_event_result`` of the same run: every field, NaN where the
    reference has NaN (no observability)."""
    got = P.from_event_result(run("port", name), scenario=name, seed=1, n_jobs=7)
    ref = R.from_event_result(run("ref", name), scenario=name, seed=1, n_jobs=7)
    assert got.backend == "event"
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), f.name
        else:
            assert a == b, f.name


def test_simulate_equals_reference():
    from repro.core import simulator as rsim

    jobs = scenario("port", "paper").job_list()
    rjobs = scenario("ref", "paper").job_list()
    for kw in (dict(comm="srsf2"), dict(comm="kway3", fuse_fb=False),
               dict(placement="ls", n_servers=8, gpus_per_server=8, gpu_mem_mb=32000.0)):
        assert_same_result(psim.simulate(jobs, **kw), rsim.simulate(rjobs, **kw))


def _same_or_both_nan(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("name, comm", [("paper", "ada"), ("fusion_sweep", "srsf2")])
def test_windowed_and_steady_state_equal_reference(name, comm):
    """``SimResult.windowed`` and ``steady_state`` of the same run, at
    windows that cut the run into many pieces, a few, and one (where the
    warmup cut leaves nothing and the summary falls back to all windows)."""
    got, ref = run("port", name, comm), run("ref", name, comm)
    for frac in (1 / 23, 1 / 4, 2.0):
        w = ref.makespan * frac
        gw, rw = got.windowed(w), ref.windowed(w)
        assert len(gw) == len(rw) >= 1
        for g, r in zip(gw, rw):
            assert list(g) == list(r)
            assert all(_same_or_both_nan(g[k], r[k]) for k in r), (frac, r)
        for warmup in (0.1, 0.5):
            g, r = got.steady_state(w, warmup), ref.steady_state(w, warmup)
            assert list(g) == list(r)
            assert all(_same_or_both_nan(g[k], r[k]) for k in r), (frac, warmup, r)


def test_max_time_censors():
    got = P.run_scenario_event(scenario("port", "paper"), max_time=60.0)
    ref = R.run_scenario_event(scenario("ref", "paper"), max_time=60.0)
    assert 0 < got.censored < 40
    assert_same_result(got, ref)


class TestPaperOrderings:
    """``tests/test_scenarios.py::TestPaperOrderings::test_ada_beats_srsf_baselines``
    on the port's engine: Ada-SRSF <= SRSF(1) and SRSF(2) in avg JCT."""

    @pytest.mark.parametrize("name", NAMES)
    def test_ada_beats_srsf_baselines(self, name):
        n_jobs = scenario("port", name).n_jobs
        ada, srsf1, srsf2 = (run("port", name, c) for c in ("ada", "srsf1", "srsf2"))
        assert len(ada.jct) == len(srsf1.jct) == len(srsf2.jct) == n_jobs
        slack = _RefOrderings.SRSF1_SLACK.get(name, RTOL)
        assert ada.avg_jct() <= srsf1.avg_jct() * (1 + slack), name
        assert ada.avg_jct() <= srsf2.avg_jct() * (1 + RTOL), name


class TestNotPorted:
    """The keywords that raised before ROADMAP queue 1 items 7e-7g were
    ported now run, each to the reference's result on the same jobs (the
    observed and profiled runs' ``obs`` and ``phase_seconds`` aside; their
    contents are held in ``tests/test_torch_obs.py``)."""

    @pytest.mark.parametrize("kw, item", [
        (dict(comm_chunks=4), "7e"),
        (dict(contention_domain="link"), "7e"),
        (dict(observe="full"), "7f"),
        (dict(profile_phases=True), "7f"),
        (dict(gating="rescan"), "7g"),
        (dict(workloads="rescan"), "7g"),
    ])
    def test_raises(self, kw, item):
        import repro.core.engine as rengine
        import repro.obs as robs
        import repro_torch.obs as pobs

        results = []
        for side, eng, obs in (("port", pengine, pobs), ("ref", rengine, robs)):
            side_kw = dict(kw, observe=obs.ObsConfig.full()) if "observe" in kw else kw
            results.append(eng.EventEngine(scenario(side, "smoke").job_list(), **side_kw).run())
        got, ref = results
        assert (got.obs is None) == (ref.obs is None) == ("observe" not in kw), item
        assert (got.phase_seconds is None) == (ref.phase_seconds is None), item
        for f in dataclasses.fields(ref):
            if f.name not in ("obs", "phase_seconds"):
                assert getattr(got, f.name) == getattr(ref, f.name), f.name

    def test_trace_source_raises(self):
        """A ``TraceSource`` is accepted in place of the job list (since the
        streamed feed was ported) and runs to the list's result."""
        from repro_torch.core.trace import ListTraceSource

        jobs = scenario("port", "smoke").job_list()
        streamed = pengine.EventEngine(ListTraceSource(jobs)).run()
        listed = pengine.EventEngine(jobs).run()
        assert len(streamed.jct) == len(jobs) and streamed.jct == listed.jct

    def test_bad_names_raise(self):
        jobs = scenario("port", "smoke").job_list()
        for kw in (dict(sched="fifo"), dict(gating="lazy"), dict(contention_domain="rack")):
            with pytest.raises(ValueError):
                pengine.EventEngine(jobs, **kw)

    def test_defaults_accepted(self):
        jobs = scenario("port", "smoke").job_list()
        eng = pengine.EventEngine(jobs, sched="static", gating="incremental",
                                  workloads="incremental", preemption_quantum=None,
                                  checkpoint_cost=None)
        assert len(eng.run().jct) == len(jobs)
