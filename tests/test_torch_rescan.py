"""The ``rescan`` oracle modes of the port's event engine: ``gating=
"rescan"`` (every waiter evaluated in SRSF order on every event) and
``workloads="rescan"`` (every GPU's workload rebuilt from the live runs,
the whole queue scanned by ``StaticGangPolicy._scan_queue``).

Each mode's run is ``==`` the port's incremental run and the JAX
package's run in the same mode, every ``SimResult`` field, over the
registered scenarios at ``QUICK_OVERRIDES`` (chaos, preemptive and elastic
scheduling, WFBP buckets, fabrics and streamed replays among them), the
gating policies and the placements; with ``record_trace=True`` the whole
schedule too.  The defaults come from ``REPRO_GATING`` and
``REPRO_WORKLOADS``, as in the reference.
"""

import dataclasses
import functools

import pytest

import repro.scenarios as R
import repro_torch.scenarios as P
from repro_torch.core import engine as pengine

SIDES = {"port": P, "ref": R}
NAMES = sorted(P.scenario_names())


def quick(side, name, seed=1):
    mod = SIDES[side]
    return mod.get_scenario(name, seed=seed, **mod.QUICK_OVERRIDES[name])


@functools.lru_cache(maxsize=None)
def run(side, name, comm="ada", placement="lwf", mode="", **kw):
    kw = dict(kw)
    if mode:
        kw[mode] = "rescan"
    return SIDES[side].run_scenario_event(quick(side, name), comm=comm, placement=placement,
                                          **kw)


def assert_same(got, ref):
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("mode", ["gating", "workloads"])
@pytest.mark.parametrize("name", NAMES)
def test_scenarios(name, mode):
    incremental = run("port", name)
    got = run("port", name, mode=mode)
    assert_same(got, incremental)
    assert_same(got, run("ref", name, mode=mode))


@pytest.mark.parametrize("mode", ["gating", "workloads"])
@pytest.mark.parametrize("comm", ["srsf1", "kway2"])
@pytest.mark.parametrize("name", ["contended_residue", "fusion_sweep", "chaos_recovery_storm",
                                  "preemption_gain"])
def test_comm_policies(name, comm, mode):
    got = run("port", name, comm, mode=mode)
    assert_same(got, run("port", name, comm))
    assert_same(got, run("ref", name, comm, mode=mode))


@pytest.mark.parametrize("placement", ["ff", "ls", "rand", "lwf_rack"])
@pytest.mark.parametrize("name", ["paper", "rack_locality", "chaos_steady"])
def test_placements_workloads(name, placement):
    got = run("port", name, placement=placement, mode="workloads")
    assert_same(got, run("port", name, placement=placement))
    assert_same(got, run("ref", name, placement=placement, mode="workloads"))


@pytest.mark.parametrize("mode", ["gating", "workloads"])
@pytest.mark.parametrize("name", ["contended_residue", "elastic_surge", "chaos_stragglers"])
def test_schedule_identical(name, mode):
    """The task trace: the whole schedule, not only the statistics."""
    got = run("port", name, mode=mode, record_trace=True)
    assert got.task_trace
    assert_same(got, run("port", name, record_trace=True))
    assert_same(got, run("ref", name, mode=mode, record_trace=True))


def test_rescan_mode_has_no_index():
    jobs = quick("port", "smoke").job_list()
    eng = pengine.EventEngine(jobs, workloads="rescan")
    assert eng._windex is None and eng.placement.index is None
    eng.run()
    inc = pengine.EventEngine(jobs)
    assert inc._windex is not None and inc.placement.index is inc._windex


@pytest.mark.parametrize("var, attr", [("REPRO_GATING", "gating"),
                                       ("REPRO_WORKLOADS", "workloads")])
def test_env_default(monkeypatch, var, attr):
    jobs = quick("port", "smoke").job_list()
    monkeypatch.delenv(var, raising=False)
    assert getattr(pengine.EventEngine(jobs), attr) == "incremental"
    monkeypatch.setenv(var, "rescan")
    assert getattr(pengine.EventEngine(jobs), attr) == "rescan"
    # an explicit keyword wins over the environment
    assert getattr(pengine.EventEngine(jobs, **{attr: "incremental"}), attr) == "incremental"
    got = P.run_scenario_event(quick("port", "contended_residue"), comm="srsf1")
    monkeypatch.setenv(var, "rescan")
    ref = R.run_scenario_event(quick("ref", "contended_residue"), comm="srsf1")
    assert_same(got, ref)
    monkeypatch.setenv(var, "lazy")
    with pytest.raises(ValueError, match=attr):
        pengine.EventEngine(jobs)


@pytest.mark.parametrize("attr", ["gating", "workloads"])
def test_unknown_mode_raises(attr):
    with pytest.raises(ValueError, match=attr):
        pengine.EventEngine([], **{attr: "nope"})
