"""The port's event engine against the reference's on the placement,
fusion and engine-option cells (the policy cells are in
``tests/test_torch_engine.py``): LWF-2, LWF_RACK, FF, LS and RAND on
``paper``, ``oversub_fabric`` and ``rack_locality``; ``model_zoo`` and
``fusion_sweep`` with fusion "none" and 16 MB buckets; ``hetero_bandwidth``
with ``bandwidth_aware_srsf``; ``paper`` with ``exclusive_gpus``.  Bar:
every ``SimResult`` field exactly equal.  The workload index the engine
keeps is also held to its own rescan after every run."""

import pytest

from test_torch_engine import assert_same_result, run

PLACEMENTS = [("lwf", 2), ("lwf_rack", 1), ("ff", 1), ("ls", 1), ("rand", 1)]


@pytest.mark.parametrize("placement, kappa", PLACEMENTS)
@pytest.mark.parametrize("name", ["paper", "oversub_fabric", "rack_locality"])
def test_placement_cell(name, placement, kappa):
    got = run("port", name, "ada", placement, kappa)
    assert_same_result(got, run("ref", name, "ada", placement, kappa))
    assert got.censored == 0


@pytest.mark.parametrize("comm", ["ada", "kway2"])
@pytest.mark.parametrize("fusion", ["none", 16e6])
@pytest.mark.parametrize("name", ["model_zoo", "fusion_sweep"])
def test_fusion_cell(name, fusion, comm):
    got = run("port", name, comm, fusion=fusion)
    assert_same_result(got, run("ref", name, comm, fusion=fusion))
    assert got.censored == 0


def test_bandwidth_aware_srsf():
    """(At this size the bandwidth-aware SRSF key reorders nothing, as the
    reference finds; the estimate itself is held in
    ``tests/test_torch_adadual.py``.)"""
    got = run("port", "hetero_bandwidth", "ada", bandwidth_aware_srsf=True)
    assert_same_result(got, run("ref", "hetero_bandwidth", "ada", bandwidth_aware_srsf=True))


@pytest.mark.parametrize("name", ["paper", "adversarial_allbig"])
def test_exclusive_gpus(name):
    got = run("port", name, "ada", exclusive_gpus=True)
    assert_same_result(got, run("ref", name, "ada", exclusive_gpus=True))
    if name == "adversarial_allbig":  # where one job per GPU changes the schedule
        assert got.jct != run("port", name, "ada").jct


@pytest.mark.parametrize("placement", ["lwf_rack", "ls"])
def test_cluster_index_matches_rescan(placement):
    """After a run the maintained aggregates equal a from-scratch rescan,
    exactly (``ClusterIndex.assert_consistent``)."""
    import repro_torch.scenarios as P
    from repro_torch.core.engine import EventEngine
    from repro_torch.core.placement import PlacementPolicy
    from repro_torch.core.schedpolicy import comm_policy_from_name

    scn = P.get_scenario("oversub_fabric", seed=1, **P.QUICK_OVERRIDES["oversub_fabric"])
    eng = EventEngine(scn.job_list(), cluster=scn.make_cluster(),
                      placement=PlacementPolicy(placement, topology=scn.topology),
                      comm_policy=comm_policy_from_name("srsf2"), params=scn.params,
                      topology=scn.topology)
    eng.run(max_time=150.0)
    eng.refresh_workloads()
    assert eng._live  # stopped mid-run, with live gangs
    eng._windex.assert_consistent(eng)
