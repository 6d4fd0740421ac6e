"""The port's event engine against the port's fluid path, on the CPU: the
reference's cross-backend harness (``tests/test_differential.py``) run on
the port, with its cells and bounds.

The fluid path is a documented approximation (gang-exclusive placement,
fixed dt, one admission per tick), so agreement is qualitative: both
backends finish every job, and the fluid avg JCT lies within the
reference's ``RATIO`` (2.0) of the event engine's — within
``FUSION_RATIO`` (1.35) on the WFBP cells — and the ada < srsf2 ordering
on ``contended_residue`` holds on both.  Trimmed to the reference's
smallest cells (every fluid run here is the port's eager CPU path)."""

import functools

import pytest

import repro_torch.scenarios as P
from test_differential import DT, FUSION_RATIO, HETERO_KW, OVERSUB_KW, RATIO
from test_differential import TestModelZoo as _RefZoo

CELLS = {
    "smoke": {},
    "contended_residue": dict(seed=1),
    "hetero_bandwidth": HETERO_KW,
    "oversub_fabric": OVERSUB_KW,
    "model_zoo": _RefZoo.ZOO_KW,
    "fusion_sweep": dict(seed=1, **P.QUICK_OVERRIDES["fusion_sweep"]),
}
#: the reference's dt per cell
FLUID_DT = {"smoke": DT, "contended_residue": DT, "hetero_bandwidth": 0.05,
            "oversub_fabric": 0.05, "model_zoo": 0.02, "fusion_sweep": 0.01}


@functools.lru_cache(maxsize=None)
def scn(name):
    return P.get_scenario(name, **CELLS[name])


@functools.lru_cache(maxsize=None)
def event(name, comm, placement="lwf"):
    return P.run_scenario_event(scn(name), comm=comm, placement=placement)


@functools.lru_cache(maxsize=None)
def fluid(name, comm, placement="lwf"):
    out = P.run_scenario_fluid(scn(name), comm=comm, placement=placement,
                               dt=FLUID_DT[name], device="cpu")
    assert int(out["finished"].sum()) == scn(name).n_jobs, (name, comm)
    return float(out["jct"][out["finished"]].mean()), float(out["makespan"])


def assert_within(name, comm, ratio, placement="lwf"):
    ev = event(name, comm, placement)
    assert len(ev.jct) == scn(name).n_jobs and ev.censored == 0
    fl, _ = fluid(name, comm, placement)
    assert ev.avg_jct() / ratio <= fl <= ev.avg_jct() * ratio, (name, comm, ev.avg_jct(), fl)


def test_smoke_agrees():
    assert_within("smoke", "ada", RATIO)
    ev, (_, fl_makespan) = event("smoke", "ada"), fluid("smoke", "ada")
    assert ev.makespan / RATIO <= fl_makespan <= ev.makespan * RATIO


@pytest.mark.parametrize("comm", ["ada", "srsf1", "srsf2", "kway2"])
def test_contended_residue_agrees(comm):
    assert_within("contended_residue", comm, RATIO)


@pytest.mark.parametrize("comm", ["ada", "srsf2"])
@pytest.mark.parametrize("name", ["hetero_bandwidth", "oversub_fabric"])
def test_downsized_fabric_cells_agree(name, comm):
    assert_within(name, comm, RATIO)


def test_rand_on_smoke_agrees():
    assert_within("smoke", "ada", RATIO, placement="rand")


@pytest.mark.parametrize("name, comm", [("model_zoo", "ada"), ("model_zoo", "kway2"),
                                        ("fusion_sweep", "ada")])
def test_wfbp_cells_agree(name, comm):
    assert_within(name, comm, FUSION_RATIO)


def test_gating_differentiates_on_both_backends():
    """AdaDUAL refuses the always-colliding equal-size transfers while
    SRSF(2) accepts 2-way contention: on both backends SRSF(2) is worse."""
    assert event("contended_residue", "ada").avg_jct() < event("contended_residue",
                                                               "srsf2").avg_jct()
    assert fluid("contended_residue", "ada")[0] < fluid("contended_residue", "srsf2")[0]
