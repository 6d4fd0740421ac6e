"""The port's fluid simulator on WFBP bucket streams, the gating closures
and the exact k-way lookahead, against the JAX reference on the CPU.

* Tick lockstep (bars in ``_torch_parity.py``: int and bool leaves, the
  ``bucket`` leaf among them, exact; ``rem`` to round-off; equal chunk
  counts): ``model_zoo`` (QUICK, 12 jobs) at 16 MB buckets under ada,
  srsf2 and kway2 and with ``gating="rounds"``, ``fusion_sweep`` under ada,
  ``contended_residue`` under kway3.
* A contended zoo cell (``contended_residue``'s 5-GPU waves with zoo
  models, so bucketed transfers share servers): port against reference
  under both gating closures and k-way.  There the one-shot closure and
  the four rounds give different results on both sides (ROADMAP R9).

The end-to-end runs are in ``test_torch_fluidsim_wfbp_e2e.py`` (split off
so the two run side by side).
"""

import dataclasses

import pytest
import torch

import repro.scenarios as R
import repro.workloads as RW
import repro_torch.scenarios as P
import repro_torch.workloads as PW

from _torch_parity import both_batched, lockstep

torch.set_num_threads(1)

ZOO_12 = R.QUICK_OVERRIDES["model_zoo"]


class TestWfbpLockstep:
    @pytest.mark.parametrize(
        "name, comm, fusion, gating",
        [("model_zoo", "ada", 16e6, "fixedpoint"),
         ("model_zoo", "srsf2", 16e6, "fixedpoint"),
         ("model_zoo", "kway2", 16e6, "fixedpoint"),
         ("model_zoo", "ada", 16e6, "rounds"),
         ("fusion_sweep", "ada", None, "fixedpoint"),
         ("contended_residue", "kway3", None, "fixedpoint")],
    )
    def test_cell(self, name, comm, fusion, gating):
        assert ZOO_12["n_jobs"] == 12
        lockstep(name, comm, "lwf", R.QUICK_OVERRIDES[name], fusion=fusion, gating=gating)


def _zoo_residue(mod, zoo, seed):
    """contended_residue's waves of 5-GPU jobs on 4-GPU servers, with
    mamba2-130m and llama3.2-1b jobs in turn."""
    scn = mod.get_scenario("contended_residue", seed=seed, base_iters=8)
    archs = ("mamba2_130m", "llama32_1b")
    jobs = tuple(dataclasses.replace(j, model=zoo[archs[j.job_id % 2]]) for j in scn.jobs)
    return dataclasses.replace(scn, jobs=jobs)


class TestContendedZooCell:
    @pytest.mark.parametrize("comm", ["ada", "kway2"])
    def test_both_closures_match_reference(self, comm):
        rs = [_zoo_residue(R, RW.zoo_profiles(), s) for s in (0, 1)]
        ps = [_zoo_residue(P, PW.zoo_profiles(), s) for s in (0, 1)]
        jct = {}
        for gating in ("fixedpoint", "rounds"):
            got = both_batched(rs, ps, comm, 16e6, gating=gating, skip=False)
            assert got["finished"].all()
            jct[gating] = got["jct"]
        # the closure is not the rounds' result when many barriers meet (R9)
        assert (jct["fixedpoint"] != jct["rounds"]).any()
