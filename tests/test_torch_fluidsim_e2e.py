"""The port's fluid simulator against the JAX reference at QUICK size and
end to end (companion of ``test_torch_fluidsim.py``, split off so the two
run side by side).

* Tick lockstep on the QUICK ``paper``, ``hetero_bandwidth`` and
  ``oversub_fabric`` cells (bars in ``_torch_parity.py``).
* ``simulate_traces_batched`` over stacked ragged seeds, with ``skip`` and
  ``compact`` on and off: finished mask, every finish tick and makespan
  exact, and the driver runs as many chunks as the reference's.
"""

import numpy as np
import pytest
import torch

import repro.scenarios as R
from repro.core import jaxsim
from repro.scenarios.sweep import fluid_config as ref_fluid_config
import repro_torch.scenarios as P
from repro_torch.core import fluidsim

from _torch_parity import lockstep

torch.set_num_threads(1)


class TestQuickLockstep:
    @pytest.mark.parametrize(
        "name, comm, placement",
        [("paper", "ada", "lwf"),
         ("hetero_bandwidth", "srsf1", "ls"),
         ("oversub_fabric", "srsf2", "rack_pack")],
    )
    def test_quick_cell(self, name, comm, placement):
        lockstep(name, comm, placement, R.QUICK_OVERRIDES[name], chunk_steps=256)



def _small_batch(n_jobs=(10, 16, 13)):
    """Three ragged paper seeds, cut short so a run takes seconds."""
    kw = dict(min_iters=30, max_iters=120, horizon_s=150.0)
    rs = [R.get_scenario("paper", seed=s, n_jobs=n, **kw) for s, n in enumerate(n_jobs)]
    ps = [P.get_scenario("paper", seed=s, n_jobs=n, **kw) for s, n in enumerate(n_jobs)]
    return rs, ps


class TestEndToEnd:
    @pytest.mark.parametrize("skip", [True, False])
    @pytest.mark.parametrize("compact", [True, False])
    def test_batched_matches_reference(self, skip, compact, monkeypatch):
        rs, ps = _small_batch()
        chunks = {"n": 0}
        chunk_jit = jaxsim._chunk_jit

        def counting(*args, **kw):
            chunks["n"] += 1
            return chunk_jit(*args, **kw)

        monkeypatch.setattr(jaxsim, "_chunk_jit", counting)
        fast = dict(skip=skip, compact=compact, chunk_steps=32)
        jcfg = ref_fluid_config(rs[0], comm="ada", placement="lwf", **fast)
        ref = jaxsim.simulate_traces_batched(
            jaxsim.stack_traces([jaxsim.trace_from_jobs(s.job_list()) for s in rs]), jcfg
        )
        pcfg = P.fluid_config(ps[0], comm="ada", placement="lwf", device="cpu", **fast)
        got = fluidsim.simulate_traces_batched(
            fluidsim.stack_traces(
                [fluidsim.trace_from_jobs(s.job_list(), device="cpu") for s in ps]
            ),
            pcfg,
        )
        np.testing.assert_array_equal(got["finished"], np.asarray(ref["finished"]))
        assert got["finished"].sum() == sum(s.n_jobs for s in ps)
        np.testing.assert_array_equal(got["jct"], np.asarray(ref["jct"]))
        np.testing.assert_array_equal(got["makespan"], np.asarray(ref["makespan"]))
        assert got["chunks"] == chunks["n"]

    def test_simulate_trace_single_lane(self):
        rs, ps = _small_batch((14,))
        jcfg = ref_fluid_config(rs[0], comm="srsf2", placement="ff")
        pcfg = P.fluid_config(ps[0], comm="srsf2", placement="ff", device="cpu")
        ref = jaxsim.simulate_jobs(rs[0].job_list(), jcfg)
        got = fluidsim.simulate_jobs(ps[0].job_list(), pcfg)
        np.testing.assert_array_equal(got["finished"], ref["finished"])
        np.testing.assert_array_equal(got["jct"], ref["jct"])
        assert got["makespan"] == ref["makespan"]
