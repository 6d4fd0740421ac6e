"""The port's fluid simulator against the JAX reference
(``repro.core.jaxsim``), on the CPU.

* Traces: ``trace_from_jobs`` / ``stack_traces`` give the reference's
  arrays.
* Tick lockstep: from the same state, one chunk of the reference
  (``_chunk_jit``) and one of the port (``_lane_chunk``); every state leaf
  is compared after every chunk, and the run ends after the same number of
  chunks.  Bars: int and bool leaves exact, ``finish``/``t``/``free``/
  ``iters_left`` exact, ``rem`` to round-off (``rtol=1e-6, atol=1e-7``
  seconds: the reference's fused CPU graph contracts some multiply-adds
  into FMAs, the port rounds each operation).
The QUICK-size lockstep cells and the end-to-end runs are in
``test_torch_fluidsim_e2e.py``.
"""

import numpy as np
import pytest
import torch

import repro.scenarios as R
from repro.core import jaxsim
import repro_torch.scenarios as P
from repro_torch.core import fluidsim

from _torch_parity import lockstep, np_tree

torch.set_num_threads(1)

POLICIES = ("ada", "srsf1", "srsf2", "srsf3")
PLACEMENTS = ("lwf", "ff", "ls", "rack_pack")


class TestTraces:
    @pytest.mark.parametrize("name", ["paper", "hetero_bandwidth", "oversub_fabric",
                                      "contended_residue", "smoke"])
    def test_trace_from_jobs(self, name):
        for seed in (0, 1):
            ref = jaxsim.trace_from_jobs(R.get_scenario(name, seed=seed).job_list())
            got = fluidsim.trace_from_jobs(P.get_scenario(name, seed=seed).job_list(),
                                           device="cpu")
            assert got.keys() == ref.keys()
            for k, v in got.items():
                assert v.numpy().dtype == np.asarray(ref[k]).dtype, k
                np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)

    def test_stack_traces_ragged(self):
        sizes = (5, 12, 9)
        ref = jaxsim.stack_traces([
            jaxsim.trace_from_jobs(R.get_scenario("paper", seed=s, n_jobs=n).job_list())
            for s, n in enumerate(sizes)
        ])
        got = fluidsim.stack_traces([
            fluidsim.trace_from_jobs(P.get_scenario("paper", seed=s, n_jobs=n).job_list(),
                                     device="cpu")
            for s, n in enumerate(sizes)
        ])
        assert got.keys() == ref.keys()
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
        assert got["valid"].sum(1).tolist() == list(sizes)

    def test_from_reference_round_trip(self):
        tr = np_tree(jaxsim.stack_traces(
            [jaxsim.trace_from_jobs(R.get_scenario("smoke").job_list())]
        ))
        back = fluidsim.to_numpy(fluidsim.from_reference(tr, "cpu"))
        for k, v in tr.items():
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)


class TestLockstep:
    @pytest.mark.parametrize("placement", PLACEMENTS)
    @pytest.mark.parametrize("comm", POLICIES)
    @pytest.mark.parametrize("name", ["smoke", "contended_residue"])
    def test_small_grid(self, name, comm, placement):
        lockstep(name, comm, placement)


class TestOutOfSlice:
    def test_not_ported_options_raise(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fluidsim.FluidSimConfig(policy="kway2")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fluidsim.FluidSimConfig(placement="rand")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fluidsim.FluidSimConfig(gating="rounds")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fluidsim.trace_from_jobs(P.get_scenario("smoke").job_list(), fusion="none",
                                     device="cpu")
        bucketed = {"arrival": torch.zeros(2), "bucket_bytes": torch.ones(2, 3)}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fluidsim.stack_traces([bucketed])

    def test_bad_options_raise(self):
        with pytest.raises(ValueError, match="gating"):
            fluidsim.FluidSimConfig(gating="nope")
        with pytest.raises(ValueError, match="chunk_steps"):
            fluidsim.FluidSimConfig(chunk_steps=0)
        with pytest.raises(ValueError, match="impl"):
            fluidsim.FluidSimConfig(kernel="tpu")

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA present: the default device is usable here")
        with pytest.raises(RuntimeError, match="CUDA"):
            fluidsim.trace_from_jobs(P.get_scenario("smoke").job_list())
        tr = fluidsim.stack_traces(
            [fluidsim.trace_from_jobs(P.get_scenario("smoke").job_list(), device="cpu")]
        )
        with pytest.raises(RuntimeError, match="CUDA"):
            fluidsim.simulate_traces_batched(tr, fluidsim.FluidSimConfig(n_servers=4))
