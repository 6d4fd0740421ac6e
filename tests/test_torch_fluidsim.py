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
* Block runner: a chunk run as ``chunk_steps / g`` blocks of ``g`` ticks
  over persistent buffers (the eager form of the CUDA graph the card
  replays) is bit-equal, leaf by leaf, to the plain tick loop.
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

from _torch_parity import CPU, lockstep, np_tree, plain_chunk

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
        """Nothing of the fluid slice is left out: the ``random`` placement
        (threefry draws) builds beside k-way and the rounds, and its
        statics carry the reference's placement key."""
        for kw in (dict(policy="kway2"), dict(policy="kway3"), dict(gating="rounds"),
                   dict(placement="rand"),
                   dict(placement="random", policy="kway2", gating="rounds",
                        placement_seed=2**31 + 5)):
            cfg = fluidsim.FluidSimConfig(**kw)
            k = fluidsim._Statics(cfg, torch.device("cpu"))
            assert k.place_key.tolist() == [0, cfg.placement_seed & 0xFFFFFFFF]
        tr = fluidsim.trace_from_jobs(P.get_scenario("smoke").job_list(), fusion="none",
                                      device="cpu")
        assert tr["bucket_bytes"].shape == (6, 1)
        bucketed = {"arrival": torch.zeros(2), "bucket_bytes": torch.ones(2, 3),
                    "n_buckets": torch.full((2,), 3, dtype=torch.int32)}
        assert fluidsim.stack_traces([bucketed])["bucket_bytes"].shape == (1, 2, 3)

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


class TestBlockRunner:
    @pytest.mark.parametrize("block", [1, 8, 256])
    @pytest.mark.parametrize(
        "name, comm, placement",
        [("paper", "ada", "lwf"), ("contended_residue", "srsf2", "ls"),
         ("oversub_fabric", "srsf1", "rack_pack"), ("model_zoo", "ada", "lwf"),
         ("fusion_sweep", "kway2", "lwf"), ("contended_residue", "kway3", "ff")],
    )
    def test_blocks_match_plain_loop(self, name, comm, placement, block):
        """Also with the ``bucket`` leaf (model_zoo at 64 MB buckets,
        fusion_sweep at 32 MB) and the exact k-way lookahead."""
        scns = [P.get_scenario(name, seed=s, **P.QUICK_OVERRIDES[name]) for s in (0, 1)]
        cfg = P.fluid_config(scns[0], comm=comm, placement=placement, device="cpu")
        assert cfg.chunk_steps == 256
        trace = fluidsim.stack_traces(
            [fluidsim.trace_from_jobs(s.job_list(), fusion=s.fusion, device="cpu")
             for s in scns])
        k = fluidsim._Statics(cfg, CPU)
        want = fluidsim._init_lane_state(trace, cfg, k.n_domains)
        buffers = {n: v.clone() for n, v in want.items()}
        runner = fluidsim._ChunkRunner(trace, buffers, cfg, k, block=block)
        ptrs = {n: v.data_ptr() for n, v in buffers.items()}
        for chunk in range(2):
            want = plain_chunk(trace, want, cfg, k)
            got = runner.run_chunk()
            assert got is buffers
            assert {n: v.data_ptr() for n, v in got.items()} == ptrs, "written in place"
            for n, v in want.items():
                assert got[n].dtype == v.dtype, n
                np.testing.assert_array_equal(got[n].numpy(), v.numpy(),
                                              err_msg=f"chunk {chunk + 1}: {n}")
        assert int(want["i"].min()) > 256, "the chunks ran past the start"

    def test_lane_chunk_leaves_its_input(self):
        scn = P.get_scenario("smoke")
        cfg = P.fluid_config(scn, comm="ada", placement="lwf", device="cpu", chunk_steps=24)
        trace = fluidsim.stack_traces([fluidsim.trace_from_jobs(scn.job_list(), device="cpu")])
        k = fluidsim._Statics(cfg, CPU)
        state = fluidsim._init_lane_state(trace, cfg, k.n_domains)
        before = fluidsim.to_numpy(state)
        got = fluidsim._lane_chunk(trace, state, cfg, k)  # blocks of gcd(BLOCK_TICKS, 24)
        want = plain_chunk(trace, state, cfg, k)
        for n, v in before.items():
            np.testing.assert_array_equal(state[n].numpy(), v, err_msg=n)
            np.testing.assert_array_equal(got[n].numpy(), want[n].numpy(), err_msg=n)

    def test_graph_and_block_options(self):
        scn = P.get_scenario("smoke")
        cfg = P.fluid_config(scn, comm="ada", placement="lwf", device="cpu")
        trace = fluidsim.stack_traces([fluidsim.trace_from_jobs(scn.job_list(), device="cpu")])
        k = fluidsim._Statics(cfg, CPU)
        state = fluidsim._init_lane_state(trace, cfg, k.n_domains)
        with pytest.raises(ValueError, match="divide"):
            fluidsim._ChunkRunner(trace, state, cfg, k, block=48)
        with pytest.raises(ValueError, match="CUDA"):
            fluidsim._ChunkRunner(trace, state, cfg, k, graph=True)
        with pytest.raises(ValueError, match="CUDA"):
            fluidsim.simulate_traces_batched(trace, cfg, _graph=True)
        eager = fluidsim.simulate_traces_batched(trace, cfg)
        assert eager["captures"] == []
        assert eager["finished"].all()
