"""The port's draws from the threefry (``repro_torch.prng``) in the fluid
simulator, against the JAX reference (``repro.core.jaxsim``) on the CPU.

* ``sample_trace``: the paper's sampled workload equal array for array to
  the reference's, per key, batched and unbatched.
* ``placement="random"``: the per-tick draw, and three ragged paper seeds
  through ``simulate_traces_batched`` with the skip and compaction on
  (finished mask, finish ticks, makespan and chunks equal); the tick
  lockstep cells are in ``test_torch_fluidsim_random_lockstep.py``.
* ``simulate_one`` and ``monte_carlo_jct`` (the sampled traces too): the
  reference's records, with both packages' draws cut to 20-80 iterations
  (the draws at the paper's 1000-6000 are held above and, at 8 seeds x 64
  jobs, card against CPU in chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax

import repro.scenarios as R
from repro.core import jaxsim
from repro.scenarios.sweep import fluid_config as ref_fluid_config
import repro_torch.scenarios as P
from repro_torch import prng
from repro_torch.core import fluidsim

torch.set_num_threads(1)

def _key(seed):
    return prng.PRNGKey(seed, "cpu")


class TestSampleTrace:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_equal_per_key(self, seed):
        ref = jaxsim.sample_trace(jax.random.PRNGKey(seed), 64)
        got = fluidsim.sample_trace(_key(seed), 64)
        assert got.keys() == ref.keys()
        for k, v in got.items():
            assert v.numpy().dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)

    def test_batched_keys(self):
        keys = jax.random.split(jax.random.PRNGKey(7), 5)
        ref = jax.vmap(lambda k: jaxsim.sample_trace(k, 33, horizon=600.0, min_iters=10,
                                                     max_iters=90))(keys)
        got = fluidsim.sample_trace(prng.split(_key(7), 5), 33, horizon=600.0,
                                    min_iters=10, max_iters=90)
        for k, v in got.items():
            assert tuple(v.shape) == (5, 33), k
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


class TestRandomPlacement:
    def test_draw_is_the_references(self):
        """The per-tick server order: ``uniform(fold_in(PRNGKey(seed), i))``
        for a vector of lane tick counters, equal to the reference's."""
        ticks = np.array([0, 1, 17, 4095, 2**20 + 3], np.int32)
        key = jax.random.PRNGKey(3)
        ref = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, int(i)), (16,)))
                        for i in ticks])
        got = prng.uniform(prng.fold_in(_key(3), torch.from_numpy(ticks)), (16,))
        np.testing.assert_array_equal(got.numpy(), ref)

    @pytest.mark.parametrize("comm", ["ada", "srsf2"])
    def test_batched_with_skip_and_compaction(self, comm, monkeypatch):
        """Three ragged paper seeds through both drivers: finished mask,
        finish ticks, makespan and chunk count equal."""
        kw = dict(min_iters=30, max_iters=120, horizon_s=150.0)
        rs = [R.get_scenario("paper", seed=s, n_jobs=n, **kw) for s, n in enumerate((10, 16, 13))]
        ps = [P.get_scenario("paper", seed=s, n_jobs=n, **kw) for s, n in enumerate((10, 16, 13))]
        chunks = {"n": 0}
        chunk_jit = jaxsim._chunk_jit

        def counting(*args, **kw):
            chunks["n"] += 1
            return chunk_jit(*args, **kw)

        monkeypatch.setattr(jaxsim, "_chunk_jit", counting)
        fast = dict(chunk_steps=32)
        ref = jaxsim.simulate_traces_batched(
            jaxsim.stack_traces([jaxsim.trace_from_jobs(s.job_list()) for s in rs]),
            ref_fluid_config(rs[0], comm=comm, placement="random", **fast))
        got = fluidsim.simulate_traces_batched(
            fluidsim.stack_traces([fluidsim.trace_from_jobs(s.job_list(), device="cpu")
                                   for s in ps]),
            P.fluid_config(ps[0], comm=comm, placement="random", device="cpu", **fast))
        for k in ("finished", "jct", "makespan"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert got["finished"].sum() == sum(s.n_jobs for s in ps)
        assert got["chunks"] == chunks["n"]


#: the paper's draws with iterations cut to 20-80 (from 1000-6000), so that a
#: sampled batch runs in seconds on the CPU: a tick per compute and per comm
#: phase of an iteration, whatever the tick's length
SHORT = dict(min_iters=20, max_iters=80)


class TestMonteCarlo:
    def test_sample_trace_jitted(self):
        """The reference's jitted ``sample_trace`` (``simulate_one``'s) draws
        the same arrays as its eager one and the port."""
        ref = jaxsim._sample_trace_jit(jax.random.PRNGKey(6), 64)
        got = fluidsim.sample_trace(_key(6), 64)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)

    def test_simulate_one(self, monkeypatch):
        """``simulate_one`` is ``simulate_trace`` of ``sample_trace(key)``:
        the port's (iterations cut in its ``sample_trace``) against the
        reference's ``simulate_trace`` of its own draw with the same cut."""
        kw = dict(n_servers=16, placement="random", placement_seed=2)
        monkeypatch.setattr(fluidsim, "sample_trace",
                            functools.partial(fluidsim.sample_trace, **SHORT))
        ref = jaxsim.simulate_trace(jaxsim.sample_trace(jax.random.PRNGKey(5), 12, **SHORT),
                                    jaxsim.JaxSimConfig(**kw))
        got = fluidsim.simulate_one(_key(5), 12, fluidsim.FluidSimConfig(device="cpu", **kw))
        for k in ("finished", "jct"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert got["finished"].all()
        assert float(got["makespan"]) == float(ref["makespan"])

    @pytest.mark.parametrize("policy, placement", [("ada", "consolidate"), ("srsf2", "random")])
    def test_monte_carlo_jct(self, policy, placement, monkeypatch):
        """Both packages' ``monte_carlo_jct`` with both ``sample_trace``s
        cut the same way: sampled traces, ``per_seed`` and the summary
        equal."""
        for mod in (jaxsim, fluidsim):
            monkeypatch.setattr(mod, "sample_trace", functools.partial(mod.sample_trace, **SHORT))
        ref = jaxsim.monte_carlo_jct(n_seeds=4, n_jobs=16, policy=policy, base_seed=1,
                                     placement=placement)
        got = fluidsim.monte_carlo_jct(n_seeds=4, n_jobs=16, policy=policy, base_seed=1,
                                       placement=placement, device="cpu")
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        traces = jax.vmap(lambda k: jaxsim.sample_trace(k, 16))(keys)
        assert traces["iters"].max() <= SHORT["max_iters"]
        for k, v in got["traces"].items():
            np.testing.assert_array_equal(v, np.asarray(traces[k]), err_msg=k)
        np.testing.assert_array_equal(got["per_seed"], ref["per_seed"])
        for k in ("avg_jct_mean", "avg_jct_std", "finished_frac"):
            assert got[k] == ref[k], k
