"""Tick lockstep of the port's fluid simulator against the JAX reference
under ``placement="random"`` (threefry draws per lane and tick), on the
CPU: a small paper cell and the QUICK ``oversub_fabric`` cell under ada and
srsf2, scenario seeds (hence placement seeds) 0 and 1, chunks of 256
ticks.  Bars in ``_torch_parity.py``: every int and bool leaf and every
finish tick exact, ``rem`` to round-off, the same number of chunks.  The
other random-placement checks are in ``test_torch_fluidsim_random.py``.
"""

import pytest
import torch

import repro.scenarios as R
from repro.core import jaxsim
from repro.scenarios.sweep import fluid_config as ref_fluid_config
import repro_torch.scenarios as P
from repro_torch.core import fluidsim

from _torch_parity import CPU, assert_state, np_tree

torch.set_num_threads(1)

PAPER_SMALL = {"n_jobs": 24, "min_iters": 60, "max_iters": 300, "horizon_s": 300.0}


def _lockstep_seeded(name, comm, seed, overrides, chunk_steps):
    """Chunk-by-chunk lockstep of one cell under ``placement="random"``
    with the scenario (and placement) seed ``seed``; returns the chunks."""
    rscn = R.get_scenario(name, seed=seed, **overrides)
    pscn = P.get_scenario(name, seed=seed, **overrides)
    jcfg = ref_fluid_config(rscn, comm=comm, placement="random", chunk_steps=chunk_steps)
    pcfg = P.fluid_config(pscn, comm=comm, placement="random", device="cpu",
                          chunk_steps=chunk_steps)
    assert jcfg.placement_seed == pcfg.placement_seed == seed
    max_ways, gated, key = jaxsim._policy_args(jcfg)
    jtr = jaxsim.stack_traces([jaxsim.trace_from_jobs(rscn.job_list())])
    ptr = fluidsim.from_reference(np_tree(jtr), CPU)
    statics = fluidsim._Statics(pcfg, CPU)
    jst = jaxsim._init_jit(jtr, key)
    n_jobs = ptr["arrival"].shape[1]
    for chunk in range(1, 10_000):
        pst = fluidsim.from_reference(np_tree(jst), CPU)
        jst = jaxsim._chunk_jit(jtr, jst, key, max_ways, gated)
        pst = fluidsim._lane_chunk(ptr, pst, pcfg, statics)
        ref = np_tree(jst)
        assert_state(fluidsim.to_numpy(pst), ref, f"chunk {chunk}")
        if (ref["n_done"] >= n_jobs).all() or (ref["i"] >= jcfg.max_steps).all():
            break
    assert (ref["phase"] == fluidsim.DONE).all(), "every job finishes"
    return chunk


class TestRandomLockstep:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("comm", ["ada", "srsf2"])
    @pytest.mark.parametrize("name, overrides", [
        ("paper", PAPER_SMALL), ("oversub_fabric", R.QUICK_OVERRIDES["oversub_fabric"])])
    def test_lockstep(self, name, overrides, comm, seed):
        assert _lockstep_seeded(name, comm, seed, overrides, chunk_steps=256) >= 2

