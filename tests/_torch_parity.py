"""Shared parity helpers of the ``test_torch_fluidsim*`` files: configs
for both sides from the same scenario, and the tick-lockstep comparison of
the port's fluid simulator with the JAX reference."""

import numpy as np
import torch

import repro.scenarios as R
from repro.core import jaxsim
from repro.scenarios.sweep import fluid_config as ref_fluid_config
import repro_torch.scenarios as P
from repro_torch.core import fluidsim

CPU = torch.device("cpu")
EXACT_LEAVES = ("phase", "loads", "servers", "started", "n_done", "i",
                "finish", "t", "free", "iters_left")


def np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def configs(name, comm, placement, overrides, **fast_kw):
    rscn = R.get_scenario(name, seed=0, **overrides)
    pscn = P.get_scenario(name, seed=0, **overrides)
    jcfg = ref_fluid_config(rscn, comm=comm, placement=placement, **fast_kw)
    pcfg = P.fluid_config(pscn, comm=comm, placement=placement, device="cpu", **fast_kw)
    return rscn, jcfg, pcfg


def assert_state(port, ref, where):
    assert port.keys() == ref.keys(), where
    for k in EXACT_LEAVES:
        assert port[k].dtype == ref[k].dtype, (where, k)
        np.testing.assert_array_equal(port[k], ref[k], err_msg=f"{where}: {k}")
    np.testing.assert_allclose(port["rem"], ref["rem"], rtol=1e-6, atol=1e-7,
                               err_msg=f"{where}: rem")


def lockstep(name, comm, placement, overrides=None, chunk_steps=64):
    rscn, jcfg, pcfg = configs(
        name, comm, placement, overrides or {}, chunk_steps=chunk_steps
    )
    max_ways, gated, key = jaxsim._policy_args(jcfg)
    jtr = jaxsim.stack_traces([jaxsim.trace_from_jobs(rscn.job_list())])
    ptr = fluidsim.from_reference(np_tree(jtr), CPU)
    statics = fluidsim._Statics(pcfg, CPU)
    jst = jaxsim._init_jit(jtr, key)
    pst = fluidsim._init_lane_state(ptr, pcfg, statics.n_domains)
    assert_state(fluidsim.to_numpy(pst), np_tree(jst), "init")
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
