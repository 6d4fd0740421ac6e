"""Shared parity helpers of the ``test_torch_fluidsim*`` files: configs
for both sides from the same scenario, the tick-lockstep comparison of the
port's fluid simulator with the JAX reference, the same batch through both
drivers, and the plain tick loop the block runner is held to."""

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
#: exact too where the trace has WFBP planes
BUCKET_LEAVES = ("bucket",)


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
    for k in EXACT_LEAVES + tuple(b for b in BUCKET_LEAVES if b in ref):
        assert port[k].dtype == ref[k].dtype, (where, k)
        np.testing.assert_array_equal(port[k], ref[k], err_msg=f"{where}: {k}")
    np.testing.assert_allclose(port["rem"], ref["rem"], rtol=1e-6, atol=1e-7,
                               err_msg=f"{where}: rem")


def lockstep(name, comm, placement, overrides=None, chunk_steps=64, fusion=None,
             **fast_kw):
    """Chunk-by-chunk lockstep of one seed-0 cell; ``fusion`` None takes
    the scenario's own, ``fast_kw`` (e.g. ``gating``) reaches both
    configs.  Returns the number of chunks."""
    rscn, jcfg, pcfg = configs(
        name, comm, placement, overrides or {}, chunk_steps=chunk_steps, **fast_kw
    )
    max_ways, gated, key = jaxsim._policy_args(jcfg)
    fusion = rscn.fusion if fusion is None else fusion
    jtr = jaxsim.stack_traces([jaxsim.trace_from_jobs(rscn.job_list(), fusion=fusion)])
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


def plain_chunk(trace, state, cfg, k):
    """The chunk as one plain loop of ``chunk_steps`` ticks with the live
    freeze, written out here independently of the block runner."""
    c = fluidsim._trace_consts(trace, cfg, k.inv_dt)
    n_jobs = trace["arrival"].shape[1]
    for _ in range(cfg.chunk_steps):
        live = (state["n_done"] < n_jobs) & (state["i"] < cfg.max_steps)
        by_rank = (live, live[:, None], live[:, None, None])
        new = fluidsim._lane_step(trace, c, state, k, cfg)
        state = {name: torch.where(by_rank[v.dim() - 1], v, state[name])
                 for name, v in new.items()}
    return state


def both_batched(rs, ps, comm, fusion, placement="lwf", **fast_kw):
    """The reference's and the port's ``simulate_traces_batched`` on the
    same stacked seeds (``rs`` the reference's scenarios, ``ps`` the
    port's): finished mask, every finish tick, makespan and the number of
    chunks must be equal.  Returns the port's result."""
    chunks = {"n": 0}
    chunk_jit = jaxsim._chunk_jit

    def counting(*args, **kw):
        chunks["n"] += 1
        return chunk_jit(*args, **kw)

    jaxsim._chunk_jit = counting
    try:
        ref = jaxsim.simulate_traces_batched(
            jaxsim.stack_traces([jaxsim.trace_from_jobs(s.job_list(), fusion=fusion) for s in rs]),
            ref_fluid_config(rs[0], comm=comm, placement=placement, **fast_kw))
    finally:
        jaxsim._chunk_jit = chunk_jit
    got = fluidsim.simulate_traces_batched(
        fluidsim.stack_traces([fluidsim.trace_from_jobs(s.job_list(), fusion=fusion, device="cpu")
                               for s in ps]),
        P.fluid_config(ps[0], comm=comm, placement=placement, device="cpu", **fast_kw))
    for k in ("finished", "jct", "makespan"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert got["chunks"] == chunks["n"]
    return got
