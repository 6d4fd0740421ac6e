"""The plain reference against the port's plain CPU path on small
``paper`` batches, on the cut time scale and on the published one: the
same job lists, and every lane's finished mask, JCTs and makespan
exactly."""

import importlib
import json

import numpy as np
import pytest

from portbench.harness import spec
from portbench.reference import fluid, jobs


def _config(name, **cut):
    with open(spec.BENCH_DIR / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(cut)
    return cfg


def _port_batch(cfg, seeds):
    """The entry's raw result planes for ``seeds`` on the CPU."""
    sweep = importlib.import_module("repro_torch.scenarios.sweep")
    got = {}
    orig = sweep.simulate_traces_batched

    def keep(traces, c, **kw):
        got["out"] = orig(traces, c, **kw)
        return got["out"]

    sweep.simulate_traces_batched = keep
    try:
        sweep.monte_carlo_fluid(cfg["scenario"], seeds, comm="ada", placement="lwf",
                                overrides={k: cfg[k] for k in cfg["program_overrides"]},
                                dt=cfg["dt"], max_steps=cfg["max_steps"], device="cpu")
    finally:
        sweep.simulate_traces_batched = orig
    return got["out"]


CASES = {
    "paper": dict(n_jobs=24, min_iters=20, max_iters=60),
    "paper_published_horizon": dict(n_jobs=24, min_iters=20, max_iters=60, horizon_s=1200.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_job_lists_equal_the_ports(name):
    from repro_torch.scenarios import get_scenario

    cfg = _config("paper", **CASES[name])
    for seed in (0, 3, 1001):
        scn = get_scenario(cfg["scenario"], seed=seed,
                           **{k: cfg[k] for k in cfg["program_overrides"]})
        mine = jobs.job_list(cfg, seed)
        assert [(j.arrival, j.n_gpus, j.iterations) for j in scn.jobs] == \
            [(a, g, it) for a, g, it, _ in mine]
        names = {k: m["t_f"] for k, m in cfg["models"].items()}
        assert [j.model.t_f for j in scn.jobs] == [names[m] for *_, m in mine]


def test_model_tables_equal_the_ports():
    from repro_torch.core.cluster import TABLE_III

    models = _config("paper")["models"]
    assert list(models) == list(TABLE_III)
    for key, prof in TABLE_III.items():
        m = models[key]
        assert (m["size_bytes"], m["t_f"], m["t_b"]) == (prof.size_bytes, prof.t_f, prof.t_b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_equals_the_ports_cpu_path(name):
    cfg = _config("paper", **CASES[name])
    seeds = [4, 9, 1002]
    out = _port_batch(cfg, seeds)
    ref = fluid.simulate(cfg, jobs.stack([jobs.lane_planes(cfg, s) for s in seeds]))
    assert ref["finished"].all()
    np.testing.assert_array_equal(out["finished"], ref["finished"])
    np.testing.assert_array_equal(out["jct"], ref["jct"])
    np.testing.assert_array_equal(out["makespan"], ref["makespan"])
    # one lane alone gives the lane's result in the batch
    alone = fluid.simulate(cfg, jobs.stack([jobs.lane_planes(cfg, seeds[1])]))
    np.testing.assert_array_equal(alone["jct"][0], ref["jct"][1])


def test_bf16_rounds_to_nearest_even():
    x = np.float32([1.0, 1.00390625, 1.01171875, -3.3, np.inf, 0.0])
    got = fluid.bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == np.float32(1.015625)
    assert got[3] == np.float32(-3.296875) and np.isinf(got[4]) and got[5] == 0.0
