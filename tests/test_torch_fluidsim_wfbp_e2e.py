"""The port's fluid simulator end to end on the WFBP, gating-closure and
exact k-way paths and on the newly ported scenarios, against the JAX
reference on the CPU (companion of ``test_torch_fluidsim_wfbp.py``):
``simulate_traces_batched`` on ragged zoo seeds with lane, job and bucket
compaction, ``monte_carlo_fluid``, ``sweep_ci`` and ``run_scenario_fluid``.
Bars: finished mask, every finish tick and makespan exact, and the driver
runs as many chunks as the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.scenarios as R
import repro_torch.scenarios as P

from _torch_parity import both_batched

torch.set_num_threads(1)


class TestWfbpEndToEnd:
    @pytest.mark.parametrize("comm, fusion", [("ada", 64e6), ("kway2", "none")])
    def test_batched_with_compaction(self, comm, fusion):
        """Ragged zoo seeds: lanes retire, the job axis and the bucket axis
        are trimmed between chunks (never below 2 bucket columns)."""
        sizes = (12, 5, 9)
        kw = dict(min_iters=15, max_iters=60, horizon_s=600.0)
        rs = [R.get_scenario("model_zoo", seed=s, n_jobs=n, **kw) for s, n in enumerate(sizes)]
        ps = [P.get_scenario("model_zoo", seed=s, n_jobs=n, **kw) for s, n in enumerate(sizes)]
        got = both_batched(rs, ps, comm, fusion, chunk_steps=64)
        assert got["finished"].sum() == sum(sizes)
        widths = got["bucket_widths"]
        assert len(widths) > 1 and min(widths) >= 2
        assert widths == sorted(widths, reverse=True)

    def test_monte_carlo_fluid(self):
        kw = dict(seeds=range(3), comm="kway2", placement="ls",
                  overrides=R.QUICK_OVERRIDES["fusion_sweep"])
        ref = R.monte_carlo_fluid("fusion_sweep", **kw)
        got = P.monte_carlo_fluid("fusion_sweep", device="cpu", **kw)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert (g.n_finished, g.avg_jct, g.p95_jct, g.makespan) == (
                r.n_finished, r.avg_jct, r.p95_jct, r.makespan)
            assert g.n_finished == g.n_jobs

    def test_sweep_ci(self):
        kw = dict(comms=("kway3",), placements=("lwf",), seeds=(0, 1),
                  per_scenario_overrides=R.QUICK_OVERRIDES)
        names = ["model_zoo", "adversarial_allbig"]
        ref = R.sweep_ci(names, backend="fluid", **kw)
        got = P.sweep_ci(names, device="cpu", **kw)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            for f in dataclasses.fields(g):
                if f.name != "wall_s":
                    assert getattr(g, f.name) == getattr(r, f.name), f.name

    @pytest.mark.parametrize("name, seed", [("preemption_gain", 2), ("elastic_surge", 1),
                                            ("rack_locality", 0)])
    def test_static_modes(self, name, seed):
        """The event engine's preemptive and elastic workloads run as static
        gangs on the fluid path, as the reference's do."""
        rscn, pscn = R.get_scenario(name, seed=seed), P.get_scenario(name, seed=seed)
        assert pscn.sched == rscn.sched == "static"
        placement = "lwf_rack" if name == "rack_locality" else "lwf"
        ref = R.run_scenario_fluid(rscn, comm="ada", placement=placement, dt=0.1)
        got = P.run_scenario_fluid(pscn, comm="ada", placement=placement, dt=0.1, device="cpu")
        np.testing.assert_array_equal(got["finished"], ref["finished"])
        assert got["finished"].all()
        np.testing.assert_array_equal(got["jct"], ref["jct"])
        assert got["makespan"] == ref["makespan"]
