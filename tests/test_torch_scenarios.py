"""The port's scenarios and fluid sweep entry points against the JAX
reference (``repro.scenarios``), plus the port's import hygiene.

* The copied scenario builders give the reference's job lists, bit for bit.
* ``fluid_config`` gives the reference's ``JaxSimConfig`` field by field.
* ``run_scenario_fluid`` / ``monte_carlo_fluid`` / ``sweep_ci`` records
  match on finished count and JCTs (exact).
* ``repro_torch`` imports neither JAX nor ``repro``, and its entry points
  raise without CUDA unless given ``device="cpu"``.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.scenarios as R
from repro.scenarios.sweep import fluid_config as ref_fluid_config
import repro_torch.scenarios as P

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAMES = ("paper", "philly_heavy_tail", "bursty_diurnal", "hetero_bandwidth",
         "large_job_dominated", "adversarial_allbig", "contended_residue", "oversub_fabric",
         "rack_locality", "model_zoo", "fusion_sweep", "preemption_gain", "elastic_surge",
         "smoke")
#: a paper cut small enough for seconds-long CPU runs
SMALL_PAPER = dict(n_jobs=12, min_iters=30, max_iters=120, horizon_s=150.0)


def _job_tuple(j):
    m = j.model
    return (j.job_id, j.arrival, j.n_gpus, j.iterations, j.min_gpus, j.max_gpus,
            m.name, m.size_bytes, m.mem_mb, m.batch_size, m.t_f, m.t_b,
            m.layer_grad_bytes, m.layer_t_b)


class TestScenarioCopies:
    def test_registered_names(self):
        """Every scenario of the reference is registered (``NAMES``, the ones
        the fluid path takes, among them) with its quick overrides."""
        assert set(P.scenario_names()) == set(R.scenario_names())
        assert set(NAMES) <= set(P.scenario_names())
        for name in R.scenario_names():
            assert P.QUICK_OVERRIDES[name] == R.QUICK_OVERRIDES[name]

    @pytest.mark.parametrize("name", NAMES)
    @pytest.mark.parametrize("quick", [False, True])
    def test_job_lists_identical(self, name, quick):
        over = R.QUICK_OVERRIDES[name] if quick else {}
        for seed in range(4):
            ref = R.get_scenario(name, seed=seed, **over)
            got = P.get_scenario(name, seed=seed, **over)
            assert [_job_tuple(j) for j in got.job_list()] == [
                _job_tuple(j) for j in ref.job_list()
            ]
            fields = ("n_servers", "gpus_per_server", "fusion", "gpu_mem_mb", "sched",
                      "preemption_quantum", "exclusive_gpus")
            assert [getattr(got, f) for f in fields] == [getattr(ref, f) for f in fields]
            assert ref.chaos is None and ref.source is None
            assert dataclasses.astuple(got.params) == dataclasses.astuple(ref.params)
            if ref.topology is None:
                assert got.topology is None
            else:
                np.testing.assert_array_equal(got.topology.incidence(), ref.topology.incidence())
                np.testing.assert_array_equal(
                    got.topology.oversub_array(), ref.topology.oversub_array()
                )
                assert got.topology.rack_groups() == ref.topology.rack_groups()

    def test_unknown_scenario_raises(self):
        with pytest.raises(KeyError, match="unknown scenario"):
            P.get_scenario("chaos_monkey")


class TestFluidConfig:
    @pytest.mark.parametrize(
        "name, comm, placement",
        [("paper", "ada", "lwf"), ("hetero_bandwidth", "srsf2", "ls"),
         ("oversub_fabric", "adadual", "lwf_rack"), ("smoke", "srsf3", "ff"),
         ("contended_residue", "srsf1", "first_fit")],
    )
    def test_equals_jaxsim_config(self, name, comm, placement):
        ref = ref_fluid_config(R.get_scenario(name), comm=comm, placement=placement,
                               dt=0.1, chunk_steps=64, skip=False)
        got = P.fluid_config(P.get_scenario(name), comm=comm, placement=placement,
                             dt=0.1, chunk_steps=64, skip=False, device="cpu")
        assert got.device == "cpu"
        for f in dataclasses.fields(ref):
            mine, theirs = getattr(got, f.name), getattr(ref, f.name)
            if f.name == "topology" and theirs is not None:
                np.testing.assert_array_equal(mine.incidence(), theirs.incidence())
                np.testing.assert_array_equal(mine.oversub_array(), theirs.oversub_array())
                assert mine.name == theirs.name
            else:
                assert mine == theirs, f.name

    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError, match="fluid backend supports"):
            P.fluid_config(P.get_scenario("smoke"), comm="fifo", device="cpu")

    def test_kway_not_ported(self):
        """The exact k-way policies, ``gating="rounds"`` and the ``random``
        placement (threefry draws, seeded from the scenario) are ported: the
        port's config equals the reference's field by field."""
        for comm in ("kway2", "kway3"):
            ref = ref_fluid_config(R.get_scenario("fusion_sweep"), comm=comm, gating="rounds")
            got = P.fluid_config(P.get_scenario("fusion_sweep"), comm=comm, gating="rounds",
                                 device="cpu")
            for f in dataclasses.fields(ref):
                assert getattr(got, f.name) == getattr(ref, f.name), f.name
        ref = ref_fluid_config(R.get_scenario("smoke", seed=3), placement="rand")
        got = P.fluid_config(P.get_scenario("smoke", seed=3), placement="rand", device="cpu")
        for f in dataclasses.fields(ref):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
        assert got.placement == "random" and got.placement_seed == 3


def _assert_records(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for f in ("scenario", "backend", "placement", "comm", "seed", "n_jobs",
                  "n_finished", "avg_jct", "median_jct", "p95_jct", "makespan",
                  "censored", "p99_jct"):
            assert getattr(g, f) == getattr(r, f), f


class TestEntryPoints:
    @pytest.mark.parametrize("comm", ["ada", "srsf1"])
    @pytest.mark.parametrize("name", ["smoke", "contended_residue"])
    def test_run_scenario_fluid(self, name, comm):
        ref = R.run_scenario_fluid(R.get_scenario(name), comm=comm)
        got = P.run_scenario_fluid(P.get_scenario(name), comm=comm, device="cpu")
        np.testing.assert_array_equal(got["finished"], ref["finished"])
        assert got["finished"].all()
        np.testing.assert_array_equal(got["jct"], ref["jct"])
        assert got["makespan"] == ref["makespan"]

    def test_monte_carlo_fluid(self):
        kw = dict(seeds=range(3), comm="ada", placement="lwf", overrides=SMALL_PAPER)
        ref = R.monte_carlo_fluid("paper", **kw)
        got = P.monte_carlo_fluid("paper", device="cpu", **kw)
        _assert_records(got, ref)
        assert all(r.n_finished == r.n_jobs for r in got)

    def test_sweep_ci(self):
        kw = dict(comms=("ada", "srsf2"), placements=("lwf", "gang"), seeds=(0, 1),
                  overrides=SMALL_PAPER)
        ref = R.sweep_ci(["paper"], backend="fluid", **kw)
        got = P.sweep_ci(["paper"], device="cpu", **kw)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            for f in dataclasses.fields(g):
                if f.name != "wall_s":
                    assert getattr(g, f.name) == getattr(r, f.name), f.name

    def test_entry_points_need_cuda_unless_asked(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA present: the default device is usable here")
        with pytest.raises(RuntimeError, match="CUDA"):
            P.run_scenario_fluid(P.get_scenario("smoke"))
        with pytest.raises(RuntimeError, match="CUDA"):
            P.monte_carlo_fluid("smoke", seeds=[0])
        with pytest.raises(RuntimeError, match="CUDA"):
            P.sweep_ci(["smoke"], seeds=[0])


def _run(code_or_args, cwd, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


class TestHygiene:
    def test_port_imports_no_jax_and_no_reference(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import repro_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(mods), bad)\n"
            "sys.exit(1 if bad or len(mods) < 15 else 0)\n"
        )
        out = _run(["-c", code], REPO, {"PYTHONPATH": str(REPO / "src")})
        assert out.returncode == 0, out.stdout + out.stderr

    def test_flash_prefill_ab_imports_no_jax_and_fails_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA present: the script is meant to run here")
        code = (
            "import sys\n"
            "sys.path[:0] = ['scripts', '.']\n"
            "import chip_smoke, flash_prefill_ab\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n"
        )
        out = _run(["-c", code], REPO, {"PYTHONPATH": ""})
        assert out.returncode == 0, out.stdout + out.stderr
        out = _run(["scripts/flash_prefill_ab.py", "--baseline", "missing.cu"], REPO)
        assert out.returncode != 0
        assert "needs an NVIDIA GPU" in out.stderr

    def test_fluid_step_ab_imports_no_jax_and_fails_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA present: the script is meant to run here")
        code = (
            "import sys\n"
            "sys.path[:0] = ['scripts', '.']\n"
            "import chip_smoke, fluid_step_ab\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n"
        )
        out = _run(["-c", code], REPO, {"PYTHONPATH": ""})
        assert out.returncode == 0, out.stdout + out.stderr
        out = _run(["scripts/fluid_step_ab.py", "--baseline", "missing.cu"], REPO)
        assert out.returncode != 0
        assert "needs an NVIDIA GPU" in out.stderr

    def test_fluid_step_probe_marks_every_phase(self):
        """The probe of ``scripts/fluid_step_ab.py`` finds each phase marker
        of the kernel's source once (it raises otherwise)."""
        sys.path.insert(0, str(REPO / "scripts"))
        try:
            import fluid_step_ab
        finally:
            sys.path.remove(str(REPO / "scripts"))
        src = (REPO / "src/repro_torch/kernels/fluidstep/csrc/fluid_step.cu").read_text()
        probed = fluid_step_ab.probed_source(src)
        assert probed.count("g_fluid_probe[blockIdx.x]") == len(fluid_step_ab.PROBE_PHASES) + 1
        assert 'extern "C" int fluid_probe_read' in probed
        with pytest.raises(RuntimeError, match="marker"):
            fluid_step_ab.probed_source(src.replace("// ---- 2. ", "// 2. "))

    def test_chip_smoke_fails_without_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("CUDA present: chip_smoke.py is meant to run here")
        out = _run(["chip_smoke.py"], REPO)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        out = _run(["chip_smoke.py"], tmp_path, {"PYTHONPATH": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
