"""The port's WFBP pieces against the JAX reference, on the CPU:

* the fusion planner (``fusion_threshold``, ``fusion_plan``,
  ``plan_for_model``): equal tuples;
* the model zoo (``repro_torch.workloads``): its constants, every profile
  and layer tuple, and the six configs' analytic counts equal the
  reference's;
* the trace planes of ``trace_from_jobs``/``stack_traces`` at fusion
  "none", 16 MB and 64 MB, and with lanes that lack them: equal arrays;
* ``gating_fixed_point`` and ``kway_exact_start`` on random ``(L, J, J)``
  inputs made with numpy from a seed: per lane, the bools of the reference
  function called op by op (outside ``jit``) on the same inputs;
* on the port alone, as ``tests/test_fastpath.py`` holds the reference:
  the one-shot gating closure gives the four rounds' results bit for bit
  over fusion {"none", 16 MB} x {ada, srsf2, kway2} (``skip=False`` on
  both sides, as the two define the skip's guard differently).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenarios as R
import repro.workloads as RW
from repro.configs import get_config as ref_get_config
from repro.core import jaxsim
from repro.core import netmodel as ref_nm
from repro.core.cluster import TABLE_III as REF_TABLE_III
import repro_torch.scenarios as P
import repro_torch.workloads as PW
from repro_torch.configs import get_config
from repro_torch.core import fluidsim, netmodel
from repro_torch.core.cluster import TABLE_III
from repro_torch.core.contention import ContentionParams

torch.set_num_threads(1)

FUSIONS = ("all", "none", "NONE", 0, 1.0, 16e6, 32e6, 64e6, float("inf"))


class TestFusionPlan:
    @pytest.mark.parametrize("fusion", FUSIONS)
    def test_threshold(self, fusion):
        assert netmodel.fusion_threshold(fusion) == ref_nm.fusion_threshold(fusion)

    @pytest.mark.parametrize("bad", ["some", -1.0])
    def test_threshold_rejects(self, bad):
        with pytest.raises(ValueError):
            ref_nm.fusion_threshold(bad)
        with pytest.raises(ValueError):
            netmodel.fusion_threshold(bad)

    @pytest.mark.parametrize("seed", range(4))
    def test_plan_on_random_layers(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 40))
        sizes = (rng.lognormal(15, 2, n) * rng.integers(0, 2, n)).tolist()
        times = rng.uniform(0, 1e-2, n).tolist()
        for thr in (0.0, 1e5, 4e6, 3e7, float(np.sum(sizes)), float("inf")):
            assert netmodel.fusion_plan(sizes, times, thr) == ref_nm.fusion_plan(sizes, times, thr)

    def test_plan_validation(self):
        for args in (([1.0], [], 1.0), ([], [], 1.0)):
            with pytest.raises(ValueError):
                ref_nm.fusion_plan(*args)
            with pytest.raises(ValueError):
                netmodel.fusion_plan(*args)

    @pytest.mark.parametrize("fusion", FUSIONS)
    def test_plan_for_model(self, fusion):
        for name, m in {**PW.zoo_profiles(), **TABLE_III}.items():
            ref = {**RW.zoo_profiles(), **REF_TABLE_III}[name]
            assert netmodel.plan_for_model(m, fusion) == ref_nm.plan_for_model(ref, fusion), name


class TestModelZoo:
    def test_constants(self):
        for k in ("PEAK_FLOPS_BF16", "HBM_BW"):
            assert getattr(PW.profiles, k) == getattr(RW.profiles, k), k
        for k in ("MFU", "GRAD_BYTES_PER_PARAM", "RESIDENT_BYTES_PER_PARAM", "TOKENS_PER_GPU",
                  "ZOO_ARCHS", "ZOO_GPU_MEM_MB"):
            assert getattr(PW, k) == getattr(RW, k), k

    @pytest.mark.parametrize("arch", RW.ZOO_ARCHS)
    def test_profile(self, arch):
        got, ref = PW.zoo_profiles()[arch], RW.zoo_profiles()[arch]
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)
        assert got.has_layers and ref.has_layers
        assert got.t_iter_compute == ref.t_iter_compute
        for tokens in (1024, PW.TOKENS_PER_GPU):
            mine = PW.derive_layer_profiles(get_config(arch), tokens)
            theirs = RW.derive_layer_profiles(ref_get_config(arch), tokens)
            assert [dataclasses.astuple(x) for x in mine] == [
                dataclasses.astuple(x) for x in theirs]

    @pytest.mark.parametrize("reduced", [False, True])
    @pytest.mark.parametrize("arch", RW.ZOO_ARCHS)
    def test_config_counts(self, arch, reduced):
        got, ref = get_config(arch, reduced), ref_get_config(arch, reduced)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
        for padded in (False, True):
            assert got.param_count(padded) == ref.param_count(padded)
            for i in range(got.n_layers):
                for active in (False, True):
                    assert got._layer_params(i, padded, active) == ref._layer_params(
                        i, padded, active), (i, padded, active)
        assert got.moe_d_ff_ == ref.moe_d_ff_
        assert [got.is_moe_layer(i) for i in range(got.n_layers)] == [
            ref.is_moe_layer(i) for i in range(got.n_layers)]
        if got.family != "ssm":
            assert got._enc_layer_params(False) == ref._enc_layer_params(False)

    def test_layer_mismatch_rejected(self):
        with pytest.raises(ValueError, match="align"):
            dataclasses.replace(PW.zoo_profiles()["llama32_1b"], layer_t_b=(1.0,))


def _assert_planes(got, ref):
    assert got.keys() == ref.keys()
    for k, v in got.items():
        r = np.asarray(ref[k])
        assert v.numpy().dtype == r.dtype, k
        np.testing.assert_array_equal(v.numpy(), r, err_msg=k)


class TestTracePlanes:
    @pytest.mark.parametrize("fusion", ["none", 16e6, 64e6])
    @pytest.mark.parametrize("name", ["model_zoo", "fusion_sweep", "smoke"])
    def test_trace_from_jobs(self, name, fusion):
        for seed in range(3):
            ref = jaxsim.trace_from_jobs(R.get_scenario(name, seed=seed).job_list(), fusion=fusion)
            got = fluidsim.trace_from_jobs(P.get_scenario(name, seed=seed).job_list(),
                                           fusion=fusion, device="cpu")
            _assert_planes(got, ref)

    def test_stack_traces_mixed_lanes(self):
        """Ragged lanes: zoo jobs at 16 MB and per-layer buckets, a
        monolithic lane with no planes (it gets (J, 1) ones), padded on
        both axes."""
        specs = [("model_zoo", 0, 16e6, 9), ("paper", 1, "all", 14), ("model_zoo", 2, "none", 5),
                 ("fusion_sweep", 3, 64e6, 6)]
        ref = jaxsim.stack_traces([
            jaxsim.trace_from_jobs(R.get_scenario(n, seed=s).job_list()[:j], fusion=f)
            for n, s, f, j in specs])
        got = fluidsim.stack_traces([
            fluidsim.trace_from_jobs(P.get_scenario(n, seed=s).job_list()[:j], fusion=f,
                                     device="cpu")
            for n, s, f, j in specs])
        _assert_planes(got, ref)
        assert got["bucket_bytes"].shape[1:] == (14, 49)
        assert got["n_buckets"][1].tolist() == [1] * 14


def _gating_inputs(seed, lanes, n_jobs, n_domains=5):
    rng = np.random.default_rng(seed)
    loads = rng.random((lanes, n_jobs, n_domains)) < 0.4
    active = rng.random((lanes, n_jobs)) < 0.5
    rem = rng.choice(np.float32([0.0, 0.5, 1.25, 3.0]), (lanes, n_jobs))
    rem = np.where(rng.random((lanes, n_jobs)) < 0.5, rem,
                   rng.uniform(0.01, 5.0, (lanes, n_jobs))).astype(np.float32)
    return {
        "r1": rng.random((lanes, n_jobs)) < 0.5,
        "priority": rng.choice(np.float32([1.0, 2.0, 4.5]), (lanes, n_jobs)),
        "loads": loads,
        "counts": (loads & active[..., None]).sum(-2).astype(np.int32),
        "overlap": np.einsum("ljd,lkd->ljk", loads.astype(np.float32),
                             loads.astype(np.float32)) > 0,
        "active": active,
        "rem": rem,
        "new_cost": np.where(rng.random((lanes, n_jobs)) < 0.3, rem,
                             rng.uniform(0.01, 5.0, (lanes, n_jobs))).astype(np.float32),
    }


ARGS = ("r1", "priority", "loads", "counts", "overlap", "active", "rem", "new_cost")
PARAMS = ContentionParams()


class TestGatingParity:
    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("n_jobs", [1, 7, 33])
    @pytest.mark.parametrize("policy", ["ada", "srsf1", "srsf2", "kway2", "kway3"])
    def test_gating_fixed_point(self, policy, n_jobs, seed):
        spec = netmodel.parse_policy(policy)
        x = _gating_inputs(seed * 100 + n_jobs, 4, n_jobs)
        e = PARAMS.eta / PARAMS.b
        got = netmodel.gating_fixed_point(
            *(torch.from_numpy(x[k]) for k in ARGS), spec.max_ways, spec.threshold_gated,
            PARAMS.dual_threshold, exact_kway=spec.exact_lookahead, eta_over_b=e,
            not_eye=~torch.eye(n_jobs, dtype=torch.bool), job_index=torch.arange(n_jobs),
        ).numpy()
        for lane in range(4):
            ref = ref_nm.gating_fixed_point(
                *(jnp.asarray(x[k][lane]) for k in ARGS),
                jnp.asarray(spec.max_ways, jnp.float32), jnp.asarray(spec.threshold_gated),
                PARAMS.dual_threshold, exact_kway=spec.exact_lookahead, eta_over_b=e,
            )
            np.testing.assert_array_equal(got[lane], np.asarray(ref), err_msg=f"lane {lane}")
        assert got.dtype == bool

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("n_jobs", [1, 7, 33])
    @pytest.mark.parametrize("max_ways", [1, 2, 3, 9])
    def test_kway_exact_start(self, max_ways, n_jobs, seed):
        x = _gating_inputs(seed * 1000 + n_jobs + max_ways, 4, n_jobs)
        olds = x["overlap"] & x["active"][:, None, :] & ~np.eye(n_jobs, dtype=bool)
        e = PARAMS.eta / PARAMS.b
        got = netmodel.kway_exact_start(torch.from_numpy(x["new_cost"]),
                                        torch.from_numpy(x["rem"]), torch.from_numpy(olds),
                                        max_ways, e).numpy()
        via = netmodel.may_start_dynamic(None, torch.from_numpy(x["new_cost"]), None, max_ways,
                                         True, 0.0, exact_kway_olds=torch.from_numpy(olds),
                                         rem=torch.from_numpy(x["rem"]), eta_over_b=e).numpy()
        np.testing.assert_array_equal(got, via)
        for lane in range(4):
            ref = ref_nm.kway_exact_start(jnp.asarray(x["new_cost"][lane]),
                                          jnp.asarray(x["rem"][lane]), jnp.asarray(olds[lane]),
                                          jnp.asarray(max_ways, jnp.float32), e)
            np.testing.assert_array_equal(got[lane], np.asarray(ref), err_msg=f"lane {lane}")

    def test_pairwise_min(self):
        rng = np.random.default_rng(5)
        x = rng.uniform(-3, 3, (4, 9)).astype(np.float32)
        got = netmodel._pairwise_min(torch.from_numpy(x)[..., :, None],
                                     torch.from_numpy(x)[..., None, :]).numpy()
        ref = np.stack([np.asarray(ref_nm._pairwise_min(jnp.asarray(r)[:, None],
                                                        jnp.asarray(r)[None, :])) for r in x])
        np.testing.assert_array_equal(got, ref)


#: a model_zoo cut small enough for ``skip=False`` runs of seconds
SMALL_ZOO = dict(n_jobs=8, min_iters=3, max_iters=8, horizon_s=60.0)


class TestFixedPointEqualsRounds:
    @pytest.mark.parametrize("fusion", ["none", 16e6])
    @pytest.mark.parametrize("comm", ["ada", "srsf2", "kway2"])
    def test_bit_exact_on_fusion_policy_grid(self, comm, fusion):
        scns = [P.get_scenario("model_zoo", seed=s, **SMALL_ZOO) for s in (0, 1)]
        batch = fluidsim.stack_traces(
            [fluidsim.trace_from_jobs(s.job_list(), fusion=fusion, device="cpu") for s in scns])
        out = {}
        for gating in ("fixedpoint", "rounds"):
            cfg = P.fluid_config(scns[0], comm=comm, device="cpu", gating=gating, skip=False)
            out[gating] = fluidsim.simulate_traces_batched(batch, cfg)
        fp, rounds = out["fixedpoint"], out["rounds"]
        for k in ("finished", "jct", "makespan"):
            np.testing.assert_array_equal(fp[k], rounds[k], err_msg=k)
        assert fp["chunks"] == rounds["chunks"]
        assert fp["finished"].sum() == sum(s.n_jobs for s in scns)
        assert fp["bucket_widths"][0] > 1
