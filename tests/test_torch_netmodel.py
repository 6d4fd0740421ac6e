"""The port's policy/network layer and copied constants against the JAX
reference (``repro.core.netmodel`` and friends).

Inputs are made with numpy from a seed and handed to both sides; the
reference runs op by op on the CPU.  Bars: bool and int outputs exact;
float32 outputs exact too, since each torch function performs the
reference's operations in its order (``rtol=0`` is stated below).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import netmodel as ref_nm
from repro.core import contention as ref_contention
from repro.core import topology as ref_topology
from repro.core import trace as ref_trace
from repro.core.cluster import TABLE_III as REF_TABLE_III
from repro_torch.core import contention, netmodel, topology, trace
from repro_torch.core.cluster import TABLE_III

torch.set_num_threads(1)

P = contention.ContentionParams()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Copied constants and plain-Python helpers
# ---------------------------------------------------------------------------


class TestCopiedConstants:
    def test_table_iii(self):
        assert TABLE_III.keys() == REF_TABLE_III.keys()
        for name, m in TABLE_III.items():
            r = REF_TABLE_III[name]
            for f in dataclasses.fields(m):
                assert getattr(m, f.name) == getattr(r, f.name), (name, f.name)
            assert m.t_iter_compute == r.t_iter_compute

    def test_contention_params(self):
        r = ref_contention.ContentionParams()
        assert (P.a, P.b, P.eta, P.server_bandwidth) == (r.a, r.b, r.eta, r.server_bandwidth)
        assert P.dual_threshold == r.dual_threshold
        assert (contention.PAPER_A, contention.PAPER_B, contention.DEFAULT_ETA) == (
            ref_contention.PAPER_A, ref_contention.PAPER_B, ref_contention.DEFAULT_ETA,
        )
        bw = (0.4, 1.0, 0.7)
        assert contention.ContentionParams(server_bandwidth=bw).dual_threshold == (
            ref_contention.ContentionParams(server_bandwidth=bw).dual_threshold
        )

    def test_gpu_distribution(self):
        assert trace.PAPER_GPU_DISTRIBUTION == ref_trace.PAPER_GPU_DISTRIBUTION

    @pytest.mark.parametrize(
        "make",
        [
            lambda m: m.nic_topology(16),
            lambda m: m.two_tier(16, 4, 3.0),
            lambda m: m.two_tier(16, 3, 2.5),
            lambda m: m.uplink_only(16, 4, 3.0),
            lambda m: m.nic_topology(4),
        ],
        ids=["nic16", "two_tier16x4", "two_tier16x3", "uplink_only16x4", "nic4"],
    )
    def test_topology_matrices(self, make):
        mine, ref = make(topology), make(ref_topology)
        assert mine.name == ref.name and mine.n_domains == ref.n_domains
        np.testing.assert_array_equal(mine.incidence(), ref.incidence())
        np.testing.assert_array_equal(mine.oversub_array(), ref.oversub_array())
        np.testing.assert_array_equal(mine.server_rack(), ref.server_rack())
        assert mine.rack_groups() == ref.rack_groups()

    def test_parse_policy(self):
        for name in ("ada", "srsf1", "srsf2", "srsf3", "kway2", "kway3"):
            assert dataclasses.astuple(netmodel.parse_policy(name)) == dataclasses.astuple(
                ref_nm.parse_policy(name)
            )
        for bad in ("", "srsf0", "kway1", "lwf", "adadual"):
            with pytest.raises(ValueError, match="unknown comm policy"):
                netmodel.parse_policy(bad)

    def test_canonical_placement(self):
        assert netmodel.FLUID_PLACEMENT_ALIASES == ref_nm.FLUID_PLACEMENT_ALIASES
        for name in ref_nm.FLUID_PLACEMENT_ALIASES:
            assert netmodel.canonical_placement(name.upper()) == ref_nm.canonical_placement(name)
        with pytest.raises(ValueError, match="fluid backend supports"):
            netmodel.canonical_placement("nope")

    @pytest.mark.parametrize(
        "bw, n", [((), 4), ((0.5, 2.0), 4), ((0.5, 2.0, 3.0), 2), ((0.5,), 0)]
    )
    def test_server_bandwidth_array(self, bw, n):
        np.testing.assert_array_equal(
            netmodel.server_bandwidth_array(bw, n), ref_nm.server_bandwidth_array(bw, n)
        )

    @pytest.mark.parametrize("spec", ["all", "ALL", "none", 0, 32e6])
    def test_fusion_threshold(self, spec):
        assert netmodel.fusion_threshold(spec) == ref_nm.fusion_threshold(spec)


# ---------------------------------------------------------------------------
# Array functions, torch vs jnp
# ---------------------------------------------------------------------------


def _rand_state(seed, lanes=3, n_jobs=11, n_servers=6, n_domains=9):
    rng = np.random.default_rng(seed)
    return {
        "loads": rng.random((lanes, n_jobs, n_domains)) < 0.35,
        "active": rng.random((lanes, n_jobs)) < 0.5,
        "member": rng.random((lanes, n_jobs, n_servers)) < 0.4,
        "oversub": rng.uniform(1.0, 4.0, n_domains).astype(np.float32),
        "bw": rng.uniform(0.4, 2.5, n_servers).astype(np.float32),
        "k": (rng.integers(1, 6, (lanes, n_jobs))
              * rng.uniform(1.0, 3.0, (lanes, n_jobs))).astype(np.float32),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
class TestArrayFunctions:
    def test_rate_ratio(self, seed):
        k = _rand_state(seed)["k"]
        for b, eta in ((P.b, P.eta), (7e-10, 3e-10)):
            got = netmodel.rate_ratio(_t(k), b, eta).numpy()
            want = _np(ref_nm.rate_ratio(jnp.asarray(k), b, eta))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0)

    def test_domain_counts_and_k(self, seed):
        s = _rand_state(seed)
        counts = netmodel.domain_counts(_t(s["loads"]), _t(s["active"]))
        assert counts.dtype == torch.int32
        weighted = counts.to(torch.float32) * _t(s["oversub"])
        k_eff = netmodel.domain_k(_t(s["loads"]), weighted).numpy()
        k_would = netmodel.domain_k(_t(s["loads"]), counts, extra=1).numpy()
        assert k_would.dtype == np.int32
        for lane in range(s["loads"].shape[0]):
            loads, active = jnp.asarray(s["loads"][lane]), jnp.asarray(s["active"][lane])
            rc = ref_nm.domain_counts(loads, active)
            np.testing.assert_array_equal(counts[lane].numpy(), _np(rc))
            rk = ref_nm.domain_k(loads, rc.astype(jnp.float32) * jnp.asarray(s["oversub"]))
            np.testing.assert_allclose(k_eff[lane], _np(rk), rtol=0)
            np.testing.assert_array_equal(k_would[lane], _np(ref_nm.domain_k(loads, rc, extra=1)))

    def test_slowest_member_scale(self, seed):
        s = _rand_state(seed)
        s["member"][:, 0] = False  # memberless rows -> 1.0
        got = netmodel.slowest_member_scale(_t(s["bw"]), _t(s["member"])).numpy()
        for lane in range(s["member"].shape[0]):
            want = ref_nm.slowest_member_scale(jnp.asarray(s["bw"]), jnp.asarray(s["member"][lane]))
            np.testing.assert_allclose(got[lane], _np(want), rtol=0)
        assert (got[:, 0] == 1.0).all()

    def test_may_start_dynamic(self, seed):
        rng = np.random.default_rng(seed)
        k_would = rng.integers(1, 5, (2, 200)).astype(np.int32)
        new_cost = rng.uniform(0.0, 0.5, (2, 200)).astype(np.float32)
        min_old = np.where(
            rng.random((2, 200)) < 0.2, np.inf, rng.uniform(0, 0.5, (2, 200))
        ).astype(np.float32)
        for max_ways in (1, 2, 3):
            for gated in (False, True):
                want = ref_nm.may_start_dynamic(
                    jnp.asarray(k_would), jnp.asarray(new_cost), jnp.asarray(min_old),
                    jnp.asarray(max_ways, jnp.float32), jnp.asarray(gated), P.dual_threshold,
                )
                for g in (gated, torch.tensor(gated)):
                    got = netmodel.may_start_dynamic(
                        _t(k_would), _t(new_cost), _t(min_old), max_ways, g, P.dual_threshold
                    )
                    np.testing.assert_array_equal(got.numpy(), _np(want))

    def test_rack_pack_and_placement_rank(self, seed):
        rng = np.random.default_rng(seed)
        topo = ref_topology.two_tier(16, 4, 3.0)
        free = rng.integers(0, 5, (3, 16)).astype(np.float32)
        load = rng.uniform(0, 1e4, (3, 16)).astype(np.float32)
        rack = topo.server_rack()
        n_racks = len(topo.rack_groups())
        rp = netmodel.rack_pack_rank(_t(free), _t(rack), n_racks, 4)
        index = torch.arange(16, dtype=torch.float32)
        for lane in range(3):
            want_rp = ref_nm.rack_pack_rank(jnp.asarray(free[lane]), jnp.asarray(rack), n_racks, 4)
            np.testing.assert_array_equal(rp[lane].numpy(), _np(want_rp))
            for mode in ("consolidate", "first_fit", "least_loaded", "rack_pack"):
                got = netmodel.placement_rank(mode, _t(free), _t(load), index, rp)[lane]
                want = ref_nm.placement_rank(
                    mode, jnp.asarray(free[lane]), jnp.asarray(load[lane]),
                    jnp.arange(16, dtype=jnp.float32), want_rp,
                )
                np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=mode)


# ---------------------------------------------------------------------------
# The reference's own netmodel cases, on the port
# ---------------------------------------------------------------------------


class TestReferenceCases:
    def test_ratio_is_one_uncontended(self):
        assert netmodel.rate_ratio(torch.ones(1), P.b, P.eta).item() == 1.0

    def test_ratio_decreases_with_k(self):
        out = netmodel.rate_ratio(torch.tensor([1.0, 2.0, 4.0]), P.b, P.eta)
        assert (out.diff() < 0).all()

    @pytest.mark.parametrize("servers", [{0}, {1}, {0, 2}, {2, 3}, {1, 3}, set()])
    def test_slowest_member_matches_reference(self, servers):
        bw = ref_nm.server_bandwidth_array((0.4, 1.0, 0.7), 4).astype(np.float32)
        mask = np.zeros(4, dtype=bool)
        mask[list(servers)] = True
        got = netmodel.slowest_member_scale(_t(bw), _t(mask)).item()
        assert got == float(ref_nm.slowest_member_scale(bw, mask))

    def test_vectorized_mask(self):
        out = netmodel.may_start_dynamic(
            torch.tensor([1, 2, 2, 3]), torch.ones(4),
            torch.tensor([math.inf, 10.0, 1.0, 10.0]), 2, True, 0.4,
        )
        assert out.tolist() == [True, True, False, False]

    def test_srsf_cap(self):
        for n in (1, 2, 3):
            for max_conc in range(5):
                got = netmodel.may_start_dynamic(
                    torch.tensor([max_conc + 1]), torch.zeros(1),
                    torch.tensor([math.inf]), n, False, 0.0,
                )
                assert bool(got) == (max_conc < n), (n, max_conc)

    def test_placement_rank_needs_extra_for_rack_pack(self):
        free = torch.ones(4)
        with pytest.raises(ValueError, match="rank_extra"):
            netmodel.placement_rank("rack_pack", free, free, torch.arange(4.0))
        with pytest.raises(ValueError, match="unknown placement mode"):
            netmodel.placement_rank("nope", free, free, torch.arange(4.0))


class TestNotPorted:
    def test_raise_not_implemented(self):
        """Nothing is left out: the ``random`` placement ranks by the
        caller's draw (and, like ``rack_pack``, raises without one); the
        gating closure and the exact k-way lookahead run (held to the
        reference in ``test_torch_wfbp.py``)."""
        draw = torch.tensor([0.7, 0.1, 0.4, 0.9])
        assert torch.equal(netmodel.placement_rank("random", torch.ones(4), torch.ones(4),
                                                   torch.arange(4.0), draw), draw)
        with pytest.raises(ValueError, match="rank_extra"):
            netmodel.placement_rank("random", torch.ones(4), torch.ones(4), torch.arange(4.0))
        olds = torch.ones(2, 2, dtype=torch.bool)
        got = netmodel.may_start_dynamic(
            torch.ones(2), torch.ones(2), torch.ones(2), 2, True, 0.4,
            exact_kway_olds=olds, rem=torch.ones(2), eta_over_b=0.2,
        )
        assert torch.equal(got, netmodel.kway_exact_start(torch.ones(2), torch.ones(2), olds,
                                                          2, 0.2))
