"""The Fig. 2 calibration helpers of the port's ``core/contention.py``
(``fit_linear_cost``, ``fit_contention_penalty``,
``simulate_contention_sweep``) and ``ContentionParams.mean_bandwidth_scale``
against the JAX package's: float64 numpy with the same calls, so the
outputs are equal, on the reference test's inputs and on noisy ones made
from a seed.  The reference's recovery checks hold on the port's fits.
"""

import numpy as np
import pytest

import repro.core.contention as RCON
import repro_torch.core.contention as PCON


def _noisy_linear(seed, n=24):
    rng = np.random.default_rng(seed)
    ms = np.sort(rng.uniform(1e4, 6e8, size=n))
    ts = PCON.PAPER_A + PCON.PAPER_B * ms
    return ms, ts * (1.0 + rng.normal(0.0, 0.02, size=n))


class TestLinearFit:
    def test_recovers_paper_constants(self):
        ms = np.linspace(1e6, 5e8, 20)
        ts = PCON.PAPER_A + PCON.PAPER_B * ms
        a, b = PCON.fit_linear_cost(ms, ts)
        assert a == pytest.approx(PCON.PAPER_A, rel=1e-6)
        assert b == pytest.approx(PCON.PAPER_B, rel=1e-6)
        assert (a, b) == RCON.fit_linear_cost(ms, ts)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_equals_reference(self, seed):
        ms, ts = _noisy_linear(seed)
        got = PCON.fit_linear_cost(ms, ts)
        assert got == RCON.fit_linear_cost(ms, ts)
        assert all(isinstance(x, float) for x in got)
        # lists and float32 inputs go through float64 on both sides
        assert PCON.fit_linear_cost(list(ms), list(ts)) == got
        m32, t32 = ms.astype(np.float32), ts.astype(np.float32)
        assert PCON.fit_linear_cost(m32, t32) == RCON.fit_linear_cost(m32, t32)


class TestContentionSweep:
    @pytest.mark.parametrize("eta", [0.0, 1.706e-10, 4e-10])
    @pytest.mark.parametrize("max_k", [1, 4, 8])
    def test_sweep_equals_reference(self, eta, max_k):
        got = PCON.simulate_contention_sweep(PCON.ContentionParams(eta=eta), 3e8, max_k)
        ref = RCON.simulate_contention_sweep(RCON.ContentionParams(eta=eta), 3e8, max_k)
        assert got.dtype == ref.dtype and got.shape == (max_k,)
        np.testing.assert_array_equal(got, ref)

    def test_eta_fit_recovers_truth(self):
        truth = PCON.ContentionParams(eta=0.3 * PCON.PAPER_B)
        m = 1e8
        ks = np.arange(1, 9)
        times = PCON.simulate_contention_sweep(truth, m, 8)
        eta = PCON.fit_contention_penalty(ks, times, m, truth.a, truth.b)
        assert eta == pytest.approx(truth.eta, rel=1e-6)
        assert eta == RCON.fit_contention_penalty(ks, times, m, truth.a, truth.b)

    @pytest.mark.parametrize("seed", [0, 5])
    def test_eta_fit_equals_reference(self, seed):
        rng = np.random.default_rng(seed)
        ks = np.arange(1, 11)
        m = 2.5e8
        times = RCON.simulate_contention_sweep(RCON.ContentionParams(), m, 10)
        times = times * (1.0 + rng.normal(0.0, 0.01, size=10))
        got = PCON.fit_contention_penalty(ks, times, m, PCON.PAPER_A, PCON.PAPER_B)
        assert got == RCON.fit_contention_penalty(ks, times, m, RCON.PAPER_A, RCON.PAPER_B)
        assert got >= 0.0

    def test_degenerate_inputs(self):
        # no k > 1: nothing to fit; a negative estimate clamps to 0
        assert PCON.fit_contention_penalty([1, 1], [1.0, 1.0], 1e8, 0.0, 1e-9) == 0.0
        ks = np.array([1.0, 2.0, 3.0])
        low = np.array([0.1, 0.15, 0.2])
        assert PCON.fit_contention_penalty(ks, low, 1e8, 0.0, 1e-9) == 0.0
        assert RCON.fit_contention_penalty(ks, low, 1e8, 0.0, 1e-9) == 0.0


class TestMeanBandwidthScale:
    @pytest.mark.parametrize("bw, n", [((), 16), ((0.5, 0.5), 4), ((0.5, 0.5), 2),
                                       ((0.25, 1.0, 0.75), 3), ((0.5,), 0), ((0.5,), -3),
                                       ((0.9, 0.3, 0.6, 0.2, 1.0), 7)])
    def test_equals_reference(self, bw, n):
        got = PCON.ContentionParams(server_bandwidth=bw).mean_bandwidth_scale(n)
        ref = RCON.ContentionParams(server_bandwidth=bw).mean_bandwidth_scale(n)
        assert got == ref

    def test_pads_with_nominal(self):
        p = PCON.ContentionParams(server_bandwidth=(0.5, 0.5))
        assert p.mean_bandwidth_scale(4) == pytest.approx((0.5 + 0.5 + 1 + 1) / 4)
        assert p.mean_bandwidth_scale(0) == 1.0
