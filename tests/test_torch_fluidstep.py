"""The port's fluid step core against the JAX reference
(``repro.kernels.fluidstep``: its lax ``ref`` and the Pallas kernel in
``interpret`` mode).

Inputs are made with numpy from a seed, in the style of
``tests/test_fluidstep_kernel.py::_rand_inputs``, and handed to both sides;
the reference is called once per lane, the port once for all lanes.  Bars:
int and bool planes exact, the ``inf`` pattern of ``min_old_rem`` exact,
float32 planes to ``rtol=1e-6`` (expected bit-equal: same operations in the
same order).  The CUDA kernel's own tests are in
``test_torch_fluidstep_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fluidstep import fluid_step_core as ref_fluid_step_core
from repro_torch.kernels.fluidstep import fluid_step_core
from repro_torch.kernels.fluidstep.kernel import fluid_step_core_cuda

torch.set_num_threads(1)

B, ETA = 7e-10, 3e-10
INT_KEYS = ("counts", "k_would")
FLOAT_KEYS = ("k_eff", "ratio")


def _rand_inputs(seed, lanes=1, n_jobs=12, n_servers=6, n_domains=9):
    """Numpy inputs with a lane axis; ``bw``/``oversub`` are shared."""
    rng = np.random.default_rng(seed)
    return {
        "loads": rng.random((lanes, n_jobs, n_domains)) < 0.35,
        "member": (rng.random((lanes, n_jobs, n_servers)) < 0.4).astype(np.float32),
        "active": rng.random((lanes, n_jobs)) < 0.5,
        "rem": rng.uniform(0.05, 80.0, (lanes, n_jobs)).astype(np.float32),
        "bw": rng.uniform(0.4, 2.5, n_servers).astype(np.float32),
        "oversub": rng.uniform(1.0, 4.0, n_domains).astype(np.float32),
    }


def _port(x, device="cpu", **kw):
    args = [torch.as_tensor(x[k]).to(device) for k in
            ("loads", "member", "active", "rem", "bw", "oversub")]
    out = fluid_step_core(*args, b=B, eta=ETA, **kw)
    return {k: (None if v is None else v.cpu().numpy()) for k, v in out.items()}


def _reference(x, lane, impl, need_overlap):
    out = ref_fluid_step_core(
        jnp.asarray(x["loads"][lane]), jnp.asarray(x["member"][lane]),
        jnp.asarray(x["active"][lane]), jnp.asarray(x["rem"][lane]),
        jnp.asarray(x["bw"]), jnp.asarray(x["oversub"]),
        b=B, eta=ETA, need_overlap=need_overlap, impl=impl,
    )
    return {k: (None if v is None else np.asarray(v)) for k, v in out.items()}


def _assert_same(got, want, need_overlap, rtol=1e-6):
    for k in INT_KEYS:
        assert got[k].dtype == want[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in FLOAT_KEYS:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    g, w = got["min_old_rem"], want["min_old_rem"]
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    np.testing.assert_allclose(g[~np.isinf(g)], w[~np.isinf(w)], rtol=rtol)
    if need_overlap:
        assert got["overlap"].dtype == want["overlap"].dtype == np.bool_
        np.testing.assert_array_equal(got["overlap"], want["overlap"])
    else:
        assert got["overlap"] is None


SIZES = {
    "small": dict(n_jobs=12, n_servers=6, n_domains=9),
    "paper_nic": dict(n_jobs=160, n_servers=16, n_domains=16),
    "paper_two_tier": dict(n_jobs=160, n_servers=16, n_domains=20),
}


class TestAgainstReference:
    @pytest.mark.parametrize("size", sorted(SIZES))
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("need_overlap", [False, True])
    def test_matches_lax_ref(self, seed, size, need_overlap):
        x = _rand_inputs(seed, **SIZES[size])
        got = _port(x, need_overlap=need_overlap)
        want = _reference(x, 0, "ref", need_overlap)
        _assert_same({k: (None if v is None else v[0]) for k, v in got.items()}, want,
                     need_overlap)

    @pytest.mark.parametrize("size", ["small", "paper_two_tier"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_pallas_interpret(self, seed, size):
        x = _rand_inputs(seed, **SIZES[size])
        got = _port(x, need_overlap=True)
        want = _reference(x, 0, "interpret", need_overlap=True)
        _assert_same({k: v[0] for k, v in got.items()}, want, True)

    def test_no_active_transfers(self):
        x = _rand_inputs(5)
        x["active"][:] = False
        got = _port(x, need_overlap=True)
        assert int(got["counts"].sum()) == 0
        assert np.isinf(got["min_old_rem"]).all()
        _assert_same({k: v[0] for k, v in got.items()}, _reference(x, 0, "ref", True), True)

    def test_empty_loads_rows(self):
        x = _rand_inputs(6)
        x["loads"][0, 0] = False  # comm-less job: k floors at 1, M_old = inf
        got = _port(x, need_overlap=True)
        assert got["k_eff"][0, 0] == 1.0 and got["k_would"][0, 0] == 1
        assert np.isinf(got["min_old_rem"][0, 0])
        _assert_same({k: v[0] for k, v in got.items()}, _reference(x, 0, "ref", True), True)


class TestLaneBatching:
    @pytest.mark.parametrize("need_overlap", [False, True])
    def test_batched_equals_per_lane(self, need_overlap):
        x = _rand_inputs(11, lanes=5, n_jobs=40, n_servers=16, n_domains=20)
        batched = _port(x, need_overlap=need_overlap)
        for lane in range(5):
            one = {k: (v[lane:lane + 1] if v.ndim > 1 else v) for k, v in x.items()}
            single = _port(one, need_overlap=need_overlap)
            for k, v in single.items():
                if v is None:
                    assert batched[k] is None
                else:
                    np.testing.assert_array_equal(batched[k][lane], v[0], err_msg=k)
            _assert_same({k: (None if v is None else v[lane]) for k, v in batched.items()},
                         _reference(x, lane, "ref", need_overlap), need_overlap)


class TestDispatch:
    def test_cpu_takes_plain_version(self):
        x = _rand_inputs(0)
        launches = fluid_step_core_cuda.launches
        _port(x)
        _port(x, impl="ref")
        assert fluid_step_core_cuda.launches == launches

    def test_cuda_impl_on_cpu_tensors_raises(self):
        with pytest.raises(ValueError, match="CUDA tensors"):
            _port(_rand_inputs(0), impl="cuda")

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown fluid step impl"):
            _port(_rand_inputs(0), impl="interpret")
