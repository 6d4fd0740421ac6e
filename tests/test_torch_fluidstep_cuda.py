"""The CUDA fluid step kernel against the port's plain PyTorch version, on
the card.  CUDA C++ has no CPU mode, so these tests skip where there is no
CUDA device.  The file imports no JAX (the card's machine has none), so it
runs there without the repository's conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_fluidstep_cuda.py

Inputs are made with numpy from a seed.  Bar: every output plane
bit-equal to the plain version (same operations in the same order, no
contracted multiply-adds), int and bool planes exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fluidstep import fluid_step_core
from repro_torch.kernels.fluidstep.kernel import MAX_DOMAINS, fluid_step_core_cuda

B, ETA = 8.53e-10, 1.706e-10
NAMES = ("loads", "member", "active", "rem", "bw", "oversub")


def _rand_inputs(seed, lanes, n_jobs, n_servers, n_domains):
    rng = np.random.default_rng(seed)
    return {
        "loads": rng.random((lanes, n_jobs, n_domains)) < 0.35,
        "member": (rng.random((lanes, n_jobs, n_servers)) < 0.4).astype(np.float32),
        "active": rng.random((lanes, n_jobs)) < 0.5,
        "rem": rng.uniform(0.05, 80.0, (lanes, n_jobs)).astype(np.float32),
        "bw": rng.uniform(0.4, 2.5, n_servers).astype(np.float32),
        "oversub": rng.uniform(1.0, 4.0, n_domains).astype(np.float32),
    }


def _run(x, device, **kw):
    out = fluid_step_core(*[torch.as_tensor(x[k]).to(device) for k in NAMES],
                          b=B, eta=ETA, **kw)
    return {k: (None if v is None else v.cpu().numpy()) for k, v in out.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fluid step kernel is CUDA C++ "
                    "and has no CPU mode (run `pytest -m cuda` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize("n_jobs", [8, 40, 160, 256])
    @pytest.mark.parametrize("n_domains", [16, 20, MAX_DOMAINS])
    @pytest.mark.parametrize("lanes", [1, 8])
    @pytest.mark.parametrize("need_overlap", [False, True])
    def test_kernel_matches_plain(self, cuda_device, n_jobs, n_domains, lanes, need_overlap):
        x = _rand_inputs(n_jobs + n_domains + lanes, lanes, n_jobs, 16, n_domains)
        launches = fluid_step_core_cuda.launches
        got = _run(x, cuda_device, need_overlap=need_overlap, impl="cuda")
        torch.cuda.synchronize()
        assert fluid_step_core_cuda.launches == launches + 1
        plain = _run(x, cuda_device, need_overlap=need_overlap, impl="ref")
        for k, v in plain.items():
            if v is None:
                assert got[k] is None
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)  # bit-equal

    def test_kernel_rejects_what_it_does_not_take(self, cuda_device):
        x = _rand_inputs(0, 2, 12, 6, MAX_DOMAINS + 1)
        with pytest.raises(ValueError, match="domains"):
            _run(x, cuda_device, impl="cuda")
        x = _rand_inputs(0, 2, 12, 6, 9)
        x["rem"] = x["rem"].astype(np.float64)
        with pytest.raises(ValueError, match="dtype"):
            _run(x, cuda_device, impl="cuda")
