"""The CUDA SSD decode-step kernel against the port's plain PyTorch version,
on the card.  CUDA C++ has no CPU mode, so these tests skip where there is
no CUDA device.  The file imports no JAX (the card's machine has none), so
it runs there without the repository's conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_ssd_cuda.py

Inputs are made with numpy from a seed.  Bars (those of the JAX suite for
its Pallas kernel against ``ref.py``, ``tests/test_kernels.py``): ``y``
within ``3 * tol_for(dtype)`` (the kernel rounds ``y + D*x`` once in
float32, the plain version rounds ``y`` to the working dtype first, and
the kernel may contract multiply-adds), the float32 state at
``atol=rtol=1e-4``.  The update in place (``out=state``) is bit-equal to
the out-of-place call: the kernel computes each element with the same
expression either way.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ssd_decode_step
from repro_torch.kernels.ssd.kernel import empty_launch, rows_per_cta, ssd_decode_step_cuda

#: tests/test_kernels.py's sweep, the serve shapes (B 8 and 64 at
#: mamba2-130m's H 24, P 64, N 128), N = 30 (the scalar path), and P that
#: is not a multiple of the main path's rows per CTA (16 at N 128, 32 at
#: N 64): the last CTA of each (b, h) block takes fewer rows
SHAPES = [(2, 8, 64, 128), (2, 6, 16, 32), (3, 12, 32, 64), (1, 24, 64, 128),
          (8, 24, 64, 128), (64, 24, 64, 128), (2, 4, 16, 30), (2, 4, 24, 128),
          (3, 5, 40, 128), (2, 3, 40, 64)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ORDER = ("x", "dt", "a", "b", "c", "d", "state")


def tol_for(name):
    return 3e-2 if name == "bfloat16" else 2e-5


def make_inputs(seed, b, h, p, n, dtype, device):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    raw = {
        "x": rng.standard_normal((b, h, p)).astype(f32),
        "dt": np.logaddexp(rng.standard_normal((b, h)), 0.0).astype(f32),
        "a": (-np.exp(rng.standard_normal(h) * 0.1)).astype(f32),
        "b": rng.standard_normal((b, n)).astype(f32),
        "c": rng.standard_normal((b, n)).astype(f32),
        "d": rng.uniform(0.5, 1.5, h).astype(f32),
        "state": rng.standard_normal((b, h, p, n)).astype(f32),
    }
    low = ("x", "dt", "b", "c")
    return {k: torch.from_numpy(v).to(device=device, dtype=dtype if k in low else torch.float32)
            for k, v in raw.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD decode-step kernel is CUDA C++ "
                    "and has no CPU mode (run `pytest -m cuda` on the card)")
    # the plain version's float32 contraction runs in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _compare(got, plain, name):
    tol = 3 * tol_for(name)
    np.testing.assert_allclose(got[0].float().cpu().numpy(), plain[0].float().cpu().numpy(),
                               atol=tol, rtol=tol, err_msg="y")
    np.testing.assert_allclose(got[1].cpu().numpy(), plain[1].cpu().numpy(),
                               atol=1e-4, rtol=1e-4, err_msg="state")


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("b,h,p,n", SHAPES)
    def test_kernel_matches_plain(self, cuda_device, b, h, p, n, name):
        t = make_inputs(b * 1000 + n, b, h, p, n, DTYPES[name], cuda_device)
        state_in = t["state"].clone()
        launches = ssd_decode_step_cuda.launches
        y, s = ssd_decode_step(*(t[k] for k in ORDER))
        torch.cuda.synchronize()
        assert ssd_decode_step_cuda.launches == launches + 1, "one launch per call"
        assert y.dtype == DTYPES[name] and s.dtype == torch.float32
        assert tuple(y.shape) == (b, h, p) and tuple(s.shape) == (b, h, p, n)
        assert torch.equal(t["state"], state_in), "the state is updated out of place"
        plain = ssd_decode_step(*(t[k] for k in ORDER), impl="ref")
        assert ssd_decode_step_cuda.launches == launches + 1
        _compare((y, s), plain, name)

    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("b,h,p,n", SHAPES)
    def test_in_place_equals_out_of_place(self, cuda_device, b, h, p, n, name):
        t = make_inputs(b * 1000 + n + 1, b, h, p, n, DTYPES[name], cuda_device)
        y, s = ssd_decode_step(*(t[k] for k in ORDER))
        state = t["state"].clone()
        launches = ssd_decode_step_cuda.launches
        y_in, s_in = ssd_decode_step(*(t[k] for k in ORDER[:-1]), state, out=state)
        torch.cuda.synchronize()
        assert ssd_decode_step_cuda.launches == launches + 1
        assert s_in is state, "the new state is written into the given tensor"
        assert torch.equal(y_in, y) and torch.equal(s_in, s), "in place == out of place, bit for bit"
        plain_state = t["state"].clone()
        plain = ssd_decode_step(*(t[k] for k in ORDER[:-1]), plain_state, impl="ref",
                                out=plain_state)
        assert plain[1] is plain_state
        _compare((y_in, s_in), plain, name)

    def test_unaligned_state_takes_scalar_path(self, cuda_device):
        t = make_inputs(5, 2, 8, 64, 128, torch.float32, cuda_device)
        flat = torch.empty(t["state"].numel() + 1, dtype=torch.float32, device=cuda_device)
        flat[1:] = t["state"].reshape(-1)
        t["state"] = flat[1:].view(t["state"].shape)  # 4-byte aligned only
        got = ssd_decode_step(*(t[k] for k in ORDER))
        _compare(got, ssd_decode_step(*(t[k] for k in ORDER), impl="ref"), "float32")

    def test_unaligned_state_in_place(self, cuda_device):
        t = make_inputs(6, 2, 8, 64, 128, torch.float32, cuda_device)
        flat = torch.empty(t["state"].numel() + 1, dtype=torch.float32, device=cuda_device)
        flat[1:] = t["state"].reshape(-1)
        t["state"] = flat[1:].view(t["state"].shape)  # 4-byte aligned only
        want = ssd_decode_step(*(t[k] for k in ORDER), impl="ref")
        got = ssd_decode_step(*(t[k] for k in ORDER), out=t["state"])
        torch.cuda.synchronize()
        assert got[1] is t["state"]
        _compare(got, want, "float32")

    def test_empty_launch_is_not_counted(self, cuda_device):
        launches = ssd_decode_step_cuda.launches
        empty_launch(8, 24, 64, 128, cuda_device)
        torch.cuda.synchronize()
        assert ssd_decode_step_cuda.launches == launches
        assert rows_per_cta(128, 64) == 16 and rows_per_cta(30, 16) == 16

    def test_kernel_rejects_what_it_does_not_take(self, cuda_device):
        t = make_inputs(0, 2, 6, 16, 32, torch.float32, cuda_device)
        bad = dict(t, state=t["state"].double())
        with pytest.raises(ValueError, match="dtype"):
            ssd_decode_step(*(bad[k] for k in ORDER))
        bad = dict(t, b=t["b"].to(torch.bfloat16))
        with pytest.raises(ValueError, match="dtype"):
            ssd_decode_step(*(bad[k] for k in ORDER))
        bad = dict(t, state=t["state"].transpose(2, 3).contiguous().transpose(2, 3))
        with pytest.raises(ValueError, match="contiguous"):
            ssd_decode_step(*(bad[k] for k in ORDER))
        bad = dict(t, c=t["c"].cpu())
        with pytest.raises(ValueError, match="cpu"):
            ssd_decode_step(*(bad[k] for k in ORDER))
        flat = torch.zeros(2 * t["state"].numel(), dtype=torch.float32, device=cuda_device)
        flat[:t["state"].numel()] = t["state"].reshape(-1)
        state = flat[:t["state"].numel()].view(t["state"].shape)
        shifted = flat[4:4 + t["state"].numel()].view(t["state"].shape)
        with pytest.raises(ValueError, match="overlap"):
            ssd_decode_step(*(t[k] for k in ORDER[:-1]), state, out=shifted)
        with pytest.raises(ValueError, match="dtype"):
            ssd_decode_step(*(t[k] for k in ORDER), out=t["state"].double())
