"""The CUDA flash-attention kernel against the port's plain PyTorch
version, on the card.  CUDA C++ has no CPU mode, so these tests skip where
there is no CUDA device.  The file imports no JAX (the card's machine has
none), so it runs there without the repository's conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

Inputs are made with numpy from a seed.  Bars: ``tol_for(dtype)`` of the
JAX suite for its Pallas kernel against ``ref.py``
(``tests/test_kernels.py``): 2e-5 in float32 (the same float32 operations,
summed in another order), 3e-2 in bfloat16 (both keep scores and sums in
float32 and round the output once).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

#: (bh, s, t, d, causal): tests/test_kernels.py::TestFlashAttention's sweep
#: (slow cases included), causal with S != T both ways (top-left aligned),
#: the serve shape of llama3.2-1b (batch 8 x 32 heads, prompt 512, head dim
#: 64), a head dim that is not a multiple of 4, a float32 D 256 causal case
#: and a sequence shorter than one key tile.
SHAPES = [
    (4, 256, 256, 64, True),
    (3, 200, 200, 64, True),
    (2, 128, 384, 128, False),
    (1, 64, 512, 256, False),
    (2, 512, 512, 64, True),
    (2, 128, 384, 64, True),
    (2, 384, 128, 64, True),
    (256, 512, 512, 64, True),
    (3, 77, 91, 30, True),
    (2, 200, 200, 256, True),
    (2, 5, 7, 16, True),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol_for(name):
    return 3e-2 if name == "bfloat16" else 2e-5


def make_qkv(seed, bh, s, t, d, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for shape in ((bh, s, d), (bh, t, d), (bh, t, d))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel is CUDA C++ "
                    "and has no CPU mode (run `pytest -m cuda` on the card)")
    # the plain version's float32 contractions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _compare(got, want, name):
    tol = tol_for(name)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("bh,s,t,d,causal", SHAPES)
    def test_kernel_matches_plain(self, cuda_device, bh, s, t, d, causal, name):
        q, k, v = make_qkv(bh * 1000 + s + d, bh, s, t, d, DTYPES[name], cuda_device)
        launches = flash_attention_cuda.launches
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == launches + 1, "one launch per call"
        assert out.dtype == DTYPES[name] and tuple(out.shape) == (bh, s, d)
        plain = flash_attention(q, k, v, causal=causal, impl="ref")
        assert flash_attention_cuda.launches == launches + 1
        _compare(out, plain, name)

    @pytest.mark.parametrize("causal", [False, True])
    def test_scale_override(self, cuda_device, causal):
        q, k, v = make_qkv(7, 1, 128, 128, 64, torch.float32, cuda_device)
        out = flash_attention(q, k, v, causal=causal, scale=0.05)
        _compare(out, flash_attention(q, k, v, causal=causal, scale=0.05, impl="ref"),
                 "float32")

    def test_first_tile_all_masked_is_finite(self, cuda_device):
        """Large scores and a causal mask: rows whose later tiles are all
        masked keep finite, correct outputs (the finite NEG_INF)."""
        q, k, v = make_qkv(9, 2, 96, 96, 32, torch.float32, cuda_device)
        out = flash_attention(q * 30, k * 30, v, causal=True)
        plain = flash_attention(q * 30, k * 30, v, causal=True, impl="ref")
        assert bool(torch.isfinite(out).all())
        _compare(out, plain, "float32")

    def test_kernel_rejects_what_it_does_not_take(self, cuda_device):
        q, k, v = make_qkv(0, 2, 64, 64, 32, torch.float32, cuda_device)
        with pytest.raises(ValueError, match="dtype"):
            flash_attention(q.double(), k.double(), v.double())
        with pytest.raises(ValueError, match="dtype"):
            flash_attention(q, k.to(torch.bfloat16), v)
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
        with pytest.raises(ValueError, match="cpu"):
            flash_attention(q, k.cpu(), v)
        with pytest.raises(ValueError, match="D <= 256"):
            big = torch.zeros((1, 8, 264), device=cuda_device)
            flash_attention(big, big, big)
        with pytest.raises(ValueError, match="shape"):
            flash_attention(q, k[:, :, :16].contiguous(), v)
        with pytest.raises(ValueError, match="unknown"):
            flash_attention(q, k, v, impl="tpu")
