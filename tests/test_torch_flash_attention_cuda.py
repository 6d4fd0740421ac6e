"""The CUDA flash-attention kernel against the port's plain PyTorch
version, on the card.  CUDA C++ has no CPU mode, so these tests skip where
there is no CUDA device.  The file imports no JAX (the card's machine has
none), so it runs there without the repository's conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

Inputs are made with numpy from a seed.  Bars: ``tol_for(dtype)`` of the
JAX suite for its Pallas kernel against ``ref.py``
(``tests/test_kernels.py``): 2e-5 in float32 (the same float32 operations,
summed in another order), 3e-2 in bfloat16 (both keep scores and sums in
float32; the bf16 tensor-core path, every D in bf16, also rounds P to bf16
before the product with V, where ``ref.py`` keeps it in float32).

``tensor_core_emulation`` repeats that path's arithmetic in plain torch;
the bf16 kernel is held to it at 1e-2 (see ``EMULATION_TOL``), and the CPU
tests (``tests/test_torch_flash_attention.py``) hold it to the JAX
reference and the interpret-mode Pallas kernel.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_train
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_reference

#: keys per kv tile of the bf16 tensor-core path (``kTcKeys`` in the source)
TC_BLOCK_K = 64
#: Kernel against the emulation, bf16: both round P to bf16 at the same
#: points, so they differ by float32 summation order and exp2 against exp
#: (which can move one p by one bf16 ulp) and by the output's one rounding,
#: one bf16 ulp, at most 2^-7 of |out|: within 1e-2 + 1e-2 |out|, a third of
#: the 3e-2 bar against the plain version, which does not round P.
EMULATION_TOL = 1e-2
#: (bh, s, t, d, causal) of the peaked regime (ROADMAP R8): q x 8 and k x 16
#: give scores of std 128 at D 64, a softmax that is nearly a hard maximum.
PEAKED = (2, 256, 256, 64, True)


def tensor_core_emulation(q, k, v, *, causal=True, scale=None, round_p=True):
    """Plain-torch emulation of the bf16 tensor-core path's arithmetic:
    float32 scores of the given q and k, an online softmax over kv tiles of
    64 keys (top-left causal mask, the finite NEG_INF), P rounded to bf16
    per tile before the product with V (``round_p``), l summed from the
    unrounded float32 p, float32 accumulation, acc / max(l, 1e-30) rounded
    once to q's dtype.  Tiles above a row's diagonal add p = 0 and
    alpha = 1 exactly, so visiting them equals the kernel's skipping."""
    s, d = q.shape[1], q.shape[2]
    t = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((q.shape[0], s, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((q.shape[0], s, 1), dtype=f32, device=q.device)
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    for k0 in range(0, t, TC_BLOCK_K):
        kt, vt = kf[:, k0:k0 + TC_BLOCK_K], vf[:, k0:k0 + TC_BLOCK_K]
        sc = torch.einsum("bsd,btd->bst", qf, kt) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
            sc = sc.masked_fill(keys > rows, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if round_p:
            p = p.to(torch.bfloat16).to(f32)
        acc = acc * alpha + torch.einsum("bst,btd->bsd", p, vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)

#: (bh, s, t, d, causal): tests/test_kernels.py::TestFlashAttention's sweep
#: (slow cases included), causal with S != T both ways (top-left aligned),
#: the serve shape of llama3.2-1b (batch 8 x 32 heads, prompt 512, head dim
#: 64), a head dim that is not a multiple of 4, a float32 D 256 causal case,
#: a sequence shorter than one key tile, S and T that are not multiples of
#: the tensor-core path's 64-row tiles (both ways) and D 128 causal; then
#: head dim 256 (the tensor-core path's DP-256 instantiation in bf16) with S
#: and T off the tiles and at gemma-7b's prefill shape (batch 8 x 16 heads,
#: prompt 512), and arctic-480b's (batch 8 x 64 padded heads, D 128); then
#: the full mask at the cross and encoder attention's regime: D 128 over
#: the VLM's 1,601 vision tokens (a last key tile of one valid key) and D
#: 64 over 3,000 audio frames (25 * 64 + 1 and 46 * 64 + 56 keys).
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
    (2, 130, 70, 64, True),
    (2, 70, 130, 64, True),
    (2, 200, 200, 128, True),
    (2, 130, 70, 256, True),
    (128, 512, 512, 256, True),
    (512, 512, 512, 128, True),
    (2, 64, 1601, 128, False),
    (2, 200, 3000, 64, False),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol_for(name):
    return 3e-2 if name == "bfloat16" else 2e-5


def make_qkv(seed, bh, s, t, d, dtype, device, mul=(1.0, 1.0, 1.0)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * f).to(device, dtype)
            for shape, f in zip(((bh, s, d), (bh, t, d), (bh, t, d)), mul)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel is CUDA C++ "
                    "and has no CPU mode (run `pytest -m cuda` on the card)")
    # the plain version's float32 contractions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _compare(got, want, name, tol=None):
    tol = tol if tol is not None else tol_for(name)
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

    @pytest.mark.parametrize("bh,s,t,d,causal", SHAPES)
    def test_bf16_matches_tensor_core_emulation(self, cuda_device, bh, s, t, d, causal):
        q, k, v = make_qkv(bh * 1000 + s + d, bh, s, t, d, torch.bfloat16, cuda_device)
        out = flash_attention(q, k, v, causal=causal)
        _compare(out, tensor_core_emulation(q, k, v, causal=causal), "bfloat16", EMULATION_TOL)

    def test_peaked_bf16(self, cuda_device):
        """Scores of std ~100 (R8): the kernel within the bf16 bar of the
        plain version and within EMULATION_TOL of the emulation."""
        bh, s, t, d, causal = PEAKED
        q, k, v = make_qkv(13, bh, s, t, d, torch.bfloat16, cuda_device, mul=(8.0, 16.0, 1.0))
        out = flash_attention(q, k, v, causal=causal)
        assert bool(torch.isfinite(out.float()).all())
        _compare(out, flash_attention(q, k, v, causal=causal, impl="ref"), "bfloat16")
        _compare(out, tensor_core_emulation(q, k, v, causal=causal), "bfloat16", EMULATION_TOL)

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


@pytest.mark.cuda
class TestTrainingFunction:
    @pytest.mark.parametrize("name", list(DTYPES))
    def test_forward_is_the_kernel_backward_the_plain_version(self, cuda_device, name):
        """``flash_attention_train`` on the card: one kernel launch, the
        kernel's output, and the gradient of the plain version recomputed
        from the same q, k and v (bit-equal to plain autograd of it)."""
        q, k, v = make_qkv(5, 8, 128, 128, 64, DTYPES[name], cuda_device)
        g = torch.randn(q.shape, device=cuda_device).to(q.dtype)
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        b = [t.clone().requires_grad_() for t in (q, k, v)]
        launches = flash_attention_cuda.launches
        out = flash_attention_train(*a)
        assert flash_attention_cuda.launches == launches + 1
        assert torch.equal(out, flash_attention(q, k, v))
        out.backward(g)
        attention_reference(*b).backward(g)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == launches + 2  # the forward compared above
        for x, y in zip(a, b):
            assert torch.equal(x.grad, y.grad)
