"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX reference (``repro.kernels.flash_attention``) on the CPU,
where the port runs its plain PyTorch version.

Inputs are made with numpy from a seed and handed to both sides.  The
port's ``attention_reference`` is held to the JAX ``attention_reference``
and to the Pallas kernel run in interpret mode (``impl="interpret"``, as
``tests/test_kernels.py`` runs it) over ``TestFlashAttention``'s default
shapes and causal cases with S != T (top-left aligned), at the JAX suite's
``tol_for``: 2e-5 in float32, 3e-2 in bfloat16.  The CUDA kernel is held
to the same plain version on the card
(``tests/test_torch_flash_attention_cuda.py``).

The CUDA kernel's bf16 tensor-core path (every head dim up to 256) rounds
P to bf16 before the product with V, where ``ref.py`` keeps it in float32.  Its arithmetic is
emulated in plain torch (``tensor_core_emulation``, in the CUDA test file,
which imports no JAX), and the emulation is held here to the JAX reference
and the interpret-mode Pallas kernel at the bf16 ``tol_for``, over the same
shapes and the peaked regime of ROADMAP R8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_reference as jax_reference
from repro_torch.kernels.flash_attention import FLASH_IMPLS, flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_reference
from test_torch_flash_attention_cuda import PEAKED, tensor_core_emulation

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: (bh, s, t, d, causal): TestFlashAttention's default shapes, causal
#: attention with S != T both ways, and the full mask (cross attention's)
#: at D 64 with T one key past a 64-key tile
SHAPES = [
    (4, 256, 256, 64, True),
    (3, 200, 200, 64, True),
    (2, 128, 384, 64, True),
    (2, 384, 128, 32, True),
    (2, 64, 65, 64, False),
    (2, 100, 129, 64, False),
]


def tol_for(name):
    return 3e-2 if name == "bfloat16" else 2e-5


def _qkv(seed, bh, s, t, d, name, mul=(1.0, 1.0, 1.0)):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    raw = [rng.standard_normal(shape).astype(np.float32) * f
           for shape, f in zip(((bh, s, d), (bh, t, d), (bh, t, d)), mul)]
    return [jnp.asarray(a, jdt) for a in raw], [torch.from_numpy(a).to(tdt) for a in raw]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("bh,s,t,d,causal", SHAPES)
class TestPlainVersion:
    def test_matches_jax_reference(self, bh, s, t, d, causal, name):
        jx, tx = _qkv(bh + s + t, bh, s, t, d, name)
        got = attention_reference(*tx, causal=causal)
        assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (bh, s, d)
        _close(got, jax_reference(*jx, causal=causal), tol_for(name))

    def test_matches_pallas_kernel_interpret(self, bh, s, t, d, causal, name):
        jx, tx = _qkv(bh + s + t, bh, s, t, d, name)
        got = flash_attention(*tx, causal=causal)  # a CPU tensor takes the plain version
        _close(got, jax_flash_attention(*jx, causal=causal, impl="interpret"), tol_for(name))


#: the shapes above in bf16, the peaked regime (q x 8, k x 16), and head dim
#: 256 (the tensor-core path's DP-256 instantiation, gemma-7b's head dim)
#: causal with S and T off the 64-row tiles
EMULATED = ([(*shape, (1.0, 1.0, 1.0)) for shape in SHAPES] + [(*PEAKED, (8.0, 16.0, 1.0))]
            + [(2, 130, 70, 256, True, (1.0, 1.0, 1.0)), (2, 200, 200, 256, True, (1.0, 1.0, 1.0))])


@pytest.mark.parametrize("bh,s,t,d,causal,mul", EMULATED)
class TestTensorCoreEmulation:
    def test_matches_jax_reference(self, bh, s, t, d, causal, mul):
        jx, tx = _qkv(bh + s + t, bh, s, t, d, "bfloat16", mul)
        got = tensor_core_emulation(*tx, causal=causal)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (bh, s, d)
        _close(got, jax_reference(*jx, causal=causal), tol_for("bfloat16"))

    def test_matches_pallas_kernel_interpret(self, bh, s, t, d, causal, mul):
        jx, tx = _qkv(bh + s + t, bh, s, t, d, "bfloat16", mul)
        got = tensor_core_emulation(*tx, causal=causal)
        _close(got, jax_flash_attention(*jx, causal=causal, impl="interpret"),
               tol_for("bfloat16"))


@pytest.mark.parametrize("round_p", [False, True])
def test_emulation_rounds_only_p(round_p):
    """In float32 the emulation without the P rounding is the plain version
    to float32 round-off; with it, it differs, by less than the bf16 bar."""
    for seed, (bh, s, t, d) in enumerate(((2, 130, 70, 32), (2, 70, 130, 32))):
        _, tx = _qkv(seed, bh, s, t, d, "float32")
        got = tensor_core_emulation(*tx, causal=True, round_p=round_p)
        want = attention_reference(*tx, causal=True)
        diff = float((got - want).abs().max())
        if round_p:
            assert 1e-5 < diff < 3e-2
        else:
            _close(got, want, 2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_scale_override(causal):
    jx, tx = _qkv(11, 1, 128, 128, 64, "float32")
    got = flash_attention(*tx, causal=causal, scale=0.05)
    _close(got, jax_reference(*jx, causal=causal, scale=0.05), 2e-5)
    _close(got, jax_flash_attention(*jx, causal=causal, scale=0.05, impl="interpret"), 2e-5)


def test_causal_is_top_left_aligned():
    """With S > T every query past T sees all T keys; with S < T query i
    sees keys 0..i only (not the bottom-right convention)."""
    _, (q, k, v) = _qkv(3, 1, 6, 4, 8, "float32")
    out = attention_reference(q, k, v, causal=True)
    full = attention_reference(q[:, 4:], k, v, causal=False)
    torch.testing.assert_close(out[:, 4:], full, rtol=0, atol=0)
    _, (q, k, v) = _qkv(4, 1, 3, 7, 8, "float32")
    out = attention_reference(q, k, v, causal=True)
    first = attention_reference(q[:, :1], k[:, :1], v[:, :1], causal=False)
    torch.testing.assert_close(out[:, :1], first, rtol=1e-6, atol=1e-6)
    assert NEG_INF == -2.0**30


class TestDispatch:
    def test_cpu_tensor_takes_plain_version(self):
        _, tx = _qkv(5, 2, 32, 32, 16, "float32")
        launches = flash_attention_cuda.launches
        torch.testing.assert_close(flash_attention(*tx), flash_attention(*tx, impl="ref"),
                                   rtol=0, atol=0)
        assert flash_attention_cuda.launches == launches
        assert FLASH_IMPLS == ("ref", "cuda")

    def test_cuda_impl_on_cpu_tensor_raises(self):
        _, tx = _qkv(5, 2, 32, 32, 16, "float32")
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(*tx, impl="cuda")

    def test_unknown_impl_raises(self):
        _, tx = _qkv(5, 2, 32, 32, 16, "float32")
        with pytest.raises(ValueError, match="unknown"):
            flash_attention(*tx, impl="interpret")

    def test_block_sizes_have_no_effect(self):
        _, tx = _qkv(6, 2, 64, 64, 16, "float32")
        torch.testing.assert_close(flash_attention(*tx, block_q=16, block_k=32),
                                   flash_attention(*tx), rtol=0, atol=0)
