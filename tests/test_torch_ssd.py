"""The port's SSD decode step and chunked scan (``repro_torch.kernels.ssd``,
``repro_torch.models.ssm``) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

* The port's plain ``ssd_decode_step`` (what a CPU tensor runs) against
  ``ssd_decode_step_reference`` (``ref.py``, the same operation order):
  float32 at ``atol=rtol=1e-5``; bfloat16 ``y`` within one bf16 ulp (the
  float32 sums round to either neighbour, then the skip term is added in
  bf16) and the float32 state at 1e-5.
* The same against the Pallas kernel in interpret mode, at the JAX suite's
  own bars for that kernel (``tests/test_kernels.py``): ``y`` within
  ``3 * tol_for(dtype)``, state at 1e-4.  The kernel adds ``D*x`` in
  float32 and rounds ``y`` once, the reference rounds twice in bf16.
* ``ssd_scan`` against the reference's, and the port's scan against its
  own step-by-step recurrence, at the bars of ``test_kernels.py``'s
  ``TestSsdScanInternalConsistency``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_decode_step as jax_ssd_decode_step
from repro.kernels.ssd.ref import ssd_decode_step_reference
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import SSD_IMPLS, ssd_decode_step
from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda
from repro_torch.models import ssm as pssm

torch.set_num_threads(1)

#: test_kernels.py's (b, h, p, n) sweep
SWEEP = [(2, 8, 64, 128), (2, 6, 16, 32), (3, 12, 32, 64), (1, 24, 64, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol_for(name):
    return 3e-2 if name == "bfloat16" else 2e-5


def decode_inputs(seed, b, h, p, n):
    """float32 numpy inputs; x, dt, B and C are cast to the working dtype
    by each side (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "x": rng.standard_normal((b, h, p)).astype(f32),
        "dt": np.logaddexp(rng.standard_normal((b, h)), 0.0).astype(f32),
        "a": (-np.exp(rng.standard_normal(h) * 0.1)).astype(f32),
        "b": rng.standard_normal((b, n)).astype(f32),
        "c": rng.standard_normal((b, n)).astype(f32),
        "d": rng.uniform(0.5, 1.5, h).astype(f32),
        "state": rng.standard_normal((b, h, p, n)).astype(f32),
    }


def _sides(inp, name):
    jdt, tdt = DTYPES[name]
    low = ("x", "dt", "b", "c")
    j = {k: jnp.asarray(v, jdt if k in low else jnp.float32) for k, v in inp.items()}
    t = {k: torch.from_numpy(v).to(tdt if k in low else torch.float32) for k, v in inp.items()}
    return j, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _bf16_spacing(mag):
    """Distance between neighbouring bfloat16 values at magnitude ``mag``."""
    e = np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


ORDER = ("x", "dt", "a", "b", "c", "d", "state")


class TestDecodeStep:
    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("b,h,p,n", SWEEP)
    def test_plain_matches_reference(self, b, h, p, n, name):
        inp = decode_inputs(b * 1000 + n, b, h, p, n)
        j, t = _sides(inp, name)
        y_ref, s_ref = ssd_decode_step_reference(*(j[k] for k in ORDER))
        state_in = t["state"].clone()
        y, s = ssd_decode_step(*(t[k] for k in ORDER))
        assert y.dtype == t["x"].dtype and s.dtype == torch.float32
        assert tuple(y.shape) == (b, h, p) and tuple(s.shape) == (b, h, p, n)
        assert torch.equal(t["state"], state_in), "the state is updated out of place"
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5, rtol=1e-5)
        got, want = _f32(y), _f32(y_ref)
        if name == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            skip = np.abs(inp["x"] * inp["d"][None, :, None])
            ulp = _bf16_spacing(np.abs(want) + skip)
            assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()

    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("b,h,p,n", SWEEP)
    def test_plain_matches_pallas_interpret(self, b, h, p, n, name):
        inp = decode_inputs(b * 1000 + n + 1, b, h, p, n)
        j, t = _sides(inp, name)
        y_k, s_k = jax_ssd_decode_step(*(j[k] for k in ORDER), impl="interpret")
        y, s = ssd_decode_step(*(t[k] for k in ORDER))
        tol = 3 * tol_for(name)
        np.testing.assert_allclose(_f32(y), _f32(y_k), atol=tol, rtol=tol)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_k), atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("name", list(DTYPES))
    @pytest.mark.parametrize("b,h,p,n", SWEEP)
    def test_plain_in_place(self, b, h, p, n, name):
        """``out=state`` writes the new state into the given tensor, bit-equal
        to the out-of-place call, and matches the reference as that does."""
        inp = decode_inputs(b * 1000 + n + 2, b, h, p, n)
        j, t = _sides(inp, name)
        y, s = ssd_decode_step(*(t[k] for k in ORDER))
        state = t["state"].clone()
        y_in, s_in = ssd_decode_step(*(t[k] for k in ORDER[:-1]), state, out=state)
        assert s_in is state
        assert torch.equal(y_in, y) and torch.equal(s_in, s)
        _, s_ref = ssd_decode_step_reference(*(j[k] for k in ORDER))
        np.testing.assert_allclose(s_in.numpy(), np.asarray(s_ref), atol=1e-5, rtol=1e-5)

    def test_dispatch(self):
        inp = decode_inputs(0, 2, 6, 16, 32)
        _, t = _sides(inp, "float32")
        args = [t[k] for k in ORDER]
        y0, s0 = ssd_decode_step(*args)
        y1, s1 = ssd_decode_step(*args, impl="ref")
        assert torch.equal(y0, y1) and torch.equal(s0, s1)
        assert SSD_IMPLS == ("ref", "cuda")
        with pytest.raises(ValueError, match="unknown SSD decode impl"):
            ssd_decode_step(*args, impl="pallas")
        # the kernel takes CUDA tensors only: no silent CPU path
        launches = ssd_decode_step_cuda.launches
        with pytest.raises(ValueError, match="CUDA"):
            ssd_decode_step(*args, impl="cuda")
        assert ssd_decode_step_cuda.launches == launches


def scan_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "x": (rng.standard_normal((b, s, h, p)) * 0.5).astype(f32),
        "dt": np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(f32),
        "a": (-np.exp(rng.standard_normal(h) * 0.1)).astype(f32),
        "b": (rng.standard_normal((b, s, n)) * 0.5).astype(f32),
        "c": (rng.standard_normal((b, s, n)) * 0.5).astype(f32),
    }


SCAN_ORDER = ("x", "dt", "a", "b", "c")


class TestSsdScan:
    @pytest.mark.parametrize("chunk", [4, 8, 16])
    def test_scan_matches_reference(self, chunk):
        inp = scan_inputs(chunk, 2, 32, 4, 8, 16)
        h0 = np.random.default_rng(99).standard_normal((2, 4, 8, 16)).astype(np.float32)
        y_ref, f_ref = jssm.ssd_scan(*(jnp.asarray(inp[k]) for k in SCAN_ORDER),
                                     chunk=chunk, h0=jnp.asarray(h0))
        y, f = pssm.ssd_scan(*(torch.from_numpy(inp[k]) for k in SCAN_ORDER),
                             chunk=chunk, h0=torch.from_numpy(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-4, rtol=1e-3)

    def test_scan_matches_reference_bf16(self):
        inp = scan_inputs(5, 2, 32, 4, 8, 16)
        low = ("x", "dt", "b", "c")
        jin = [jnp.asarray(inp[k], jnp.bfloat16 if k in low else jnp.float32) for k in SCAN_ORDER]
        tin = [torch.from_numpy(inp[k]).to(torch.bfloat16 if k in low else torch.float32)
               for k in SCAN_ORDER]
        y_ref, f_ref = jssm.ssd_scan(*jin, chunk=16)
        y, f = pssm.ssd_scan(*tin, chunk=16)
        assert y.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(y), _f32(y_ref), atol=3 * tol_for("bfloat16"),
                                   rtol=3 * tol_for("bfloat16"))
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-4, rtol=1e-3)

    @pytest.mark.parametrize("chunk", [4, 8, 16])
    def test_scan_equals_stepwise(self, chunk):
        inp = scan_inputs(chunk + 7, 2, 32, 4, 8, 16)
        x, dt, a, bb, cc = (torch.from_numpy(inp[k]) for k in SCAN_ORDER)
        y_scan, final = pssm.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
        state = torch.zeros((2, 4, 8, 16), dtype=torch.float32)
        ys = []
        for i in range(x.shape[1]):
            y, state = pssm.ssd_step(x[:, i], dt[:, i], a, bb[:, i], cc[:, i], state)
            ys.append(y)
        y_step = torch.stack(ys, dim=1)
        np.testing.assert_allclose(y_scan.numpy(), y_step.numpy(), atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(final.numpy(), state.numpy(), atol=1e-4, rtol=1e-3)

    def test_chunk_invariance(self):
        inp = scan_inputs(3, 1, 64, 2, 8, 16)
        args = [torch.from_numpy(inp[k]) for k in SCAN_ORDER]
        y8, f8 = pssm.ssd_scan(*args, chunk=8)
        y32, f32_ = pssm.ssd_scan(*args, chunk=32)
        np.testing.assert_allclose(y8.numpy(), y32.numpy(), atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(f8.numpy(), f32_.numpy(), atol=1e-4, rtol=1e-3)

    def test_step_matches_reference_step(self):
        inp = decode_inputs(11, 2, 8, 64, 128)
        keys = ("x", "dt", "a", "b", "c", "state")
        y_ref, s_ref = jssm.ssd_step(*(jnp.asarray(inp[k]) for k in keys))
        y, s = pssm.ssd_step(*(torch.from_numpy(inp[k]) for k in keys))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5, rtol=1e-5)
