"""The flash-attention and SSD kernels as ``torch.library`` custom ops
(``repro_torch::flash_attention``, ``repro_torch::ssd_decode_step``), on
the CPU, where each op's implementation is the kernel's plain version.

* The dispatch (``impl=""``) runs the op, bit-equal to the plain version,
  and ``impl="ref"`` bypasses it; the SSD op's in-place call mutates the
  state it is given.
* The fake implementations (``FakeTensorMode`` on "cuda" tensors, and the
  meta device the dry-run traces on) give the plain versions' output
  shapes and dtypes without running a kernel.
* The FLOP formulas (``torch.utils.flop_counter``) give the analytic
  counts: 4 BH D per (query, visible key) pair for flash attention (the
  causal pairs only for ``causal=True``), 5 BHPN + 3 BHP + 2 BH for the
  SSD step, as chip_smoke.py's bounds count them.
* Under ``remat="dots"`` the selective checkpoint sees the flash op and
  recomputes it: two calls a layer in a training step (R22).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from _torch_sharding import serve_params
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import causal_pairs, flash_attention_op
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.ssd import ssd_decode_step
from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda
from repro_torch.kernels.ssd.ops import ssd_decode_step_op
from repro_torch.kernels.ssd.ref import ssd_decode_step_ref
from repro_torch.models.common import tree_map
from repro_torch.models.lm import LM, RunFlags

torch.set_num_threads(1)


class OpCalls(TorchDispatchMode):
    """Counts the dispatches of each ``repro_torch`` op."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.n[func.overloadpacket.__name__] = self.n.get(func.overloadpacket.__name__, 0) + 1
        return func(*args, **(kwargs or {}))


def _qkv(seed, bh, s, t, d, dtype=torch.float32, device="cpu"):
    """q, k, v: normal draws on the CPU, empty tensors (shapes and dtypes
    only) on "cuda" under ``FakeTensorMode`` and on the meta device."""
    shapes = ((bh, s, d), (bh, t, d), (bh, t, d))
    if device != "cpu":
        return [torch.empty(shape, dtype=dtype, device=device) for shape in shapes]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for shape in shapes]


def _ssd(seed, b, h, p, n, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    low = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    return [low(b, h, p), low(b, h).abs(), -torch.rand(h, generator=g), low(b, n), low(b, n),
            torch.rand(h, generator=g) + 0.5, torch.randn((b, h, p, n), generator=g)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 32, 32, 16), (3, 20, 44, 8), (1, 40, 24, 32)])
def test_flash_dispatch_runs_the_op(shape, causal):
    q, k, v = _qkv(0, *shape)
    with OpCalls() as calls:
        got = flash_attention(q, k, v, causal=causal)
        ref = flash_attention(q, k, v, causal=causal, impl="ref")
    assert calls.n == {"flash_attention": 1}
    assert torch.equal(got, ref) and torch.equal(ref, attention_reference(q, k, v, causal=causal))
    launches = flash_attention_cuda.launches
    assert torch.equal(flash_attention_op(q, k, v, causal, 0.25),
                       attention_reference(q, k, v, causal=causal, scale=0.25))
    assert flash_attention_cuda.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(4, 64, 64, 64), (2, 16, 48, 128), (2, 48, 16, 256)])
def test_flash_fake_and_flops(shape, causal, dtype):
    bh, s, t, d = shape
    want = attention_reference(*_qkv(1, *shape, dtype=dtype), causal=causal)
    pairs = causal_pairs(s, t) if causal else s * t
    assert pairs == (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
    for where in ("fake", "meta"):
        counter = FlopCounterMode(display=False)
        if where == "fake":
            with FakeTensorMode():
                qkv = _qkv(1, *shape, dtype=dtype, device="cuda")
                with counter:
                    out = flash_attention(*qkv, causal=causal)
        else:
            qkv = _qkv(1, *shape, dtype=dtype, device="meta")
            with counter:
                out = flash_attention(*qkv, causal=causal)
        assert out.shape == want.shape and out.dtype == want.dtype, where
        assert counter.get_total_flops() == 4 * bh * d * pairs, where


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 16, 32), (3, 4, 24, 40), (1, 8, 64, 128)])
def test_ssd_op_in_place_fake_and_flops(shape, dtype):
    b, h, p, n = shape
    args = _ssd(2, *shape, dtype=dtype)
    y_ref, s_ref = ssd_decode_step_ref(*args)
    state = args[-1].clone()
    with OpCalls() as calls:
        y_out, s_out = ssd_decode_step(*args)  # out of place: a new state
        y_in, s_in = ssd_decode_step(*args[:-1], state, out=state)
    assert calls.n == {"ssd_decode_step": 2}
    assert s_in is state and torch.equal(state, s_ref) and torch.equal(s_out, s_ref)
    assert torch.equal(y_in, y_ref) and torch.equal(y_out, y_ref)
    assert ssd_decode_step_op._opoverload._schema.arguments[6].alias_info.is_write
    launches = ssd_decode_step_cuda.launches
    for where in ("fake", "meta"):
        counter = FlopCounterMode(display=False)
        ctx = FakeTensorMode() if where == "fake" else None
        if ctx is not None:
            ctx.__enter__()
        try:
            dev = "cuda" if where == "fake" else "meta"
            xs = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in args]
            with counter:
                y, st = ssd_decode_step(*xs[:-1], xs[-1], out=xs[-1])
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        assert y.shape == y_ref.shape and y.dtype == y_ref.dtype, where
        assert st is xs[-1]
        assert counter.get_total_flops() == 5 * b * h * p * n + 3 * b * h * p + 2 * b * h, where
    assert ssd_decode_step_cuda.launches == launches


def test_dots_remat_recomputes_the_flash_op():
    """``remat="dots"`` saves products, not the flash op: the training step
    dispatches it twice a layer (the forward and the recompute), as many
    times as ``remat="block"`` and twice ``"none"``."""
    cfg = get_config("llama3.2-1b", reduced=True)
    lm = LM(cfg)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(cfg, 2, 32).batch_at(0).items()}
    counts, losses = {}, {}
    for remat in ("none", "dots", "block"):
        params = tree_map(lambda t: t.requires_grad_(), serve_params(cfg))
        with OpCalls() as calls:
            loss, _ = lm.loss_fn(params, batch, RunFlags(remat=remat, q_chunk=32))
            loss.backward()
        counts[remat] = calls.n.get("flash_attention", 0)
        losses[remat] = float(loss.detach())
    assert counts == {"none": cfg.n_layers, "dots": 2 * cfg.n_layers, "block": 2 * cfg.n_layers}
    assert losses["dots"] == losses["none"] == losses["block"]
    assert np.isfinite(losses["none"])
