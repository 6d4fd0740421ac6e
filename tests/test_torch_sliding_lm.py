"""The sliding-window mask of the port (``repro_torch.models.attention``,
``mask_kind="sliding"``: key j visible from query i iff ``i - w < j <= i``)
and the ring-buffer KV cache of ``min(max_seq, w)`` slots, against the JAX
reference on the CPU.

The four dense archs' reduced configs with ``sliding_window=16`` go through
``test_torch_moe_lm.LMParity`` at a prompt of 40 (so the prefill's window
cuts and the cache is packed from the last 16 keys): loss, prefill logits,
every cache leaf, float32 grads against ``jax.grad``, 9 teacher-forced
decode steps from the prefill (positions 40-48, the ring's slot 0 reused
at 48) and 8 from a prompt of 12 (the ring fills at position 16 inside
the decode).  Bars are ``LMParity``'s: float32 at 1e-4 of scale,
bfloat16 at 0.15 (with ``CHAOTIC_BF16``, see ``test_torch_zoo_lm``).

Also: the layer against the reference's chunked attention at several
query chunks; the reference's four ``LONG_CONTEXT_VARIANT`` configs field
by field; and the port's versions of
``tests/test_models.py::TestSlidingWindow`` (the cache holds the window;
sliding equals causal when the prompt fits the window).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.models import attention as pattn
from repro_torch.models import lm as plm
from repro_torch.models.convert import params_from_numpy
from test_torch_moe_lm import BAR, CONFIG_FIELDS, DTYPES, PFLAGS, LMParity, _close
from test_torch_zoo_lm import grads_match_jax_grad

torch.set_num_threads(1)

WINDOW = 16
#: the dense archs with a long-context variant: (arch id, module)
VARIANT_ARCHS = (("llama3.2-1b", "llama32_1b"), ("gemma-7b", "gemma_7b"),
                 ("phi4-mini-3.8b", "phi4_mini_3_8b"), ("yi-9b", "yi_9b"))


class SlidingParity(LMParity):
    OVERRIDES = {"sliding_window": WINDOW}
    S = 40
    DECODE_STEPS = 9
    CHAOTIC_BF16 = True

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)

    def test_decode_across_wrap(self, model):
        """8 decode steps from a prompt of 12: the ring of 16 slots fills at
        position 16, inside the decode, and slots 0-3 are written over."""
        self._decode_check(model, 12, 8)

    def test_ring_cache_width(self):
        lm = plm.LM(self.cfg)
        assert lm.kv_window(self.S + 8) == WINDOW == jlm.LM(self.jcfg).kv_window(self.S + 8)
        assert lm.kv_window(10) == 10


class TestLlamaSliding(SlidingParity):
    ARCH = "llama3.2-1b"
    FULL_PARAMS = 1_235_812_352


class TestGemmaSliding(SlidingParity):
    ARCH = "gemma-7b"
    FULL_PARAMS = 8_537_677_824


class TestPhi4Sliding(SlidingParity):
    ARCH = "phi4-mini-3.8b"
    FULL_PARAMS = 3_836_018_688


class TestYiSliding(SlidingParity):
    ARCH = "yi-9b"
    FULL_PARAMS = 8_567_259_136


@pytest.mark.parametrize("arch,module", VARIANT_ARCHS)
def test_long_context_variant(arch, module):
    """Each ``LONG_CONTEXT_VARIANT`` is the reference's, field by field: the
    full config with ``-swa8k`` and a window of 8192."""
    got = importlib.import_module(f"repro_torch.configs.{module}").LONG_CONTEXT_VARIANT
    ref = importlib.import_module(f"repro.configs.{module}").LONG_CONTEXT_VARIANT
    for field in CONFIG_FIELDS:
        assert getattr(got, field) == getattr(ref, field), field
    assert got.name == get_config(arch).name + "-swa8k" and got.sliding_window == 8192
    assert got.param_count() == ref.param_count() == get_config(arch).param_count()
    base = get_config(arch)
    assert dataclasses.replace(got, name=base.name, sliding_window=0) == base
    assert plm.LM(got).kv_window(12_288 + 64) == 8192


def _layer_inputs(name, cfg, jcfg, s, seed):
    jdt, tdt = DTYPES[name]
    blocks = jlm.LM(jcfg).init(jax.random.PRNGKey(0), jdt)["blocks"]
    ap = jax.tree.map(lambda a: a[0], blocks["attn"])
    x = np.random.default_rng(seed).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, ap), device="cpu")
    return (jnp.asarray(x, jdt), ap), (torch.from_numpy(x).to(tdt), tp)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("s,window,q_chunk", [(40, 16, 16), (40, 16, 512), (48, 16, 8),
                                              (37, 5, 512), (24, 64, 8)])
def test_attention_forward_sliding(name, s, window, q_chunk):
    """The layer against the reference's chunked attention with the same
    mask and chunk (the port reads each chunk's window of keys only);
    llama's reduced shapes (8 query heads over 2 kv heads)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), sliding_window=window)
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b", reduced=True), sliding_window=window)
    (jx, jp), (tx, tp) = _layer_inputs(name, cfg, jcfg, s, seed=s + window)
    got = pattn.attention_forward(tx, tp, cfg, mask_kind="sliding", q_chunk=q_chunk)
    ref = jattn.attention_forward(jx, jp, jcfg, mask_kind="sliding", q_chunk=q_chunk)
    assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (2, s, cfg.d_model)
    _close(got, ref, BAR[name])


def test_pick_chunk():
    for s in (1, 12, 512, 513, 1000, 8160, 12_288):
        for target in (8, 16, 512):
            assert pattn._pick_chunk(s, target) == jattn._pick_chunk(s, target)


class TestSlidingWindow:
    """The port's counterparts of ``tests/test_models.py::TestSlidingWindow``."""

    def test_sliding_variant_limits_cache(self):
        cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), sliding_window=16)
        cache = plm.LM(cfg).init_cache(batch=2, max_seq=1024, device="cpu")
        assert cache["layers"]["k"].shape[2] == 16  # window, not max_seq
        assert cache["layers"]["v"].shape[2] == 16

    @pytest.mark.parametrize("arch", [a for a, _ in VARIANT_ARCHS])
    def test_sliding_mask_matches_windowed_reference(self, arch):
        """Sliding-window forward == full causal attention when S <= window:
        the loss in float32 (the sliding path against the flash kernel's
        plain version), and the prefill logits."""
        base = get_config(arch, reduced=True)
        s = 32
        swa = dataclasses.replace(base, sliding_window=s * 2)
        p = plm.LM(base).init(prng.PRNGKey(0), torch.float32, "cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, base.vocab_size, (2, s)))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        with torch.no_grad():
            l1, _ = plm.LM(base).loss_fn(p, batch, PFLAGS)
            l2, _ = plm.LM(swa).loss_fn(p, batch, PFLAGS)
            np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
            g1, _ = plm.LM(base).prefill_fn(p, {"tokens": toks}, max_seq=s + 4)
            g2, _ = plm.LM(swa).prefill_fn(p, {"tokens": toks}, max_seq=s + 4)
        _close(g2, g1, BAR["float32"])
