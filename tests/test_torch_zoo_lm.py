"""The port's language models of the remaining text-only zoo archs against
the JAX reference on the CPU: arctic-480b (``moe``: 128 experts top-2, a
dense residual FFN beside the MoE, 56 query heads padded to 64), gemma-7b
(GeGLU, head dim 256), phi4-mini-3.8b and yi-9b (``dense``, GQA), each at
its reduced config, and a gemma-shaped config at head dim 256 (the reduced
gemma's head dim is 64).  The checks and bars are
``test_torch_moe_lm.LMParity``'s: config, schema, init bit for bit,
loss/ce/aux, prefill logits and every cache leaf, decode steps in place,
decode against prefill; float32 at 1e-4 of scale with routing ids exact,
bfloat16 at 0.15.  Each class adds the float32 grads of the loss against
``jax.grad`` at 1e-4 of each leaf's scale.

The random reduced models are chaotic in bfloat16 (ROADMAP R8): the
port's prefill attention keeps its probabilities in float32 where the
reference rounds them (R7), and through later layers that alone moves a
decode step's logits beyond the bar (arctic's first step: 0.32 of a scale
of 1.05, and 0.004 with the reference's rounding), and both packages'
bfloat16 steps can lie beyond the bar from the float32 evaluation
(phi4's first step: the reference's 0.396, the port's 0.401, 0.038 from
each other).  So these classes set ``LMParity.CHAOTIC_BF16``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.models.convert import params_from_numpy
from test_torch_moe_lm import BAR, FLAGS, PFLAGS, LMParity, _close

torch.set_num_threads(1)


def grads_match_jax_grad(case: LMParity):
    """float32 grads of the total loss against ``jax.grad``, 1e-4 of each
    leaf's scale; the losses at rtol 1e-5.  The weights are the
    reference's init (as ``case._params`` leaves them) and the batch
    carries ``case._embeds`` where the family takes them."""
    jp = case._params(jlm.LM(case.jcfg).init(jax.random.PRNGKey(0), jnp.float32))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jt, tt = case._tokens(3)
    jl, tl = case._tokens(4)
    je, te = case._embeds("float32")
    jloss, grads = jax.value_and_grad(lambda p: jlm.LM(case.jcfg).loss_fn(
        p, {"tokens": jt, "labels": jl, **je}, FLAGS)[0])(jp)
    for _, t in pcommon.tree_leaves(pp):
        t.requires_grad_()
    loss, _ = plm.LM(case.cfg).loss_fn(pp, {"tokens": tt, "labels": tl, **te}, PFLAGS)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = dict(zip([k for k, _ in pcommon.tree_leaves(pp)], jax.tree.leaves(grads)))
    for k, t in pcommon.tree_leaves(pp):
        want = np.asarray(ref[k])
        scale = max(1e-30, float(np.abs(want).max()))
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=k)


class TestArctic(LMParity):
    ARCH = "arctic-480b"
    CHAOTIC_BF16 = True
    FULL_PARAMS = 476_620_892_160

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)

    def test_counts(self):
        """Each layer's analytic count, the padded count and the one-layer
        cut chip_smoke.py serves, all the reference's."""
        cfg, ref = get_config(self.ARCH), jax_get_config(self.ARCH)
        assert cfg.q_heads_padded == 64 and cfg.n_heads == 56 and cfg.dense_residual
        for i in (0, 34):
            assert cfg._layer_params(i, False) == ref._layer_params(i, False) == 13_611_171_840
            assert cfg._layer_params(i, True) == ref._layer_params(i, True)
        assert cfg.param_count() // cfg.n_layers == 13_617_739_776
        cut = dataclasses.replace(cfg, n_layers=1)
        jcut = dataclasses.replace(ref, n_layers=1)
        assert cut.param_count() == jcut.param_count() == 13_840_562_176
        assert pcommon.param_count(plm.LM(cut).schema()) == jcommon.param_count(
            jlm.LM(jcut).schema()) == 13_860_754_432
        schema = plm.LM(cfg).schema()["blocks"]
        assert schema["attn"]["wq"].shape == (35, 7168, 64, 128)
        assert schema["attn"]["wo"].shape == (35, 64, 128, 7168)
        assert schema["mlp"]["w_up"].shape == (35, 7168, 4864)
        assert schema["moe"]["w_up"].shape == (35, 128, 7168, 4864)

    def test_padded_heads_follow_the_reference(self):
        """The reference's init draws the 8 padded query heads like the
        others (``init_params`` has no rule for them, whatever its config's
        docstring says; ROADMAP R17), so they are live in both packages;
        with their ``wq`` columns and ``wo`` rows zeroed on both sides the
        port's loss and prefill logits still follow the reference's."""
        jp = jlm.LM(self.jcfg).init(jax.random.PRNGKey(0), jnp.float32)
        attn = jp["blocks"]["attn"]
        assert float(jnp.abs(attn["wq"][:, :, 7:]).max()) > 0
        assert float(jnp.abs(attn["wo"][:, 7:]).max()) > 0
        attn = dict(attn, wq=attn["wq"].at[:, :, 7:].set(0), wo=attn["wo"].at[:, 7:].set(0))
        jp = dict(jp, blocks=dict(jp["blocks"], attn=attn))
        pp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        assert not pp["blocks"]["attn"]["wq"][:, :, 7:].any()
        assert not pp["blocks"]["attn"]["wo"][:, 7:].any()
        jt, tt = self._tokens(5)
        jl, tl = self._tokens(6)
        ref, _ = jlm.LM(self.jcfg).loss_fn(jp, {"tokens": jt, "labels": jl}, FLAGS)
        got, _ = plm.LM(self.cfg).loss_fn(pp, {"tokens": tt, "labels": tl}, PFLAGS)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
        ref_logits, _ = jlm.LM(self.jcfg).prefill_fn(jp, {"tokens": jt}, max_seq=self.S + 4,
                                                     flags=FLAGS)
        logits, _ = plm.LM(self.cfg).prefill_fn(pp, {"tokens": tt}, max_seq=self.S + 4)
        _close(logits, ref_logits, BAR["float32"])


class TestGemma(LMParity):
    ARCH = "gemma-7b"
    CHAOTIC_BF16 = True
    FULL_PARAMS = 8_537_677_824

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)

    def test_geglu_and_head_dim(self):
        cfg = get_config(self.ARCH)
        assert cfg.act == "geglu" and cfg.head_dim_ == 256 and cfg.n_kv_heads == cfg.n_heads
        schema = plm.LM(cfg).schema()["blocks"]
        assert schema["attn"]["wq"].shape == (28, 3072, 16, 256)
        assert schema["mlp"]["w_gate"].shape == (28, 3072, 24576)


class TestGemmaHeadDim256(LMParity):
    """A gemma-shaped config at gemma-7b's head dim: d_model 128, 2 heads
    of 256 (q/k/v project 128 -> 512), GeGLU, 2 layers."""

    ARCH = "gemma-7b"
    FULL_PARAMS = 8_537_677_824
    CHAOTIC_BF16 = True
    OVERRIDES = {"name": "gemma-reduced-hd256", "n_heads": 2, "n_kv_heads": 2, "head_dim": 256}

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)

    def test_head_dim(self):
        assert self.cfg.head_dim_ == 256 == self.jcfg.head_dim_
        assert plm.LM(self.cfg).schema()["blocks"]["attn"]["wq"].shape == (2, 128, 2, 256)


class TestPhi4(LMParity):
    ARCH = "phi4-mini-3.8b"
    CHAOTIC_BF16 = True
    FULL_PARAMS = 3_836_018_688

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)


class TestYi(LMParity):
    ARCH = "yi-9b"
    CHAOTIC_BF16 = True
    FULL_PARAMS = 8_567_259_136

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)


@pytest.mark.parametrize("arch", ["arctic-480b", "gemma-7b", "phi4-mini-3.8b", "yi-9b"])
def test_served(arch):
    """``served_config`` returns the arch's configs and ``LM`` takes them."""
    from repro_torch.configs import served_config

    for reduced in (False, True):
        cfg = served_config(arch, reduced=reduced)
        assert cfg is get_config(arch, reduced=reduced)
        assert plm.LM(cfg).cfg is cfg


@pytest.mark.parametrize("case", [TestArctic, TestGemma, TestGemmaHeadDim256])
def test_npz_weights_cross_unchanged(case, tmp_path):
    """The reference's bfloat16 weights through its npz store
    (``repro.checkpoint.store.save``) into the port
    (``params_from_numpy(np.load(...))``): every leaf bit for bit, arctic's
    64 padded query heads and gemma's 256-wide heads in their shapes."""
    from repro.checkpoint import store as jstore

    jcfg = case().jcfg
    jparams = jlm.LM(jcfg).init(jax.random.PRNGKey(2), jnp.bfloat16)
    path = jstore.save(str(tmp_path), 1, jparams)
    with np.load(path) as z:
        got = params_from_numpy(z, device="cpu")
    want = dict(pcommon.tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                      device="cpu")))
    flat = dict(pcommon.tree_leaves(got))
    assert flat.keys() == want.keys()
    for k, t in flat.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[k]), k
    hd = jcfg.head_dim_
    assert tuple(flat["blocks/attn/wq"].shape) == (jcfg.n_layers, jcfg.d_model,
                                                   jcfg.q_heads_padded, hd)
    assert tuple(flat["blocks/attn/wo"].shape) == (jcfg.n_layers, jcfg.q_heads_padded, hd,
                                                   jcfg.d_model)
