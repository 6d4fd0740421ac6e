"""The port's ``hybrid`` language model (``repro_torch.models.lm``) against
the JAX reference on the CPU, at ``jamba_v01_52b``'s REDUCED config (one
pattern block of 8 layers: the SSD mixer at 7 positions, attention with
4 query heads over 2 kv heads at position 4, a gated MLP at even positions
and MoE (4 experts top-2) at odd ones), with the reference's weights
carried across.  The checks and bars are ``test_torch_moe_lm.LMParity``'s;
the cache is the nested ``{"attn": {k, v}, "ssm": {conv_x, conv_B,
conv_C, state}}``, the SSM leaves stacked over the block's 7 mixers, and
each decode step writes every sub-layer's state in place into its view of
it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.models import lm as plm
from repro_torch.models.config import ModelConfig
from test_torch_moe_lm import LMParity

torch.set_num_threads(1)


class TestJamba(LMParity):
    ARCH = "jamba-v0.1-52b"
    FULL_PARAMS = 51_216_813_056

    def test_pattern(self):
        """One block of 8 sub-layers: 7 SSD mixers, attention at index 4,
        4 MoE (odd positions) and 4 gated MLPs; the analytic count of each
        layer is the reference's."""
        cfg, ref = get_config(self.ARCH), jax_get_config(self.ARCH)
        assert plm.LM(cfg).n_blocks == 4 and plm.LM(self.cfg).n_blocks == 1
        for i in range(cfg.n_layers):
            assert cfg._layer_params(i, False) == ref._layer_params(i, False), i
            assert cfg._layer_params(i, False, active_only=True) == ref._layer_params(
                i, False, active_only=True), i
        schema = plm.LM(cfg).schema()["blocks"]
        assert schema["ssm"]["w_z"].shape == (4, 7, 4096, 8192)
        assert schema["moe"]["w_up"].shape == (4, 4, 16, 4096, 14336)
        assert schema["mlp"]["w_up"].shape == (4, 4, 4096, 14336)
        assert schema["mlp_norm"].shape == (4, 8, 4096)

    def test_one_block_depth_cut(self):
        """The 8-layer cut of the full config (the depth chip_smoke.py
        serves): one block, the reference's count at 8 layers."""
        import dataclasses

        from repro.models.common import param_count as jparam_count
        from repro_torch.models.common import param_count

        cut = dataclasses.replace(get_config(self.ARCH), n_layers=8)
        ref = dataclasses.replace(jax_get_config(self.ARCH), n_layers=8)
        assert cut.param_count() == ref.param_count() == 13_005_529_856
        # the schema's tensors hold the SSD mixers' norms and the final norm too
        assert param_count(plm.LM(cut).schema()) == jparam_count(jlm.LM(ref).schema())
        assert param_count(plm.LM(cut).schema()) == 13_005_651_328
        with pytest.raises(ValueError, match="block_len"):
            plm.LM(dataclasses.replace(cut, n_layers=12))

    def test_decode_state_views_in_place(self):
        """Each SSD mixer's state is a contiguous, 16-byte aligned view of
        the stacked cache (what the CUDA kernel's bulk path takes), and a
        decode step changes every mixer's state and the attention slot."""
        lm = plm.LM(self.cfg)
        params = lm.init(prng.PRNGKey(0), torch.float32, "cpu")
        toks = torch.from_numpy(np.random.default_rng(3).integers(0, self.cfg.vocab_size, (2, 16)))
        _, cache = lm.prefill_fn(params, {"tokens": toks}, max_seq=20)
        state = cache["layers"]["ssm"]["state"]
        assert state.shape == (1, 7, 2, self.cfg.ssm_n_heads, self.cfg.ssm_head_dim,
                               self.cfg.ssm_state)
        for j in range(7):
            view = state[0][j]
            assert view.is_contiguous() and view.data_ptr() % 16 == 0
        before = state.clone()
        k_before = cache["layers"]["attn"]["k"].clone()
        lm.decode_fn(params, cache, toks[:, :1].int())
        for j in range(7):
            assert not torch.equal(state[0][j], before[0][j]), j
        assert not torch.equal(cache["layers"]["attn"]["k"], k_before)
        assert int(cache["pos"]) == 17


def test_other_families_raise():
    """Every family of the reference builds now (the enc-dec and vlm ones
    since their slice, with the reference's analytic counts); a vlm whose
    layers are not whole pattern blocks raises, where the reference's
    ``assert`` stops it."""
    cfg = ModelConfig(name="x", family="audio", n_layers=2, d_model=64, vocab_size=128,
                      n_heads=4, n_kv_heads=4, d_ff=64, enc_layers=2)
    ref = JModelConfig(name="x", family="audio", n_layers=2, d_model=64, vocab_size=128,
                       n_heads=4, n_kv_heads=4, d_ff=64, enc_layers=2)
    assert plm.LM(cfg).n_blocks == 2
    assert cfg.param_count() == ref.param_count()
    for every in (0, 3):
        vlm = ModelConfig(name="v", family="vlm", n_layers=5, d_model=64, vocab_size=128,
                          n_heads=4, n_kv_heads=4, d_ff=64, cross_attn_every=every)
        with pytest.raises(ValueError, match="cross_attn_every"):
            plm.LM(vlm)
