"""The port's ``audio`` enc-dec backbone (seamless-m4t-large-v2) against
the JAX reference on the CPU, at the REDUCED config (2 encoder layers over
64 stub audio frames, 2 decoder layers of self attention, cross attention
over the encoder's output and MLP; d_model 128, 4 heads, GELU MLP), with
the reference's weights carried across by ``repro_torch.models.convert``
and the frames made with numpy from a seed.  As for the vlm
(``test_torch_vlm_lm``), every parity case scales the attention's wq and
wk by 1/4 on both sides (``tame``): at the reference's init the reduced
model is chaotic even in float32 (ROADMAP R19).

The checks and bars are ``test_torch_moe_lm.LMParity``'s: config field by
field and the analytic counts, schema, init bit for bit, loss and grads
(the encoder's included), prefill logits and every cache leaf (the
decoder's self ring, the cross keys and values of the encoder output),
four decode steps in place, decode against prefill; float32 at 1e-4 of
scale, bfloat16 at 0.15.  Also the encoder alone (``LM._encode``: the full
mask with RoPE at positions 0..F-1), the data pipeline's audio frames and
``serve_batch``'s greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch import serve as pserve
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.models.convert import params_from_numpy
from test_torch_moe_lm import BAR, DTYPES, FLAGS, PFLAGS, LMParity, _close
from test_torch_vlm_lm import tame
from test_torch_zoo_lm import grads_match_jax_grad

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"


class TestAudio(LMParity):
    ARCH = ARCH
    FULL_PARAMS = 1_369_700_352
    DECODE_STEPS = 4

    def _params(self, jparams):
        return tame(jparams)

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)

    def test_counts(self):
        """The analytic counts are the reference's own (they differ from the
        schema's leaf sum, 1,371,662,336, as the reference's do); the
        encoder's and decoder's schema."""
        cfg, ref = get_config(ARCH), jax_get_config(ARCH)
        lm = plm.LM(cfg)
        assert cfg.param_count() == ref.param_count() == 1_369_700_352
        assert cfg.param_count(padded=True) == ref.param_count(padded=True)
        assert cfg.active_param_count() == ref.active_param_count() == cfg.param_count()
        assert cfg._enc_layer_params(False) == ref._enc_layer_params(False)
        assert pcommon.param_count(lm.schema()) == jcommon.param_count(
            jlm.LM(ref).schema()) == 1_371_662_336
        schema = lm.schema()
        assert schema["enc_blocks"]["attn"]["wq"].shape == (24, 1024, 16, 64)
        assert schema["enc_blocks"]["mlp"]["w_up"].shape == (24, 1024, 8192)
        assert schema["enc_norm"].shape == (1024,)
        assert schema["blocks"]["cross_attn"]["wk"].shape == (24, 1024, 16, 64)
        assert "w_gate" not in schema["blocks"]["mlp"]  # GELU: two matrices

    def test_encode(self, model):
        """``LM._encode`` alone: the encoder's output (B, F, D)."""
        name, jp, pp = model
        je, te = self._embeds(name)
        got = plm.LM(self.cfg)._encode(pp, te["audio_embeds"], PFLAGS)
        ref = jlm.LM(self.jcfg)._encode(jp, je["audio_embeds"], FLAGS)
        assert tuple(got.shape) == (2, self.cfg.audio_frames, self.cfg.d_model)
        assert got.dtype == DTYPES[name][1]
        _close(got, ref, BAR[name])


@pytest.mark.parametrize("step", [0, 5])
def test_pipeline_audio_embeds(step):
    """The data pipeline's batch, audio frames included, equals the
    reference's for the same seed and step (float32 on both sides: the
    reference's cast to numpy's bfloat16 finds none)."""
    for reduced in (True, False):
        got = SyntheticLMDataset(get_config(ARCH, reduced), 2, 16, seed=3).batch_at(step)
        want = JDataset(jax_get_config(ARCH, reduced), 2, 16, seed=3).batch_at(step)
        assert got.keys() == want.keys() == {"tokens", "labels", "audio_embeds"}
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got["audio_embeds"].dtype == np.float32


def test_serve_batch_greedy_tokens(monkeypatch):
    """``serve_batch`` with the stub audio frames drawn as the reference
    draws them, the reference's weights for the seed (``_params``'d as the
    parity cases are) given to both sides: in bf16 the first step's logits
    within the bar of the reference's server's; in float32 every greedy
    token of the reference driven through its own prefill and decode steps
    on the same prompts and frames (the reference's server cannot run
    float32 weights here: its encoder's scan carry would turn from bf16
    frames to float32)."""
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    batch, plen, gen, seed = 2, 16, 6, 1

    class TamedLM(jlm.LM):
        def init(self, key, dtype=jnp.bfloat16):
            return tame(super().init(key, dtype))

    monkeypatch.setattr(jserve, "LM", TamedLM)
    lm = TamedLM(jcfg)
    params = lm.init(jax.random.PRNGKey(seed), jnp.bfloat16)
    ref = jserve.serve_batch(jcfg, batch, plen, gen, seed)
    got = pserve.serve_batch(cfg, batch, plen, gen, seed, device="cpu",
                             params=params_from_numpy(jax.tree.map(np.asarray, params),
                                                      device="cpu"))
    rng = np.random.default_rng(seed)
    toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (batch, plen)), jnp.int32)
    frames = jnp.asarray(rng.standard_normal((batch, jcfg.audio_frames, jcfg.d_model)),
                         jnp.bfloat16)
    flags = jlm.RunFlags(remat="none", q_chunk=plen)
    first, _ = lm.prefill_fn(params, {"tokens": toks, "audio_embeds": frames},
                             max_seq=plen + gen, flags=flags)
    np.testing.assert_array_equal(ref["generated"][:, 0], np.asarray(first.argmax(-1)))
    _close(got["logits"][:, 0], first, BAR["bfloat16"])

    params = lm.init(jax.random.PRNGKey(seed), jnp.float32)
    got = pserve.serve_batch(cfg, batch, plen, gen, seed, device="cpu",
                             params=params_from_numpy(jax.tree.map(np.asarray, params),
                                                      device="cpu"))
    logits, cache = jax.jit(lambda p, b: lm.prefill_fn(p, b, max_seq=plen + gen, flags=flags))(
        params, {"tokens": toks, "audio_embeds": frames.astype(jnp.float32)})
    decode = jax.jit(lambda p, c, t: lm.decode_fn(p, c, t, flags))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(got["generated"], np.concatenate(want, axis=1))
