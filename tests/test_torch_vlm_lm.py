"""The port's ``vlm`` language model (llama-3.2-vision-11b) against the JAX
reference on the CPU, at the REDUCED config (one pattern block of 5
layers: 4 self-attention layers, then a gated cross-attention layer over
17 vision tokens; d_model 128, 4 query heads over 2 kv heads), with the
reference's weights carried across by ``repro_torch.models.convert`` and
the stub vision tokens made with numpy from a seed.

The cross gate is zero at init (``init="zeros"``), which makes the cross
sub-layer add nothing (ROADMAP R20); every parity case sets it to 0.5 on
both sides (``_params``), so the cross path counts, and one test holds
that the image moves the logits exactly when the gate is not zero.  At the
reference's init the reduced model is chaotic even in float32 (R19: its
own float32 keys lie beyond the 1e-4 bar from its float64 evaluation by
the fourth layer), so the parity cases also scale every wq and wk by 1/4
on both sides (:func:`tame`); the single layers run at the raw init.

The checks and bars are ``test_torch_moe_lm.LMParity``'s: config field by
field and the analytic counts, schema, init bit for bit, loss and grads,
prefill logits and every cache leaf (the self ring stacked over the 4
self sub-layers, the cross keys and values), four decode steps in place,
decode against prefill; float32 at 1e-4 of scale, bfloat16 at 0.15.  The
layer: the full mask with and without RoPE, cross attention at T 17, 65
and 129 (the last two one key past the CUDA kernel's 64-key tile), the
cross keys and values and the cross decode step.  Also the data
pipeline's image embeddings and ``serve_batch``'s greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch import serve as pserve
from repro_torch.models import attention as pattn
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.models.convert import params_from_numpy
from test_torch_moe_lm import BAR, DTYPES, B, LMParity, _close
from test_torch_zoo_lm import grads_match_jax_grad

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-11b"
GATE = 0.5


def with_gate(jparams, gate: float):
    """The reference's weights with every block's ``cross_gate`` at ``gate``."""
    blocks = jparams["blocks"]
    return dict(jparams, blocks=dict(blocks, cross_gate=jnp.full_like(blocks["cross_gate"],
                                                                      gate)))


def tame(jparams, factor: float = 0.25):
    """The reference's weights with every attention's wq and wk scaled by
    ``factor`` (self, cross and encoder attention alike): by the init's
    scales, scores of std ~3 in place of ~45 (ROADMAP R19)."""
    if "wq" in jparams:
        return dict(jparams, wq=jparams["wq"] * factor, wk=jparams["wk"] * factor)
    return {k: tame(v, factor) if isinstance(v, dict) else v for k, v in jparams.items()}


def acts(name, shape, seed):
    """(reference, port) activations of ``shape`` in the dtype ``name``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def sub0(tree, *index):
    """Each leaf of a stacked layer's dict at ``index``."""
    return {k: v[index] for k, v in tree.items()}


class TestVision(LMParity):
    ARCH = ARCH
    FULL_PARAMS = 9_585_360_896
    DECODE_STEPS = 4

    def _params(self, jparams):
        return tame(with_gate(jparams, GATE))

    @pytest.fixture(scope="class", params=list(DTYPES))
    def raw(self, request):
        """(dtype name, JAX params, port params): the reference's init as it
        is, for the single layers."""
        name = request.param
        jp = jlm.LM(self.jcfg).init(jax.random.PRNGKey(0), DTYPES[name][0])
        return name, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")

    def test_grads_match_jax_grad(self):
        grads_match_jax_grad(self)

    def test_counts(self):
        """The analytic counts are the reference's own (they differ from the
        schema's leaf sum, 9,252,966,408, as the reference's do); the
        schema's shapes of the 8 pattern blocks."""
        cfg, ref = get_config(ARCH), jax_get_config(ARCH)
        lm = plm.LM(cfg)
        assert lm.n_blocks == jlm.LM(ref).n_blocks == 8
        assert cfg.param_count() == ref.param_count() == 9_585_360_896
        assert cfg.param_count(padded=True) == ref.param_count(padded=True)
        assert cfg.active_param_count() == ref.active_param_count() == cfg.param_count()
        assert [cfg._layer_params(i, False) for i in range(40)] == [
            ref._layer_params(i, False) for i in range(40)]
        assert pcommon.param_count(lm.schema()) == jcommon.param_count(
            jlm.LM(ref).schema()) == 9_252_966_408
        schema = lm.schema()["blocks"]
        assert schema["self_attn"]["wq"].shape == (8, 4, 4096, 32, 128)
        assert schema["self_norm"].shape == (8, 4, 4096)
        assert schema["cross_attn"]["wk"].shape == (8, 4096, 8, 128)
        assert schema["cross_gate"].shape == (8, 1) and schema["cross_gate"].init == "zeros"
        assert schema["mlp"]["w_up"].shape == (8, 5, 4096, 14336)
        assert schema["mlp_norm"].shape == (8, 5, 4096)

    # -- the layer -------------------------------------------------------------
    @pytest.mark.parametrize("t", [17, 65, 129])
    def test_cross_attention_forward(self, raw, t):
        """``attention_forward(mask_kind="full", kv_input=..., use_rope=False)``
        over T keys (T != S; 65 and 129 one key past a 64-key tile), GQA."""
        name, jp, pp = raw
        jx, tx = acts(name, (B, self.S, self.cfg.d_model), 3)
        jsrc, tsrc = acts(name, (B, t, self.cfg.d_model), 4)
        ap, jap = sub0(pp["blocks"]["cross_attn"], 0), sub0(jp["blocks"]["cross_attn"], 0)
        got = pattn.attention_forward(tx, ap, self.cfg, mask_kind="full", kv_input=tsrc,
                                      use_rope=False)
        ref = jattn.attention_forward(jx, jap, self.jcfg, mask_kind="full", kv_input=jsrc,
                                      use_rope=False, q_chunk=16)
        assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (B, self.S,
                                                                     self.cfg.d_model)
        _close(got, ref, BAR[name])

    @pytest.mark.parametrize("use_rope", [True, False])
    def test_full_mask(self, raw, use_rope):
        """Self attention under the full mask, with and without RoPE."""
        name, jp, pp = raw
        jx, tx = acts(name, (B, self.S, self.cfg.d_model), 5)
        ap = {k: v[0, 0] for k, v in pp["blocks"]["self_attn"].items()}
        jap = {k: v[0, 0] for k, v in jp["blocks"]["self_attn"].items()}
        got = pattn.attention_forward(tx, ap, self.cfg, mask_kind="full", use_rope=use_rope)
        ref = jattn.attention_forward(jx, jap, self.jcfg, mask_kind="full", use_rope=use_rope,
                                      q_chunk=16)
        _close(got, ref, BAR[name])

    def test_cross_kv_and_decode(self, raw):
        """``precompute_cross_kv`` and one ``decode_cross_attention`` step."""
        name, jp, pp = raw
        jsrc, tsrc = acts(name, (B, self.cfg.vision_tokens, self.cfg.d_model), 6)
        jx1, tx1 = acts(name, (B, 1, self.cfg.d_model), 7)
        ap, jap = sub0(pp["blocks"]["cross_attn"], 0), sub0(jp["blocks"]["cross_attn"], 0)
        ck, cv = pattn.precompute_cross_kv(tsrc, ap)
        jck, jcv = jattn.precompute_cross_kv(jsrc, jap)
        _close(ck, jck, BAR[name], "k")
        _close(cv, jcv, BAR[name], "v")
        got = pattn.decode_cross_attention(tx1, ap, ck, cv, self.cfg)
        ref = jattn.decode_cross_attention(jx1, jap, jck, jcv, self.jcfg)
        assert tuple(got.shape) == (B, 1, self.cfg.d_model) and got.dtype == DTYPES[name][1]
        _close(got, ref, BAR[name])

    def test_gate_wires_the_image(self):
        """At gate 0.5 another image changes the port's prefill logits and
        loss; at 0 (the init) neither moves by a bit."""
        jp = jlm.LM(self.jcfg).init(jax.random.PRNGKey(0), jnp.float32)
        _, toks = self._tokens(12)
        _, labels = self._tokens(13)
        images = [acts("float32", (B, self.cfg.vision_tokens, self.cfg.d_model), seed)[1]
                  for seed in (14, 15)]
        lm = plm.LM(self.cfg)
        for gate in (0.0, GATE):
            pp = params_from_numpy(jax.tree.map(np.asarray, with_gate(jp, gate)), device="cpu")
            with torch.no_grad():
                logits = [lm.prefill_fn(pp, {"tokens": toks, "image_embeds": img},
                                        max_seq=self.S + 4)[0] for img in images]
                losses = [lm.loss_fn(pp, {"tokens": toks, "labels": labels,
                                          "image_embeds": img})[0] for img in images]
            if gate:
                assert float((logits[0] - logits[1]).abs().max()) > 1e-3
                assert float(losses[0]) != float(losses[1])
            else:
                assert torch.equal(logits[0], logits[1])
                assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize("step", [0, 5])
def test_pipeline_image_embeds(step):
    """The data pipeline's batch, image embeddings included, equals the
    reference's for the same seed and step."""
    for reduced in (True, False):
        got = SyntheticLMDataset(get_config(ARCH, reduced), 2, 16, seed=3).batch_at(step)
        want = JDataset(jax_get_config(ARCH, reduced), 2, 16, seed=3).batch_at(step)
        assert got.keys() == want.keys() == {"tokens", "labels", "image_embeds"}
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got["image_embeds"].shape == (2, get_config(ARCH, reduced).vision_tokens,
                                             get_config(ARCH, reduced).d_model)


def test_serve_batch_greedy_tokens(monkeypatch):
    """``serve_batch`` with the stub image embeddings drawn as the
    reference draws them, and the reference's weights for the seed
    (``TestVision._params``'d: gate 0.5, so the image counts) given to both
    sides: in float32 (the reference's server with its weights made in
    float32) every greedy token is the reference's; in bf16 the first
    step's logits are within the bar of the reference's."""
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    batch, plen, gen, seed = 2, 16, 6, 1
    for name in DTYPES:
        jdt = DTYPES[name][0]

        class Weights(jlm.LM):
            def init(self, key, dtype=None):
                return tame(with_gate(super().init(key, jdt), GATE))

        monkeypatch.setattr(jserve, "LM", Weights)
        params = Weights(jcfg).init(jax.random.PRNGKey(seed))
        ref = jserve.serve_batch(jcfg, batch, plen, gen, seed)
        got = pserve.serve_batch(cfg, batch, plen, gen, seed, device="cpu",
                                 params=params_from_numpy(jax.tree.map(np.asarray, params),
                                                          device="cpu"))
        if name == "float32":
            np.testing.assert_array_equal(got["generated"], ref["generated"])
            continue
        rng = np.random.default_rng(seed)
        toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (batch, plen)), jnp.int32)
        image = jnp.asarray(rng.standard_normal((batch, jcfg.vision_tokens, jcfg.d_model)),
                            jnp.bfloat16)
        first, _ = Weights(jcfg).prefill_fn(params, {"tokens": toks, "image_embeds": image},
                                            max_seq=plen + gen,
                                            flags=jlm.RunFlags(remat="none", q_chunk=plen))
        np.testing.assert_array_equal(ref["generated"][:, 0], np.asarray(first.argmax(-1)))
        _close(got["logits"][:, 0], first, BAR[name])


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_npz_weights_cross_unchanged(arch, tmp_path):
    """The reference's bfloat16 weights of the reduced vlm (cross gate at
    0.5) and audio models through its npz store
    (``repro.checkpoint.store.save``) into the port
    (``params_from_numpy(np.load(...))``): every leaf bit for bit, the
    vlm's stacked self-attention sub-layers, cross sub-layer and gate and
    the audio encoder's ``enc_blocks`` and ``enc_norm`` in their shapes."""
    from repro.checkpoint import store as jstore

    jcfg = jax_get_config(arch, reduced=True)
    jparams = jlm.LM(jcfg).init(jax.random.PRNGKey(2), jnp.bfloat16)
    if jcfg.family == "vlm":
        jparams = with_gate(jparams, GATE)
    path = jstore.save(str(tmp_path), 1, jparams)
    with np.load(path) as z:
        got = dict(pcommon.tree_leaves(params_from_numpy(z, device="cpu")))
    want = dict(pcommon.tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                      device="cpu")))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[k]), k
    d, hd = jcfg.d_model, jcfg.head_dim_
    if jcfg.family == "vlm":
        n_self = jcfg.cross_attn_every - 1
        assert tuple(got["blocks/self_attn/wq"].shape) == (1, n_self, d, jcfg.n_heads, hd)
        assert tuple(got["blocks/cross_attn/wk"].shape) == (1, d, jcfg.n_kv_heads, hd)
        assert bool((got["blocks/cross_gate"] == GATE).all())
    else:
        assert tuple(got["enc_blocks/attn/wq"].shape) == (jcfg.enc_layers, d, jcfg.n_heads, hd)
        assert tuple(got["enc_norm"].shape) == (d,)
        assert tuple(got["blocks/cross_attn/wv"].shape) == (jcfg.n_layers, d, jcfg.n_kv_heads,
                                                             hd)
