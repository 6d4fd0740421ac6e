"""The port's ``dense`` language model (``repro_torch.models``) against the
JAX reference (``repro.models``) on the CPU, at ``llama32_1b``'s REDUCED
config (2 layers, d_model 128, 8 query heads over 2 kv heads), with the
reference's weights (``LM(cfg).init(PRNGKey(0), dtype)``) carried across
by ``repro_torch.models.convert``.  Activations are made with numpy from a
seed.

On the CPU the port's prefill attention runs the flash-attention kernel's
plain version (float32 logits and probabilities); the reference computes
the attention inline and rounds logits and probabilities to the
activation dtype (ROADMAP R7).

Bars, each taken relative to the compared tensor's scale (``rtol = bar``,
``atol = bar * max(1, max |reference|)``): the reference's init gives the
reduced model large q/k/v entries (its fan-in of a (d, heads, hd)
weight is ``heads``), so attention outputs and cached keys reach tens
and its softmax is sharply peaked, which magnifies round-off of the
logits; logits themselves stay O(1), where the bar is absolute.  float32
at 1e-4 (the same operations, summed in another order); bfloat16 at 0.15,
the bar ``tests/test_models.py::TestDecodeMatchesPrefill`` holds between
two JAX paths.  In bfloat16 the port's attention is also held to be no
further from a float32 evaluation of the same inputs than the
reference's own bfloat16 path is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro_torch import prng
from repro_torch.checkpoint import store as pstore
from repro_torch.configs import get_config
from repro_torch.models import attention as pattn
from repro_torch.models import common as pcommon
from repro_torch.models import ffn as pffn
from repro_torch.models import lm as plm
from repro_torch.models.convert import cache_to_numpy, params_from_numpy

torch.set_num_threads(1)

CFG = get_config("llama3.2-1b", reduced=True)
JCFG = jax_get_config("llama3.2-1b", reduced=True)
B, S = 2, 32
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLAGS = jlm.RunFlags(remat="none", q_chunk=16)
BAR = {"float32": 1e-4, "bfloat16": 0.15}
CONFIG_FIELDS = ("name", "family", "n_layers", "d_model", "vocab_size", "n_heads",
                 "n_kv_heads", "head_dim", "rope_theta", "sliding_window", "d_ff", "act",
                 "padded_heads", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv_width",
                 "ssm_chunk", "source", "dtype")


@pytest.fixture(scope="module", params=list(DTYPES))
def model(request):
    """(dtype name, JAX params, port params) with the same weights."""
    name = request.param
    jdt, tdt = DTYPES[name]
    jparams = jlm.LM(JCFG).init(jax.random.PRNGKey(0), jdt)
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    assert pparams["embed"].dtype == tdt
    return name, jparams, pparams


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=what)


def _acts(name, shape, seed=0, scale=1.0):
    jdt, tdt = DTYPES[name]
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _to_port(tree):
    """A fresh port copy of a JAX tree (decode writes caches in place)."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


class TestConfig:
    @pytest.mark.parametrize("reduced", [False, True])
    def test_config_copy(self, reduced):
        got = get_config("llama3.2-1b", reduced=reduced)
        ref = jax_get_config("llama3.2-1b", reduced=reduced)
        for field in CONFIG_FIELDS:
            assert getattr(got, field) == getattr(ref, field), field
        for prop in ("padded_vocab", "head_dim_", "q_heads_padded"):
            assert getattr(got, prop) == getattr(ref, prop), prop
        assert got.param_count() == ref.param_count()
        assert got.param_count(padded=True) == ref.param_count(padded=True)
        if not reduced:  # the schema adds the final norm to the analytic count
            assert pcommon.param_count(plm.LM(got).schema()) == 1_237_387_264

    def test_attention_families_need_heads(self):
        from repro_torch.models.config import ModelConfig

        with pytest.raises(ValueError, match="n_heads"):
            ModelConfig(name="x", family="dense", n_layers=1, d_model=64, vocab_size=16)

    def test_schema_matches_reference(self):
        got = dict(pcommon.tree_leaves(plm.LM(CFG).schema()))
        ref = {"/".join(str(p.key) for p in path): s for path, s in
               jax.tree_util.tree_flatten_with_path(
                   jlm.LM(JCFG).schema(), is_leaf=jcommon.tree_is_spec)[0]}
        assert got.keys() == ref.keys()
        for k, s in ref.items():
            assert (got[k].shape, got[k].axes, got[k].init, got[k].scale) == (
                s.shape, s.axes, s.init, s.scale), k
        assert pcommon.param_count(plm.LM(CFG).schema()) == jcommon.param_count(
            jlm.LM(JCFG).schema())

    def test_init_rule(self):
        """The reference's rule and draws: ``LM.init(PRNGKey(s))`` gives the
        reference's float32 weights for the same seed, leaf by leaf, bit for
        bit (the threefry's ``normal`` is exact here; the spec's bar is
        2 ulp), and the same seed gives the same weights twice."""
        lm = plm.LM(CFG)
        p = lm.init(prng.PRNGKey(0), torch.float32, "cpu")
        q = lm.init(prng.PRNGKey(0), torch.float32, "cpu")
        for (k, a), (_, b) in zip(pcommon.tree_leaves(p), pcommon.tree_leaves(q)):
            assert torch.equal(a, b), k
        ref = jlm.LM(JCFG).init(jax.random.PRNGKey(0), jnp.float32)
        for (k, a), (_, b) in zip(pcommon.tree_leaves(p), pcommon.tree_leaves(
                params_from_numpy(jax.tree.map(np.asarray, ref), device="cpu"))):
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, k
            assert torch.equal(a, b), k
        blocks = p["blocks"]
        assert torch.equal(blocks["attn_norm"], torch.ones_like(blocks["attn_norm"]))
        std = float(blocks["attn"]["wo"].std())
        assert abs(std - 0.5 / np.sqrt(CFG.head_dim_)) < 0.05 * std
        std = float(blocks["mlp"]["w_gate"].std())
        assert abs(std - 1.0 / np.sqrt(CFG.d_model)) < 0.05 * std


class TestLayers:
    def test_apply_rope(self, model):
        name = model[0]
        jx, tx = _acts(name, (B, S, CFG.n_heads, CFG.head_dim_), seed=1)
        positions = np.arange(5, 5 + S)
        got = pcommon.apply_rope(tx, torch.from_numpy(positions), CFG.rope_theta)
        ref = jcommon.apply_rope(jx, jnp.asarray(positions), JCFG.rope_theta)
        assert got.dtype == DTYPES[name][1]
        _close(got, ref, 1e-5 if name == "float32" else BAR[name])
        _close(pcommon.rope_frequencies(CFG.head_dim_, CFG.rope_theta),
               jcommon.rope_frequencies(JCFG.head_dim_, JCFG.rope_theta), 1e-7)

    def test_mlp(self, model):
        name, jp, pp = model
        jx, tx = _acts(name, (B, S, CFG.d_model), seed=2)
        got = pffn.mlp(tx, _layer0(pp["blocks"]["mlp"]), CFG.act)
        ref = jffn.mlp(jx, _layer0(jp["blocks"]["mlp"]), JCFG.act)
        _close(got, ref, BAR[name])

    def test_attention_forward(self, model):
        """The port's kernel-routed attention against the reference's
        chunked inline attention (q_chunk 16 over S 32)."""
        name, jp, pp = model
        jx, tx = _acts(name, (B, S, CFG.d_model), seed=3)
        got = pattn.attention_forward(tx, _layer0(pp["blocks"]["attn"]), CFG)
        ref = jattn.attention_forward(jx, _layer0(jp["blocks"]["attn"]), JCFG,
                                      mask_kind="causal", q_chunk=16)
        assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (B, S, CFG.d_model)
        _close(got, ref, BAR[name])
        if name == "bfloat16":  # R7: the reference rounds logits and probabilities
            ap32 = jax.tree.map(lambda a: a.astype(jnp.float32), _layer0(jp["blocks"]["attn"]))
            exact = _f32(jattn.attention_forward(jx.astype(jnp.float32), ap32, JCFG,
                                                 mask_kind="causal", q_chunk=16))
            assert np.abs(_f32(got) - exact).max() <= np.abs(_f32(ref) - exact).max()

    def test_attention_forward_waits_for_other_masks(self, model):
        """The full mask and cross attention (``kv_input`` of T 40 != S 8),
        which waited for the vlm and audio families, compute as the
        reference's, with and without RoPE; an unknown mask raises (the
        sliding mask: tests/test_torch_sliding_lm.py)."""
        name, jp, pp = model
        jx, tx = _acts(name, (B, 8, CFG.d_model), seed=4)
        jsrc, tsrc = _acts(name, (B, 40, CFG.d_model), seed=5)
        ap, jap = _layer0(pp["blocks"]["attn"]), _layer0(jp["blocks"]["attn"])
        for cross in (False, True):
            for use_rope in (True, False):
                got = pattn.attention_forward(tx, ap, CFG, mask_kind="full", use_rope=use_rope,
                                              kv_input=tsrc if cross else None)
                ref = jattn.attention_forward(jx, jap, JCFG, mask_kind="full", use_rope=use_rope,
                                              kv_input=jsrc if cross else None, q_chunk=4)
                assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (B, 8, CFG.d_model)
                _close(got, ref, BAR[name], f"cross {cross} rope {use_rope}")
        with pytest.raises(ValueError, match="mask_kind"):
            pattn.attention_forward(tx, ap, CFG, mask_kind="diagonal")

    @pytest.mark.parametrize("pos", [0, 13, 40])
    def test_decode_attention(self, model, pos):
        """Output and both cache leaves, before and after the ring wraps
        (window 24: positions 0, 13 and 40 -> slots 0, 13, 16)."""
        name, jp, pp = model
        jdt = DTYPES[name][0]
        jx, tx = _acts(name, (B, 1, CFG.d_model), seed=5)
        window = 24
        rng = np.random.default_rng(6)
        shape = (B, window, CFG.n_kv_heads, CFG.head_dim_)
        cache = {k: jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
                 for k in ("k", "v")}
        jpos = jnp.asarray(pos, jnp.int32)
        y_ref, c_ref = jattn.decode_attention(jx, _layer0(jp["blocks"]["attn"]), cache, jpos, JCFG)
        pcache = _to_port(cache)
        y, c = pattn.decode_attention(tx, _layer0(pp["blocks"]["attn"]), pcache,
                                      torch.tensor(pos, dtype=torch.int32), CFG)
        assert c["k"] is pcache["k"] and c["v"] is pcache["v"], "slot written in place"
        _close(y, y_ref, BAR[name])
        for k in ("k", "v"):
            _close(c[k], c_ref[k], BAR[name], k)

    @pytest.mark.parametrize("s,w", [(20, 32), (32, 32), (40, 16)])
    def test_ring_pack(self, s, w):
        x = np.random.default_rng(7).standard_normal((3, s, 2, 4)).astype(np.float32)
        got = plm.LM(CFG)._ring_pack(torch.from_numpy(x), s, w)
        ref = jlm.LM(JCFG)._ring_pack(jnp.asarray(x), s, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        stacked = np.stack([x, 2 * x])
        got = plm.LM(CFG)._ring_pack_stacked(torch.from_numpy(stacked), s, w)
        ref = jlm.LM(JCFG)._ring_pack_stacked(jnp.asarray(stacked), s, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _prompt(seed, s=S):
    toks = np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, s))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks).to(torch.int32)


def _compare_cache(got, ref, name):
    got_np = cache_to_numpy(got)
    ref_np = jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                          else np.asarray(a), ref)
    assert int(got_np["pos"]) == int(ref_np["pos"])
    assert got_np["pos"].dtype == ref_np["pos"].dtype
    assert got_np["layers"].keys() == ref_np["layers"].keys()
    for k, v in ref_np["layers"].items():
        g = got_np["layers"][k]
        assert g.shape == v.shape and g.dtype == v.dtype, k
        _close(g, v, BAR[name], k)


class TestLM:
    def test_init_cache_layout(self):
        got = plm.LM(CFG).init_cache(B, S + 8, torch.bfloat16, device="cpu")
        ref = jlm.LM(JCFG).init_cache(B, S + 8)
        assert got["pos"].shape == () and got["pos"].dtype == torch.int32
        assert got["layers"].keys() == ref["layers"].keys()
        for k, v in ref["layers"].items():
            assert tuple(got["layers"][k].shape) == v.shape, k
            assert str(got["layers"][k].dtype).split(".")[-1] == str(v.dtype), k
            assert not got["layers"][k].any()

    def test_prefill(self, model):
        name, jp, pp = model
        jt, tt = _prompt(8)
        logits_ref, cache_ref = jax.jit(
            lambda p, t: jlm.LM(JCFG).prefill_fn(p, {"tokens": t}, max_seq=S + 8, flags=FLAGS)
        )(jp, jt)
        logits, cache = plm.LM(CFG).prefill_fn(pp, {"tokens": tt}, max_seq=S + 8)
        assert tuple(logits.shape) == (B, CFG.vocab_size)
        _close(logits, logits_ref, BAR[name])
        _compare_cache(cache, cache_ref, name)

    def test_decode_steps(self, model):
        """Three decode steps from the prefill cache, teacher-forced with
        the same numpy tokens on both sides; logits at every step and every
        cache leaf at the end."""
        name, jp, pp = model
        jt, tt = _prompt(9)
        jlm_, plm_ = jlm.LM(JCFG), plm.LM(CFG)
        _, jcache = jlm_.prefill_fn(jp, {"tokens": jt}, max_seq=S + 8, flags=FLAGS)
        _, pcache = plm_.prefill_fn(pp, {"tokens": tt}, max_seq=S + 8)
        ptrs = {k: t.data_ptr() for k, t in pcommon.tree_leaves(pcache)}
        jdec = jax.jit(lambda p, c, t: jlm_.decode_fn(p, c, t, FLAGS))
        forced = np.random.default_rng(10).integers(0, CFG.vocab_size, (3, B, 1))
        for step in range(3):
            lj, jcache = jdec(jp, jcache, jnp.asarray(forced[step], jnp.int32))
            lt, pcache = plm_.decode_fn(pp, pcache, torch.from_numpy(forced[step]).int())
            assert tuple(lt.shape) == (B, CFG.vocab_size)
            # the cache is donated: k, v and pos are written in place
            assert {k: t.data_ptr() for k, t in pcommon.tree_leaves(pcache)} == ptrs
            _close(lt, lj, BAR[name], f"step {step}")
        _compare_cache(pcache, jcache, name)
        assert int(pcache["pos"]) == S + 3

    def test_decode_matches_prefill(self, model):
        """Decoding token S against the cache of S tokens gives the logits
        of a prefill over S + 1 tokens (the reference's own bar)."""
        name, _, pp = model
        _, toks = _prompt(11, s=S + 1)
        lm = plm.LM(CFG)
        _, cache = lm.prefill_fn(pp, {"tokens": toks[:, :S]}, max_seq=S + 4)
        dec, _ = lm.decode_fn(pp, cache, toks[:, S:S + 1])
        ref, _ = lm.prefill_fn(pp, {"tokens": toks}, max_seq=S + 4)
        _close(dec, ref, 0.15)


def test_checkpoint_round_trip(tmp_path):
    """The dense schema's weights and KV cache cross the flat-key npz store:
    JAX save -> port restore -> port save -> JAX restore, byte for byte."""
    lm = jlm.LM(JCFG)
    params = lm.init(jax.random.PRNGKey(1), jnp.bfloat16)
    toks = jnp.asarray(np.random.default_rng(12).integers(0, JCFG.vocab_size, (B, 16)),
                       jnp.int32)
    _, cache = lm.prefill_fn(params, {"tokens": toks}, max_seq=24, flags=FLAGS)
    tree = {"params": params, "cache": cache}
    jstore.save(str(tmp_path / "jax"), 5, tree)
    plm_ = plm.LM(CFG)
    target = {"params": plm_.init(prng.PRNGKey(0), torch.bfloat16, "cpu"),
              "cache": plm_.init_cache(B, 24, torch.bfloat16, device="cpu")}
    got, step, _ = pstore.restore(str(tmp_path / "jax"), target)
    assert step == 5 and got["cache"]["layers"]["k"].dtype == torch.bfloat16
    pstore.save(str(tmp_path / "port"), 5, got)
    back, _, _ = jstore.restore(str(tmp_path / "port"), tree)
    for (path, want), leaf in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                  jax.tree.leaves(back)):
        want, leaf = np.asarray(want), np.asarray(leaf)
        assert (leaf.dtype, leaf.shape, leaf.tobytes()) == (want.dtype, want.shape,
                                                            want.tobytes()), path
