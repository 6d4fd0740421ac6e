"""The port's ``ssm`` language model (``repro_torch.models``) against the
JAX reference (``repro.models``) on the CPU, at ``mamba2_130m``'s REDUCED
config (2 layers, d_model 128), with the reference's weights
(``LM(cfg).init(PRNGKey(0), dtype)``) carried across by
``repro_torch.models.convert``.  Activations are made with numpy from a
seed.

Bars: float32 logits and activations at ``rtol=atol=1e-4``, float32 SSM
states at 1e-5 (same operations, sums taken in another order); bfloat16 at
0.15, the bar ``tests/test_models.py::TestDecodeMatchesPrefill`` holds
between two JAX paths (bf16 rounds at other places in the two frameworks).
Conv caches are copies of pre-conv activations: equal to the same bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.models import ssm as pssm
from repro_torch.models.convert import cache_to_numpy, params_from_numpy

torch.set_num_threads(1)

CFG = get_config("mamba2-130m", reduced=True)
JCFG = jax_get_config("mamba2-130m", reduced=True)
B, S = 2, 32
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLAGS = jlm.RunFlags(remat="none", q_chunk=16)
BAR = {"float32": dict(logits=1e-4, state=1e-5), "bfloat16": dict(logits=0.15, state=0.15)}


@pytest.fixture(scope="module", params=list(DTYPES))
def model(request):
    """(dtype name, JAX params, port params) with the same weights."""
    name = request.param
    jdt, tdt = DTYPES[name]
    jparams = jlm.LM(JCFG).init(jax.random.PRNGKey(0), jdt)
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert pparams["embed"].dtype == tdt
    return name, jparams, pparams


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol, err_msg=what)


def _acts(name, shape, seed=0, scale=1.0):
    jdt, tdt = DTYPES[name]
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _layer0(tree):
    """Layer 0 of a stacked tree (JAX arrays or tensors)."""
    return jax.tree.map(lambda a: a[0], tree)


class TestConfig:
    def test_config_copy(self):
        for reduced in (False, True):
            got = get_config("mamba2_130m", reduced=reduced)
            ref = jax_get_config("mamba2_130m", reduced=reduced)
            for field in ("name", "family", "n_layers", "d_model", "vocab_size", "ssm_state",
                          "ssm_head_dim", "ssm_expand", "ssm_conv_width", "ssm_chunk",
                          "source", "dtype"):
                assert getattr(got, field) == getattr(ref, field), field
            assert (got.padded_vocab, got.ssm_d_inner, got.ssm_n_heads) == (
                ref.padded_vocab, ref.ssm_d_inner, ref.ssm_n_heads)
            assert got.param_count() == ref.param_count()
            assert got.param_count(padded=True) == ref.param_count(padded=True)

    def test_other_archs_raise(self):
        """The zoo's archs have configs (their counts feed the model zoo),
        but the port serves no model of them; the other archs have none."""
        from repro_torch.configs import served_config

        assert get_config("olmoe-1b-7b").family == "moe"
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            plm.LM(get_config("olmoe-1b-7b"))
        for arch in ("olmoe-1b-7b", "gemma-7b", "yi-9b", "phi4-mini-3.8b"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                served_config(arch)
        assert served_config("mamba2-130m") is get_config("mamba2-130m")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config("jamba-v0.1-52b")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config("no-such-arch")

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
                params_from_numpy(jax.tree.map(np.asarray, ref)))):
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, k
            assert torch.equal(a, b), k
        ssm = p["blocks"]["ssm"]
        assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
        assert torch.equal(ssm["A_log"], torch.zeros_like(ssm["A_log"]))
        std = float(ssm["out_proj"].std())
        assert abs(std - 0.5 / np.sqrt(CFG.ssm_d_inner)) < 0.05 * std
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            plm.LM(_moe_config())


def _moe_config():
    """A family the port does not serve yet."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(name="moe-x", family="moe", n_layers=2, d_model=64, vocab_size=128,
                       n_heads=4, n_kv_heads=4)


class TestLayers:
    def test_rms_norm(self, model):
        name, jp, pp = model
        jx, tx = _acts(name, (B, S, CFG.d_model), seed=1)
        got = pcommon.rms_norm(tx, pp["final_norm"])
        ref = jcommon.rms_norm(jx, jp["final_norm"])
        assert got.dtype == DTYPES[name][1]
        _close(got, ref, 1e-5 if name == "float32" else BAR[name]["logits"])

    def test_causal_conv_and_step(self, model):
        name, jp, pp = model
        js, ts = _layer0(jp["blocks"]["ssm"]), _layer0(pp["blocks"]["ssm"])
        di, w = CFG.ssm_d_inner, CFG.ssm_conv_width
        jx, tx = _acts(name, (B, S, di), seed=2)
        tol = 1e-5 if name == "float32" else BAR[name]["logits"]
        _close(pssm.causal_conv(tx, ts["conv_x"], ts["conv_bias_x"]),
               jssm.causal_conv(jx, js["conv_x"], js["conv_bias_x"]), tol)
        jst, tst = _acts(name, (B, di, w - 1), seed=3)
        y, st = pssm.conv_step(tx[:, 0], tst, ts["conv_x"], ts["conv_bias_x"])
        y_ref, st_ref = jssm.conv_step(jx[:, 0], jst, js["conv_x"], js["conv_bias_x"])
        _close(y, y_ref, tol)
        np.testing.assert_array_equal(_f32(st), _f32(st_ref))

    def test_ssm_forward(self, model):
        name, jp, pp = model
        js, ts = _layer0(jp["blocks"]["ssm"]), _layer0(pp["blocks"]["ssm"])
        jx, tx = _acts(name, (B, S, CFG.d_model), seed=4)
        _close(pssm.ssm_forward(tx, ts, CFG), jssm.ssm_forward(jx, js, JCFG),
               BAR[name]["logits"])

    def test_ssm_decode_step(self, model):
        name, jp, pp = model
        js, ts = _layer0(jp["blocks"]["ssm"]), _layer0(pp["blocks"]["ssm"])
        jx, tx = _acts(name, (B, 1, CFG.d_model), seed=5)
        rng = np.random.default_rng(6)
        cache = jssm.init_ssm_cache(JCFG, B, DTYPES[name][0])
        cache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.5, v.dtype)
                 for k, v in cache.items()}
        pcache = params_from_numpy(jax.tree.map(np.asarray, cache))
        given = dict(pcache)
        y, nc = pssm.ssm_decode_step(tx, ts, pcache, CFG)
        y_ref, nc_ref = jssm.ssm_decode_step(jx, js, cache, JCFG)
        _close(y, y_ref, BAR[name]["logits"])
        for k in nc_ref:
            assert nc[k] is given[k], f"{k} is updated in place"
            _close(nc[k], nc_ref[k], BAR[name]["state"], k)


def _prompt(seed, s=S, vocab=None):
    toks = np.random.default_rng(seed).integers(0, vocab or CFG.vocab_size, (B, s))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks).to(torch.int32)


def _compare_cache(got, ref, name):
    got_np, ref_np = cache_to_numpy(got), jax.tree.map(lambda a: np.asarray(a, np.float32)
                                                       if a.dtype == jnp.bfloat16 else
                                                       np.asarray(a), ref)
    assert int(got_np["pos"]) == int(ref_np["pos"])
    assert got_np["pos"].dtype == ref_np["pos"].dtype
    for k, v in ref_np["layers"].items():
        g = got_np["layers"][k]
        assert g.shape == v.shape and g.dtype == v.dtype, k
        tol = BAR[name]["state"] if k == "state" else BAR[name]["logits"]
        np.testing.assert_allclose(g, v, atol=tol, rtol=tol, err_msg=k)


class TestLM:
    def test_init_cache_layout(self):
        got = plm.LM(CFG).init_cache(B, S + 8, torch.bfloat16)
        ref = jlm.LM(JCFG).init_cache(B, S + 8)
        assert got["pos"].shape == () and got["pos"].dtype == torch.int32
        for k, v in ref["layers"].items():
            assert tuple(got["layers"][k].shape) == v.shape, k
            assert str(got["layers"][k].dtype).split(".")[-1] == str(v.dtype), k

    def test_prefill(self, model):
        name, jp, pp = model
        jt, tt = _prompt(7)
        logits_ref, cache_ref = jax.jit(
            lambda p, t: jlm.LM(JCFG).prefill_fn(p, {"tokens": t}, max_seq=S + 8, flags=FLAGS)
        )(jp, jt)
        logits, cache = plm.LM(CFG).prefill_fn(pp, {"tokens": tt}, max_seq=S + 8)
        assert tuple(logits.shape) == (B, CFG.vocab_size)
        _close(logits, logits_ref, BAR[name]["logits"])
        _compare_cache(cache, cache_ref, name)

    def test_decode_steps(self, model):
        """8 decode steps from the prefill cache, teacher-forced with the
        same numpy tokens on both sides.  The cache is donated: every step
        writes into the given cache's tensors (pos too)."""
        name, jp, pp = model
        jt, tt = _prompt(8)
        jlm_, plm_ = jlm.LM(JCFG), plm.LM(CFG)
        _, jcache = jlm_.prefill_fn(jp, {"tokens": jt}, max_seq=S + 8, flags=FLAGS)
        _, pcache = plm_.prefill_fn(pp, {"tokens": tt}, max_seq=S + 8)
        ptrs = {k: t.data_ptr() for k, t in pcommon.tree_leaves(pcache)}
        jdec = jax.jit(lambda p, c, t: jlm_.decode_fn(p, c, t, FLAGS))
        forced = np.random.default_rng(9).integers(0, CFG.vocab_size, (8, B, 1))
        for step in range(8):
            lj, jcache = jdec(jp, jcache, jnp.asarray(forced[step], jnp.int32))
            lt, pcache = plm_.decode_fn(pp, pcache, torch.from_numpy(forced[step]).int())
            assert tuple(lt.shape) == (B, CFG.vocab_size)
            assert {k: t.data_ptr() for k, t in pcommon.tree_leaves(pcache)} == ptrs
            _close(lt, lj, BAR[name]["logits"], f"step {step}")
        _compare_cache(pcache, jcache, name)
        assert int(pcache["pos"]) == S + 8

    def test_decode_matches_prefill(self, model):
        """The port's own teacher-forcing consistency: decoding token S
        against the cache of S tokens gives the logits of a prefill over
        S + 1 tokens."""
        name, _, pp = model
        _, toks = _prompt(10, s=S + 1)
        lm = plm.LM(CFG)
        _, cache = lm.prefill_fn(pp, {"tokens": toks[:, :S]}, max_seq=S + 4)
        dec, _ = lm.decode_fn(pp, cache, toks[:, S:S + 1])
        ref, _ = lm.prefill_fn(pp, {"tokens": toks}, max_seq=S + 4)
        _close(dec, ref, BAR[name]["logits"])
