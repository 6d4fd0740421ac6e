"""The port's serving entry point and step functions (``repro_torch.launch``)
against the JAX reference (``repro.launch``) on the CPU, at the REDUCED
configs of ``mamba2_130m`` and ``llama32_1b``.

* ``serve_batch`` with the reference's weights for the same seed (carried
  across by ``repro_torch.models.convert``) and the same seed, hence the
  same prompts: first-step logits at the bf16 bar (0.15, as
  ``tests/test_models.py::TestDecodeMatchesPrefill``).
* In float32, both packages driven through their ``steps.py`` functions
  with greedy sampling: every generated token identical.
* ``greedy=False`` (temperature 0.8) from the seed alone: every token the
  reference's ``serve_batch``'s, in bf16 and in float32; the weights made
  from the seed are the reference's ``LM.init(PRNGKey(seed))``.
* A call without ``device`` where CUDA is absent raises.
* The decode runner (``serve._DecodeRunner``) on the CPU steps eagerly:
  bit-equal to a plain loop of ``decode_fn`` over its own cache, which it
  updates in place; ``_graph=True`` on the CPU raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.launch import serve as pserve
from repro_torch.launch import steps as psteps
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models import lm as plm
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

CFG = get_config("mamba2-130m", reduced=True)
JCFG = jax_get_config("mamba2-130m", reduced=True)
LLAMA = get_config("llama3.2-1b", reduced=True)
JLLAMA = jax_get_config("llama3.2-1b", reduced=True)
BF16_BAR = 0.15


def _carried(seed, jdt, jcfg=JCFG):
    jparams = jlm.LM(jcfg).init(jax.random.PRNGKey(seed), jdt)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


class TestServeBatch:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_matches_reference_serve_batch(self, seed):
        batch, prompt_len, gen = 2, 32, 4
        ref = jserve.serve_batch(JCFG, batch, prompt_len, gen, seed)
        jparams, pparams = _carried(seed, jnp.bfloat16)  # what serve_batch initialises
        got = pserve.serve_batch(CFG, batch, prompt_len, gen, seed, params=pparams,
                                 device="cpu")
        assert set(got) >= {"generated", "prefill_s", "decode_s", "decode_tok_per_s",
                            "prefill_tok_per_s"}
        assert got["generated"].shape == ref["generated"].shape == (batch, gen)
        assert got["generated"].dtype == np.int32
        assert ((got["generated"] >= 0) & (got["generated"] < CFG.vocab_size)).all()
        assert tuple(got["logits"].shape) == (batch, gen, CFG.vocab_size)
        # the reference's first-step logits on the same prompts
        prompts = np.random.default_rng(seed).integers(0, JCFG.vocab_size, (batch, prompt_len))
        first, _ = jlm.LM(JCFG).prefill_fn(
            jparams, {"tokens": jnp.asarray(prompts, jnp.int32)}, max_seq=prompt_len + gen,
            flags=jlm.RunFlags(remat="none", q_chunk=min(512, prompt_len)))
        first = np.asarray(first, np.float32)
        np.testing.assert_array_equal(ref["generated"][:, 0], first.argmax(-1))
        np.testing.assert_allclose(got["logits"][:, 0].float().numpy(), first,
                                   atol=BF16_BAR, rtol=BF16_BAR)

    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("family", ["ssm", "dense"])
    def test_sampling_waits_for_threefry(self, family, seed):
        """Sampled serving (``greedy=False``, temperature 0.8) from the seed
        alone: the reference's weights (bf16, ``PRNGKey(seed)``) and the
        reference's draws (the first token from ``PRNGKey(seed)``, each
        later one from a split of it), so every token equals the
        reference's ``serve_batch``."""
        cfg, jcfg = FAMILIES[family]
        ref = jserve.serve_batch(jcfg, 2, 16, 8, seed, greedy=False, temperature=0.8)
        got = pserve.serve_batch(cfg, 2, 16, 8, seed, greedy=False, temperature=0.8,
                                 device="cpu")
        assert got["generated"].dtype == np.int32
        np.testing.assert_array_equal(got["generated"], ref["generated"])
        greedy = pserve.serve_batch(cfg, 2, 16, 8, seed, device="cpu")
        assert not np.array_equal(greedy["generated"], got["generated"])

    @pytest.mark.parametrize("family", ["ssm", "dense"])
    def test_sampling_float32_matches_reference(self, family, monkeypatch):
        """The same in float32: the reference's server with its weights
        made in float32 (its ``LM`` subclassed in this test) against the
        port's ``dtype=torch.float32``."""
        cfg, jcfg = FAMILIES[family]

        class Float32LM(jlm.LM):
            def init(self, key, dtype=jnp.float32):
                return super().init(key, jnp.float32)

        monkeypatch.setattr(jserve, "LM", Float32LM)
        ref = jserve.serve_batch(jcfg, 2, 16, 8, 3, greedy=False, temperature=0.8)
        got = pserve.serve_batch(cfg, 2, 16, 8, 3, greedy=False, temperature=0.8,
                                 device="cpu", dtype=torch.float32)
        np.testing.assert_array_equal(got["generated"], ref["generated"])

    def test_no_device_means_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour where CUDA is absent")
        with pytest.raises(RuntimeError, match="CUDA"):
            pserve.serve_batch(CFG, 2, 8, 2)

    def test_llama_matches_reference_first_step(self):
        """The dense family through serve_batch: the reference's weights and
        prompts for seed 0, first-step logits at the bf16 bar."""
        batch, prompt_len, gen = 2, 32, 4
        jparams, pparams = _carried(0, jnp.bfloat16, JLLAMA)
        got = pserve.serve_batch(LLAMA, batch, prompt_len, gen, 0, params=pparams,
                                 device="cpu")
        assert got["generated"].shape == (batch, gen)
        assert ((got["generated"] >= 0) & (got["generated"] < LLAMA.vocab_size)).all()
        prompts = np.random.default_rng(0).integers(0, JLLAMA.vocab_size, (batch, prompt_len))
        first, _ = jlm.LM(JLLAMA).prefill_fn(
            jparams, {"tokens": jnp.asarray(prompts, jnp.int32)}, max_seq=prompt_len + gen,
            flags=jlm.RunFlags(remat="none", q_chunk=min(512, prompt_len)))
        np.testing.assert_allclose(got["logits"][:, 0].float().numpy(),
                                   np.asarray(first, np.float32), atol=BF16_BAR, rtol=BF16_BAR)

    def test_cli_serves_llama_reduced_on_cpu(self, monkeypatch, capsys):
        monkeypatch.setattr("sys.argv", ["serve", "--arch", "llama3.2-1b", "--reduced",
                                         "--batch", "2", "--prompt-len", "16", "--gen", "3",
                                         "--device", "cpu"])
        pserve.main()
        out = capsys.readouterr().out
        assert "[serve] llama32-1b-reduced: prefill" in out and "sample tokens" in out

    def test_own_weights_are_seeded(self):
        a = pserve.serve_batch(CFG, 2, 16, 3, seed=1, device="cpu")
        b = pserve.serve_batch(CFG, 2, 16, 3, seed=1, device="cpu")
        np.testing.assert_array_equal(a["generated"], b["generated"])
        assert torch.equal(a["logits"], b["logits"])

    @pytest.mark.parametrize("family", ["ssm", "dense"])
    def test_own_weights_are_the_references(self, family):
        """The weights serve_batch makes from ``seed`` are the reference's
        ``LM.init(PRNGKey(seed))``, leaf by leaf: float32 within 2 ulp
        (exact here) and bf16 identical after the cast; so the served
        first-step logits equal those served from the carried weights."""
        cfg, jcfg = FAMILIES[family]
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            ref = jlm.LM(jcfg).init(jax.random.PRNGKey(4), jdt)
            got = plm.LM(cfg).init(prng.PRNGKey(4), tdt, "cpu")
            for (k, t), r in zip(tree_leaves(got), jax.tree.leaves(ref)):
                r = np.asarray(r)
                assert t.dtype == tdt and tuple(t.shape) == r.shape, k
                if tdt == torch.float32:
                    ulps = np.abs(t.numpy().view(np.int32).astype(np.int64)
                                  - r.view(np.int32).astype(np.int64))
                    assert ulps.max(initial=0) <= 2, k
                else:
                    np.testing.assert_array_equal(t.view(torch.int16).numpy(), r.view(np.int16),
                                                  err_msg=k)
        _, carried = _carried(4, jnp.bfloat16, jcfg)
        own = pserve.serve_batch(cfg, 2, 16, 2, seed=4, device="cpu")
        with_carried = pserve.serve_batch(cfg, 2, 16, 2, seed=4, params=carried, device="cpu")
        assert torch.equal(own["logits"], with_carried["logits"])


def _tokens_identical(cfg, jcfg):
    """batch 2, prompt 32, gen 8, greedy, float32 weights: the two
    packages' step functions pick the same token at every step, and
    serve_batch takes the same path."""
    batch, prompt_len, gen = 2, 32, 8
    jparams, pparams = _carried(0, jnp.float32, jcfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt_len))

    jflags = jlm.RunFlags(remat="none", q_chunk=min(512, prompt_len))
    jlm_ = jlm.LM(jcfg)
    jprefill = jax.jit(jsteps.make_prefill_step(jlm_, prompt_len + gen, jflags))
    jdecode = jax.jit(jsteps.make_serve_step(jlm_, jflags))
    logits, cache = jprefill(jparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ref = [tok]
    for _ in range(gen - 1):
        logits, cache = jdecode(jparams, cache, tok)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        ref.append(tok)
    ref = np.concatenate([np.asarray(t) for t in ref], axis=1)

    pflags = plm.RunFlags(remat="none", q_chunk=min(512, prompt_len))
    plm_ = plm.LM(cfg)
    pprefill = psteps.make_prefill_step(plm_, prompt_len + gen, pflags)
    pdecode = psteps.make_serve_step(plm_, pflags)
    logits, cache = pprefill(pparams, {"tokens": torch.from_numpy(prompts).int()})
    tok = torch.argmax(logits, -1)[:, None].int()
    got = [tok]
    for _ in range(gen - 1):
        logits, cache = pdecode(pparams, cache, tok)
        tok = torch.argmax(logits, -1)[:, None].int()
        got.append(tok)
    got = torch.cat(got, dim=1).numpy()
    np.testing.assert_array_equal(got, ref)
    # and serve_batch takes the same path, through its decode runner, with
    # _graph left to the device and with _graph=False
    for graph in (None, False):
        served = pserve.serve_batch(cfg, batch, prompt_len, gen, 0, params=pparams,
                                    device="cpu", _graph=graph)
        np.testing.assert_array_equal(served["generated"], ref)
        assert served["capture_s"] == 0.0


class TestStepsFloat32:
    def test_generated_tokens_identical(self):
        _tokens_identical(CFG, JCFG)

    def test_llama_generated_tokens_identical(self):
        _tokens_identical(LLAMA, JLLAMA)


FAMILIES = {"ssm": (CFG, JCFG), "dense": (LLAMA, JLLAMA)}


class TestDecodeRunner:
    @pytest.mark.parametrize("family", list(FAMILIES))
    def test_runner_matches_decode_loop(self, family):
        """The runner's eager steps on the CPU against a plain greedy loop of
        ``decode_fn`` from a clone of the same prefill cache: every token and
        logit bit-equal, the runner's cache updated in place (the same
        tensors, pos advanced), no SSD kernel launch counted."""
        from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda

        cfg, jcfg = FAMILIES[family]
        _, pparams = _carried(0, jnp.float32, jcfg)
        lm = plm.LM(cfg)
        flags = plm.RunFlags(remat="none", q_chunk=16)
        prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
        logits, cache = psteps.make_prefill_step(lm, 24, flags)(
            pparams, {"tokens": torch.from_numpy(prompts).int()})
        plain = tree_map(lambda t: t.clone(), cache)
        decode = psteps.make_serve_step(lm, flags)
        tok = torch.argmax(logits, -1)[:, None].int()
        launches = ssd_decode_step_cuda.launches
        runner = pserve._DecodeRunner(decode, pparams, cache, tok)
        ptrs = [t.data_ptr() for _, t in tree_leaves(cache)]
        for _ in range(5):
            got_logits, got_tok = runner.step()
            want_logits, plain = decode(pparams, plain, tok)
            tok = torch.argmax(want_logits, -1)[:, None].int()
            assert torch.equal(got_logits, want_logits) and torch.equal(got_tok, tok)
        assert runner.cache is cache and [t.data_ptr() for _, t in tree_leaves(cache)] == ptrs
        assert int(cache["pos"]) == 16 + 5
        assert runner.graph is None and runner.timing == {}
        assert ssd_decode_step_cuda.launches == launches

    @pytest.mark.parametrize("family", list(FAMILIES))
    def test_graph_on_cpu_raises(self, family):
        cfg, _ = FAMILIES[family]
        with pytest.raises(ValueError, match="CUDA"):
            pserve.serve_batch(cfg, 2, 8, 3, device="cpu", _graph=True)
        with pytest.raises(ValueError, match="CUDA"):
            pserve._DecodeRunner(None, None, None, torch.zeros((2, 1), dtype=torch.int32),
                                 graph=True)

