"""The port's threefry (``repro_torch.prng``) against ``jax.random`` (jax's
default threefry2x32, partitionable layout) in the same process, on the
CPU: seeds 0-3, shapes (), (1,), (7,), (3, 5) and (1000,), single keys and
keys batched over a leading axis (``jax.vmap`` on the reference's side).

Bars: every function's output is the reference's bit for bit (uint32
words, float32 bit patterns, int32 values), ``normal`` and ``erf_inv``
within 2 ulp of the reference (they are exact here too: the port computes
XLA's ``log1p``/``log`` polynomials with its fused multiply-adds), and the
reduced llama config's bf16 weights from ``PRNGKey(s)`` identical after
the cast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.trace import PAPER_GPU_DISTRIBUTION as JAX_GPU_DISTRIBUTION
from repro.models import lm as jlm
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.core.trace import PAPER_GPU_DISTRIBUTION
from repro_torch.models import lm as plm
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

SEEDS = (0, 1, 2, 3)
SHAPES = ((), (1,), (7,), (3, 5), (1000,))


def _key(seed):
    return prng.PRNGKey(seed, "cpu")


def _keys(seed, n=3):
    """(jax keys, port keys) batched over a leading axis of n."""
    jk = jax.random.split(jax.random.PRNGKey(seed + 100), n)
    return jk, prng.split(_key(seed + 100), n)


def _bits(a):
    """Integer view of an array for bit-exact comparison."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32).astype(np.int64)
    return a.astype(np.int64)


def _eq(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref), (what, got.shape, np.shape(ref))
    np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=what)


def _ulps(got, ref):
    return np.abs(_bits(got.numpy()) - _bits(ref))


class TestKeys:
    @pytest.mark.parametrize("seed", SEEDS + (2**31 + 5, 2**40 + 7))
    def test_prng_key(self, seed):
        _eq(_key(seed), jax.random.PRNGKey(seed), "PRNGKey")

    @pytest.mark.parametrize("n", [2, 4, 7])
    @pytest.mark.parametrize("seed", SEEDS)
    def test_split(self, seed, n):
        _eq(prng.split(_key(seed), n), jax.random.split(jax.random.PRNGKey(seed), n), "split")
        jk, pk = _keys(seed)
        _eq(prng.split(pk, n), jax.vmap(lambda k: jax.random.split(k, n))(jk), "split batched")

    @pytest.mark.parametrize("data", [0, 1, 2**31 + 5])
    @pytest.mark.parametrize("seed", SEEDS)
    def test_fold_in(self, seed, data):
        _eq(prng.fold_in(_key(seed), data),
            jax.random.fold_in(jax.random.PRNGKey(seed), data), "fold_in")
        jk, pk = _keys(seed)
        _eq(prng.fold_in(pk, data), jax.vmap(lambda k: jax.random.fold_in(k, data))(jk),
            "fold_in batched")
        per_lane = np.array([data, 7, 12345], np.uint32)
        _eq(prng.fold_in(pk, torch.from_numpy(per_lane.astype(np.int64))),
            jax.vmap(jax.random.fold_in)(jk, jnp.asarray(per_lane)), "fold_in per lane")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
class TestSamplers:
    def test_random_bits(self, seed, shape):
        _eq(prng.random_bits(_key(seed), shape), jax.random.bits(jax.random.PRNGKey(seed), shape),
            "bits")
        jk, pk = _keys(seed)
        _eq(prng.random_bits(pk, shape), jax.vmap(lambda k: jax.random.bits(k, shape))(jk),
            "bits batched")

    @pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (1.0, 1200.0)])
    def test_uniform(self, seed, shape, lo, hi):
        ref = jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi)
        _eq(prng.uniform(_key(seed), shape, minval=lo, maxval=hi), ref, "uniform")
        jk, pk = _keys(seed)
        _eq(prng.uniform(pk, shape, minval=lo, maxval=hi),
            jax.vmap(lambda k: jax.random.uniform(k, shape, minval=lo, maxval=hi))(jk),
            "uniform batched")

    @pytest.mark.parametrize("lo, hi", [(1000, 6001), (0, 4), (0, 6), (-5, 2**25 + 3)])
    def test_randint(self, seed, shape, lo, hi):
        """The ranges sample_trace draws, and one wider than 2**24."""
        ref = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi)
        _eq(prng.randint(_key(seed), shape, lo, hi), ref, "randint")
        jk, pk = _keys(seed)
        _eq(prng.randint(pk, shape, lo, hi),
            jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(jk), "randint batched")

    def test_choice_paper_distribution(self, seed, shape):
        total = sum(c for _, c in PAPER_GPU_DISTRIBUTION)
        assert PAPER_GPU_DISTRIBUTION == JAX_GPU_DISTRIBUTION
        a = np.array([g for g, _ in PAPER_GPU_DISTRIBUTION], np.int32)
        p = np.array([c / total for _, c in PAPER_GPU_DISTRIBUTION], np.float32)
        ref = jax.random.choice(jax.random.PRNGKey(seed), jnp.asarray(a), shape,
                                p=jnp.asarray(p))
        _eq(prng.choice(_key(seed), torch.from_numpy(a), shape, p=torch.from_numpy(p)), ref,
            "choice")
        jk, pk = _keys(seed)
        _eq(prng.choice(pk, torch.from_numpy(a), shape, p=torch.from_numpy(p)),
            jax.vmap(lambda k: jax.random.choice(k, jnp.asarray(a), shape,
                                                 p=jnp.asarray(p)))(jk), "choice batched")

    def test_normal_within_2_ulp(self, seed, shape):
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.normal(_key(seed), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        assert _ulps(got, ref).max(initial=0) <= 2
        jk, pk = _keys(seed)
        ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(jk))
        assert _ulps(prng.normal(pk, shape), ref).max(initial=0) <= 2

    def test_gumbel(self, seed, shape):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape, jdt))
            got = prng.gumbel(_key(seed), shape, tdt)
            np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))


class TestCategoricalAndNormal:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("seed", SEEDS)
    def test_categorical(self, seed, dtype):
        logits = np.random.default_rng(seed).standard_normal((4, 1000)).astype(np.float32)
        jl = jnp.asarray(logits, dtype)
        tl = torch.from_numpy(logits).to(getattr(torch, dtype))
        _eq(prng.categorical(_key(seed), tl), jax.random.categorical(jax.random.PRNGKey(seed), jl),
            "categorical")
        _eq(prng.categorical(_key(seed), tl, axis=0),
            jax.random.categorical(jax.random.PRNGKey(seed), jl, axis=0), "categorical axis 0")
        jk, pk = _keys(seed, 4)
        _eq(prng.categorical(pk, tl), jax.vmap(jax.random.categorical)(jk, jl),
            "categorical batched")

    def test_erf_inv_and_normal_over_a_million(self):
        """erf_inv on a million uniform draws of (-1, 1) and its edges, and
        a million-element normal draw (more than one slice of counters when
        the slice is cut): within 2 ulp (exact here)."""
        u = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (10**6,),
                                          minval=np.nextafter(np.float32(-1), np.float32(0)),
                                          maxval=1.0))
        u = np.concatenate([u, np.float32([0.0, -0.0, 1.0, -1.0, 0.5, 1e-30, 0.99999994])])
        ref = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
        got = prng.erf_inv(torch.from_numpy(u.copy()))
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
        finite = np.isfinite(ref)
        assert _ulps(got, ref)[finite].max() <= 2
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (10**6,)))
        assert _ulps(prng.normal(_key(4), (10**6,)), ref).max() <= 2

    def test_slices_of_the_counter_space(self, monkeypatch):
        """A draw larger than the slice runs in slices and gives the same
        bits as one slice."""
        whole_bits = prng.random_bits(_key(1), (5, 13))
        whole_normal = prng.normal(_key(1), (5, 13))
        monkeypatch.setattr(prng, "SLICE", 8)
        assert torch.equal(prng.random_bits(_key(1), (5, 13)), whole_bits)
        assert torch.equal(prng.normal(_key(1), (5, 13)), whole_normal)

    def test_reduced_llama_bf16_weights(self):
        """The reduced llama config's bf16 weights from PRNGKey(s): the
        number of weights that differ from the reference's after the cast
        (0 here)."""
        cfg, jcfg = get_config("llama3.2-1b", reduced=True), jax_get_config("llama3.2-1b",
                                                                            reduced=True)
        ref = jlm.LM(jcfg).init(jax.random.PRNGKey(2), jnp.bfloat16)
        got = plm.LM(cfg).init(prng.PRNGKey(2), torch.bfloat16, "cpu")
        differ = 0
        for (name, t), r in zip(tree_leaves(got), jax.tree.leaves(ref)):
            r = np.asarray(r)
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == r.shape, name
            differ += int((t.view(torch.int16).numpy() != r.view(np.int16)).sum())
        print(f"reduced llama bf16 weights that differ after the cast: {differ}")
        assert differ == 0
