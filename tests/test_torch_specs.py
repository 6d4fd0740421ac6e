"""The dry-run's inputs (``repro_torch.launch.specs``, ``InputShape``, the
models' abstract parameters and caches) against the JAX reference's, with
no allocation on either side: the reference's ``ShapeDtypeStruct`` trees
against the port's meta tensors, leaf for leaf (the same flat keys, shape
and dtype), for all ten architectures at full width and every input
shape; ``INPUT_SHAPES`` field for field, ``supports_shape`` with its
reasons word for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import config as jconfig
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs as pspecs
from repro_torch.models import attention as pattn
from repro_torch.models import config as pconfig
from repro_torch.models import lm as plm
from repro_torch.models import ssm as pssm
from repro_torch.models.common import tree_leaves

SHAPES = tuple(jconfig.INPUT_SHAPES)


def _jflat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_tree(port, ref, what):
    """Every leaf: the same flat key, shape and dtype; the port's on the
    meta device."""
    ref = _jflat(ref)
    port = dict(tree_leaves(port))
    assert sorted(port) == sorted(ref), what
    for k, r in ref.items():
        t = port[k]
        assert t.device.type == "meta", (what, k)
        assert tuple(t.shape) == tuple(r.shape), (what, k, t.shape, r.shape)
        assert str(t.dtype).replace("torch.", "") == np.dtype(r.dtype).name, (what, k, t.dtype,
                                                                              r.dtype)


def test_input_shapes():
    assert list(pconfig.INPUT_SHAPES) == list(jconfig.INPUT_SHAPES)
    for name, ref in jconfig.INPUT_SHAPES.items():
        got = pconfig.INPUT_SHAPES[name]
        assert isinstance(got, pconfig.InputShape)
        assert (got.name, got.seq_len, got.global_batch, got.kind, got.tokens) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind, ref.tokens)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_supports_shape(arch, shape):
    got = pspecs.supports_shape(get_config(arch), pconfig.INPUT_SHAPES[shape])
    assert got == jspecs.supports_shape(jax_get_config(arch), jconfig.INPUT_SHAPES[shape])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params(arch):
    """Every leaf of the full-width model, in bf16 and float32."""
    for jd, pd in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        ref = jlm.LM(jax_get_config(arch)).abstract_params(jd)
        _same_tree(plm.LM(get_config(arch)).abstract_params(pd), ref, f"{arch} params {pd}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_cache(arch, shape):
    """``train_like_specs`` (the stub embeddings included) for every shape;
    ``decode_specs`` (the abstract cache of ``seq_len`` slots, the f32 SSM
    state, the cross caches, and the token) for every shape too, as the
    reference builds them for any shape it is given."""
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    js, ps = jconfig.INPUT_SHAPES[shape], pconfig.INPUT_SHAPES[shape]
    _same_tree(pspecs.train_like_specs(pcfg, ps), jspecs.train_like_specs(jcfg, js),
               f"{arch} {shape} batch")
    (jcache, jtok), (pcache, ptok) = (jspecs.decode_specs(jlm.LM(jcfg), js),
                                      pspecs.decode_specs(plm.LM(pcfg), ps))
    _same_tree(pcache, jcache, f"{arch} {shape} cache")
    _same_tree({"t": ptok}, {"t": jtok}, f"{arch} {shape} token")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_layer_caches(arch):
    """The per-layer builders at batch 3 and window 5, float32 and bf16."""
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    for jd, pd in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        if pcfg.family != "ssm":  # no attention heads
            _same_tree(pattn.abstract_kv_cache(pcfg, 3, 5, pd),
                       jattn.abstract_kv_cache(jcfg, 3, 5, jd), f"{arch} kv")
        if pcfg.family in ("ssm", "hybrid"):
            _same_tree(pssm.abstract_ssm_cache(pcfg, 3, pd), jssm.abstract_ssm_cache(jcfg, 3, jd),
                       f"{arch} ssm")
        _same_tree(plm.LM(pcfg).abstract_cache(3, 7, pd), jlm.LM(jcfg).abstract_cache(3, 7, jd),
                   f"{arch} cache {pd}")


def test_abstract_params_draw_nothing():
    """``LM.init`` on the meta device reads no key: the largest model's
    abstract tree is made at once."""
    import time

    t0 = time.perf_counter()
    p = plm.LM(get_config("arctic-480b")).abstract_params()
    assert time.perf_counter() - t0 < 5.0
    assert all(t.is_meta for _, t in tree_leaves(p))
