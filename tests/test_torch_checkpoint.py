"""The port's checkpoint store (``repro_torch.checkpoint``) and weight
conversion (``repro_torch.models.convert``) against the JAX reference's
store (``repro.checkpoint``) on the CPU.

* JAX ``save`` -> port ``restore`` -> port ``save`` -> JAX ``restore``
  gives the original arrays byte for byte, bfloat16 sidecar included, and
  the two npz files hold byte-identical members (``.npy`` payloads and the
  ``__meta__`` JSON; the zip's own timestamps differ).
* ``params_from_numpy`` from the npz and from the live JAX tree give equal
  tensors.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch import prng
from repro_torch.checkpoint import store as pstore
from repro_torch.configs import get_config
from repro_torch.models import lm as plm
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy

CFG = get_config("mamba2-130m", reduced=True)
JCFG = jax_get_config("mamba2-130m", reduced=True)


def _bytes(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.fixture(scope="module")
def jtree():
    """Reference weights in bf16 plus a float32 cache and its int32 pos."""
    lm = jlm.LM(JCFG)
    params = lm.init(jax.random.PRNGKey(0), jnp.bfloat16)
    toks = jnp.asarray(np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, 16)), jnp.int32)
    _, cache = lm.prefill_fn(params, {"tokens": toks}, max_seq=24,
                             flags=jlm.RunFlags(remat="none", q_chunk=16))
    cache = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                         cache)
    return {"params": params, "cache": cache}


def _port_target():
    lm = plm.LM(CFG)
    return {"params": lm.init(prng.PRNGKey(0), torch.bfloat16, "cpu"),
            "cache": {"pos": torch.zeros((), dtype=torch.int32),
                      "layers": {k: v.float() for k, v in
                                 lm.init_cache(2, 24, device="cpu")["layers"].items()}}}


def jtree_to_port(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


class TestStoreRoundTrip:
    def test_jax_port_jax_byte_identical(self, jtree, tmp_path):
        jdir, pdir = tmp_path / "jax", tmp_path / "port"
        extra = {"arch": "mamba2-130m", "note": [1, 2]}
        jpath = jstore.save(str(jdir), 7, jtree, extra=extra)
        tree, step, got_extra = pstore.restore(str(jdir), _port_target())
        assert step == 7 and got_extra == extra
        assert tree["params"]["embed"].dtype == torch.bfloat16
        assert tree["cache"]["layers"]["state"].dtype == torch.float32
        assert tree["cache"]["pos"].dtype == torch.int32
        ppath = pstore.save(str(pdir), 7, tree, extra=extra)
        assert _members(ppath) == _members(jpath)
        back, step, back_extra = jstore.restore(str(pdir), jtree)
        assert step == 7 and back_extra == extra
        for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                                     jax.tree.leaves(back)):
            assert _bytes(got) == _bytes(want), jax.tree_util.keystr(path)

    def test_sidecar_and_steps(self, jtree, tmp_path):
        d = tmp_path / "ck"
        assert pstore.latest_step(str(d)) is None
        with pytest.raises(FileNotFoundError):
            pstore.restore(str(d), _port_target())
        pstore.save(str(d), 3, jtree_to_port(jtree))
        pstore.save(str(d), 12, jtree_to_port(jtree))
        assert pstore.latest_step(str(d)) == 12 == jstore.latest_step(str(d))
        assert not [f for f in d.iterdir() if f.suffix == ".tmp"]
        with np.load(d / "step_00000012.npz") as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            assert meta["dtypes"]["params/embed"] == "bfloat16"
            assert z["params/embed"].dtype == np.uint16
            assert "cache/layers/state" not in meta["dtypes"]
        bad = _port_target()
        bad["params"]["embed"] = torch.zeros((3, 3), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="shape mismatch"):
            pstore.restore(str(d), bad)


class TestParamsFromNumpy:
    def test_npz_and_live_tree_agree(self, jtree, tmp_path):
        path = jstore.save(str(tmp_path), 0, jtree["params"])
        with np.load(path) as z:
            from_npz = params_from_numpy(z, device="cpu")
        from_tree = params_from_numpy(jax.tree.map(np.asarray, jtree["params"]), device="cpu")
        a, b = dict(tree_leaves(from_npz)), dict(tree_leaves(from_tree))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == torch.bfloat16, k
            assert torch.equal(a[k].view(torch.int16), b[k].view(torch.int16)), k
        want = np.asarray(jtree["params"]["blocks"]["ssm"]["w_x"]).view(np.uint16)
        got = a["blocks/ssm/w_x"].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, want)

    def test_dtype_cast(self, jtree):
        p = params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu", dtype=torch.float32)
        assert p["params"]["embed"].dtype == torch.float32
        assert p["cache"]["pos"].dtype == torch.int32  # only floating leaves are cast
        np.testing.assert_array_equal(
            p["params"]["embed"].numpy(),
            np.asarray(jtree["params"]["embed"], np.float32))
