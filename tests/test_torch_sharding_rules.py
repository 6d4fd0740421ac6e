"""The port's sharding rules (``repro_torch.sharding``), mesh builders
(``repro_torch.launch.mesh``) and ``logical_axes`` against the JAX
reference's, with no process group: specs are tuples whose entries are the
reference's ``PartitionSpec`` entries, so both sides compare with ``==``
(and entry for entry).  The reference's specs come from its
``make_abstract_mesh``, the port's from its ``AbstractMesh``.

* every parameter leaf of all 10 architectures at full config, under
  ``tp``, ``fsdp``, ``zero1`` and ``dp``, on meshes (16, 16), (2, 16, 16),
  (2, 4), (2, 1), (1, 2) and (1, 1): ``param_shardings`` and
  ``moment_shardings``;
* ``batch_spec_axes``, ``token_sharding`` and ``embeds_sharding`` for
  batches 1, 4, 16 and 256, with and without ``include_model``;
* ``cache_shardings`` in modes ``auto``, ``seq`` and ``batch`` of each
  architecture's decode cache (the reference's shapes from
  ``jax.eval_shape`` of its ``init_cache``, the port's from
  ``init_cache(..., device="meta")``);
* the seven cases of ``tests/test_sharding.py::TestSpecForParam`` on both
  sides; ``placements`` of specs on mesh axes (a tuple entry out of the
  mesh's order raises).
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.models.config import VOCAB_PAD_MULTIPLE, pad_to
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as pmesh
from repro_torch.models import lm as plm
from repro_torch.models.common import logical_axes, tree_leaves, tree_map
from repro_torch.sharding import rules as prules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
STRATEGIES = ("tp", "fsdp", "zero1", "dp")


def _meshes(name):
    shape, axes = MESHES[name]
    return jmesh.make_abstract_mesh(shape, axes), pmesh.make_abstract_mesh(shape, axes)


def _jflat(tree, is_leaf=None):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _same(port_spec, ref_spec, what):
    """Equal as specs, and entry for entry as the reference holds them."""
    assert isinstance(port_spec, tuple), what
    assert ref_spec == port_spec, (what, ref_spec, port_spec)
    assert tuple(ref_spec) == port_spec, (what, ref_spec, port_spec)


def _meta(schema):
    return tree_map(lambda s: torch.empty(s.shape, device="meta"), schema)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_moment_shardings(arch, strategy):
    jlm_, plm_ = jlm.LM(jax_get_config(arch)), plm.LM(get_config(arch))
    axes = plm_.logical_axes()
    assert axes == logical_axes(plm_.schema())
    # the axes tree is the reference's leaf for leaf
    jaxes = _jflat(jlm_.logical_axes(), is_leaf=lambda x: isinstance(x, tuple))
    assert dict(tree_leaves(axes)) == jaxes
    meta = _meta(plm_.schema())
    st_j, st_p = jrules.ShardingStrategy.from_name(strategy), \
        prules.ShardingStrategy.from_name(strategy)
    assert (st_p.name, st_p.zero1, st_p.fsdp_axis) == (st_j.name, st_j.zero1, st_j.fsdp_axis)
    for mname in MESHES:
        jm, pm = _meshes(mname)
        jp = jrules.param_shardings(jlm_.logical_axes(), jlm_.abstract_params(), jm, st_j)
        pp = prules.param_shardings(axes, meta, pm, st_p)
        jmom = _jflat(jrules.moment_shardings(jp, jlm_.abstract_params(), jm, st_j))
        pmom = dict(tree_leaves(prules.moment_shardings(pp, meta, pm, st_p)))
        jp = _jflat(jp)
        pp = dict(tree_leaves(pp))
        assert set(jp) == set(pp) == set(jmom) == set(pmom)
        for k in pp:
            _same(pp[k].spec, jp[k].spec, f"{mname} {k}")
            _same(pmom[k].spec, jmom[k].spec, f"{mname} moment {k}")


@pytest.mark.parametrize("include_model", [False, True])
@pytest.mark.parametrize("batch", [1, 4, 16, 256])
def test_batch_token_embeds(batch, include_model):
    for mname in MESHES:
        jm, pm = _meshes(mname)
        assert prules.batch_spec_axes(pm, batch, include_model) == \
            jrules.batch_spec_axes(jm, batch, include_model), mname
        _same(prules.token_sharding(pm, batch, include_model).spec,
              jrules.token_sharding(jm, batch, include_model).spec, mname)
        _same(prules.embeds_sharding(pm, batch, include_model).spec,
              jrules.embeds_sharding(jm, batch, include_model).spec, mname)
    _same(prules.replicated(pm).spec, jrules.replicated(jm).spec, "replicated")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    batch, max_seq = 16, 4096
    jcache = jax.eval_shape(lambda: jlm.LM(jcfg).init_cache(batch, max_seq))
    pcache = plm.LM(cfg).init_cache(batch, max_seq, device="meta")
    jshapes = {k: tuple(v.shape) for k, v in _jflat(jcache).items()}
    assert jshapes == {k: tuple(t.shape) for k, t in tree_leaves(pcache)}
    for mname in MESHES:
        jm, pm = _meshes(mname)
        for mode in ("auto", "seq", "batch"):
            js = _jflat(jrules.cache_shardings(jcache, jm, batch, jcfg, mode=mode))
            ps = dict(tree_leaves(prules.cache_shardings(pcache, pm, batch, cfg, mode=mode)))
            assert set(js) == set(ps)
            for k in ps:
                _same(ps[k].spec, js[k].spec, f"{mname} {mode} {k}")


def _both(logical, shape, mesh_name, strategy):
    (jm, pm) = _meshes(mesh_name)
    ref = jrules.spec_for_param(logical, shape, jm, jrules.ShardingStrategy(strategy))
    got = prules.spec_for_param(logical, shape, pm, prules.ShardingStrategy(strategy))
    _same(got, ref, (logical, shape, mesh_name, strategy))
    return got


class TestSpecForParam:
    """``tests/test_sharding.py::TestSpecForParam``, on both sides."""

    def test_tp_shards_heads(self):
        spec = _both(("embed", "q_heads", "head_dim"), (4096, 32, 128), "16x16", "tp")
        assert spec == P(None, "model", None)

    def test_divisibility_guard_drops_axis(self):
        """yi-9b: 4 kv heads on a 16-way model axis stay replicated."""
        spec = _both(("embed", "kv_heads", "head_dim"), (4096, 4, 128), "16x16", "tp")
        assert spec == P(None, None, None)

    def test_mesh_axis_used_at_most_once(self):
        """MoE weights (experts, embed, ffn): experts win, ffn dropped."""
        spec = _both(("experts", "embed", "ffn"), (128, 7168, 4864), "16x16", "tp")
        assert spec == P("model", None, None)

    def test_fsdp_adds_data_axis(self):
        assert _both(("embed", "ffn"), (7168, 4864), "16x16", "fsdp") == P("data", "model")

    def test_fsdp_multipod_uses_both_axes(self):
        spec = _both(("embed", "ffn"), (7168, 4864), "2x16x16", "fsdp")
        assert spec == P(("pod", "data"), "model")

    def test_dp_replicates_everything(self):
        assert _both(("vocab", "embed"), (50280, 768), "16x16", "dp") == P(None, None)

    def test_vocab_padded_shards(self):
        v = pad_to(256206, VOCAB_PAD_MULTIPLE)
        assert _both(("vocab", "embed"), (v, 1024), "16x16", "tp") == P("model", None)


class TestPlacements:
    def test_specs_to_placements(self):
        from torch.distributed.tensor import Replicate, Shard

        _, m2 = _meshes("2x4")
        _, m3 = _meshes("2x16x16")
        assert prules.placements((None, "model"), m2) == (Replicate(), Shard(1))
        assert prules.placements(("data", "model"), m2) == (Shard(0), Shard(1))
        assert prules.placements((), m2) == (Replicate(), Replicate())
        assert prules.placements((("pod", "data"), "model"), m3) == (Shard(0), Shard(0),
                                                                      Shard(1))
        assert prules.placements((None, ("pod", "data")), m3) == (Shard(1), Shard(1),
                                                                   Replicate())
        with pytest.raises(ValueError, match="order"):
            prules.placements((("data", "pod"), None), m3)
        with pytest.raises(ValueError, match="twice"):
            prules.placements(("model", "model"), m2)

    def test_meshes(self):
        jm, pm = _meshes("2x16x16")
        assert dict(pm.shape) == dict(jm.shape) and pm.axis_names == tuple(jm.axis_names)
        assert pmesh.n_chips(pm) == 512
        with pytest.raises(ValueError, match="no process group"):
            pmesh.make_host_mesh(2, 1, device="cpu")
