"""Sharded training steps of the port (DTensor parameters, moments and
batches on a ``DeviceMesh``) against the JAX reference's jitted
``make_train_step`` on one device, on the CPU, over 2 ``gloo`` ranks.

The reference runs unsharded: GSPMD's partitioning does not change the
function it computes, so one target serves every mesh.  Both sides start
from ``PRNGKey(0)``'s float32 weights of the reduced config; for every
family with attention each wq and wk is scaled by 1/4 and the vlm's cross
gate set to 0.5, on both sides.  At the raw init the chain is chaotic
(ROADMAP R8, R19, R24; ``scripts/sharding_init_chaos.py``): the plain
hybrid already leaves these bars from the reference by step 3, and the
dense model at (1, 4), whose grad norm is within 1.6e-5 of the plain
port's at step 1, is 1.6e-3 from the reference's by step 4 and take four steps on the synthetic batches
of steps 0-3 (batch 2 x 32).  Cases: all six families at mesh (2, 1)
under ``dp`` (the batch split over "data", everything else replicated) and
at (1, 2) under ``tp`` (heads, ffn, experts, ssm channels and vocab split
over "model"); the dense model at (1, 2) again under ``remat="block"``,
``"dots"`` and ``loss_impl="chunked"``, two steps each.

Bars, those of ``tests/test_torch_train.py::TestTrainStep``: loss, ce and
aux at ``rtol=1e-5`` (sums split over ranks reorder float32 round-off);
``grad_norm`` at ``rtol=1e-3``; the parameters after the steps at
``rtol=1e-4, atol=1e-5`` but for at most 0.1 % of a leaf's entries, each
within ``2 * lr`` per step (AdamW's sign steps, ROADMAP R11).  The remat
runs hold their metrics and parameters bit-equal to the sharded
``remat="none"`` run of the same mesh (the recompute repeats the same
operations); the chunked loss holds the sharded dense run's bars.  After
every step the parameters and moments keep the placements the rules give
(``sharding.placements`` of ``param_shardings`` / ``moment_shardings``),
and the flash op runs as often as in a plain port step.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import steps as psteps
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import lm as plm
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.optim import adamw as padamw
from repro_torch.sharding.rules import ShardingStrategy, moment_shardings, param_shardings
from _torch_sharding import B, GATE, S, STEPS, TAME, FlashCount, join, load_case, start, \
    steps_worker, tame_params
from test_torch_train import _assert_params_after_steps

torch.set_num_threads(1)

FAMILIES = {"dense": "llama3.2-1b", "ssm": "mamba2-130m", "moe": "olmoe-1b-7b",
            "hybrid": "jamba-v0.1-52b", "vlm": "llama-3.2-vision-11b",
            "audio": "seamless-m4t-large-v2"}
MESHES = {"dp": (2, 1), "tp": (1, 2)}
#: the dense model's other paths at (1, 2) tp: (remat, loss_impl), two steps
VARIANTS = {"block": ("block", "dense"), "dots": ("dots", "dense"),
            "chunked": ("none", "chunked")}
VARIANT_STEPS = 2

CASES = ([(f"{fam}_{strat}", MESHES[strat], arch, strat, {})
          for strat in MESHES for fam, arch in FAMILIES.items()]
         + [(f"dense_tp_{v}", (1, 2), FAMILIES["dense"], "tp",
             {"remat": remat, "loss_impl": loss, "steps": VARIANT_STEPS})
            for v, (remat, loss) in VARIANTS.items()])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded runs' output directory: the 2 ranks start first and run
    while the test process computes the references."""
    out = tmp_path_factory.mktemp("sharded_steps")
    ctx = start(steps_worker, 2, out, CASES)
    try:
        refs = {fam: _reference(fam) for fam in FAMILIES}
    finally:
        join(ctx)
    return out, refs


def _jtame(jp, family):
    if family == "ssm":
        return jp

    def tame(t):
        if "wq" in t:
            return dict(t, wq=t["wq"] * TAME, wk=t["wk"] * TAME)
        return {k: tame(v) if isinstance(v, dict) else v for k, v in t.items()}

    jp = tame(jp)
    if family == "vlm":
        blocks = jp["blocks"]
        jp = dict(jp, blocks=dict(blocks, cross_gate=jnp.full_like(blocks["cross_gate"], GATE)))
    return jp


@contextlib.contextmanager
def _counting():
    from repro_torch.kernels.flash_attention import ops

    fn = ops.flash_attention
    try:
        yield FlashCount.install()
    finally:
        ops.flash_attention = fn


def _reference(family):
    """The reference's four jitted steps (metrics, parameters) and the
    flash calls of one plain port step."""
    jcfg = jax_get_config(FAMILIES[family], reduced=True)
    jp = _jtame(jlm.LM(jcfg).init(jax.random.PRNGKey(0), jnp.float32), family)
    ocfg = jadamw.AdamWConfig()
    jo = jadamw.adamw_init(jp, ocfg)
    jstep = jax.jit(jsteps.make_train_step(jlm.LM(jcfg), ocfg,
                                           jlm.RunFlags(remat="none", q_chunk=S)))
    metrics = []
    for i in range(STEPS):
        data = JDataset(jcfg, B, S).batch_at(i)
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in data.items()})
        metrics.append({k: float(v) for k, v in m.items()})

    cfg = get_config(FAMILIES[family], reduced=True)
    lm = plm.LM(cfg)
    pp = tame_params(lm.init(prng.PRNGKey(0), torch.float32, "cpu"), cfg.family)
    step = psteps.make_train_step(lm, padamw.AdamWConfig(), plm.RunFlags(remat="none", q_chunk=S))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(cfg, B, S).batch_at(0).items()}
    with _counting() as counter:
        counter.n = 0
        step(pp, padamw.adamw_init(pp, padamw.AdamWConfig()), batch)
        flash = counter.n
    return {"metrics": metrics, "params": jp, "flash": flash}


def _expected_placements(arch, strategy, shape):
    """{leaf: [str(placement), ...]} of the parameters and the moments under
    the rules, on an abstract mesh of ``shape``."""
    lm = plm.LM(get_config(arch, reduced=True))
    meta = _meta(lm)
    mesh = make_abstract_mesh(shape, ("data", "model"))
    st = ShardingStrategy.from_name(strategy)
    p_sh = param_shardings(lm.logical_axes(), meta, mesh, st)
    m_sh = moment_shardings(p_sh, meta, mesh, st)
    strs = lambda tree: {k: [repr(p) for p in sh.placements] for k, sh in tree_leaves(tree)}  # noqa: E731
    return strs(p_sh), strs(m_sh)


def _meta(lm):
    from repro_torch.models.common import tree_map

    return tree_map(lambda s: torch.empty(s.shape, device="meta"), lm.schema())


def _check(meta, ref, steps, family, arch, strategy, shape):
    p_pl, m_pl = _expected_placements(arch, strategy, shape)
    for i in range(steps):
        got, want = meta["metrics"][i], ref["metrics"][i]
        assert set(got) == {"loss", "ce", "aux", "grad_norm"}
        keys = ("loss", "ce", "aux") if family in ("moe", "hybrid") else ("loss", "ce")
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"step {i}: {k}")
        if family not in ("moe", "hybrid"):
            assert got["aux"] == 0.0
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-3,
                                   err_msg=f"step {i}: grad_norm")
        placed = meta["placed"][i]
        assert placed["params"] == p_pl, f"step {i}: parameter placements"
        assert placed["m"] == m_pl and placed["v"] == m_pl, f"step {i}: moment placements"
        assert meta["flash"][i] == ref["flash"], f"step {i}: flash calls"


def _port_tree(full):
    return tree_unflatten({k: torch.from_numpy(v) for k, v in full.items()})


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("strategy", list(MESHES))
def test_four_steps_match_reference(runs, family, strategy):
    out, refs = runs
    meta, full = load_case(out, f"{family}_{strategy}")
    ref = refs[family]
    _check(meta, ref, STEPS, family, FAMILIES[family], strategy, MESHES[strategy])
    _assert_params_after_steps(_port_tree(full), ref["params"], padamw.AdamWConfig().lr, STEPS)


@pytest.mark.parametrize("variant", ["block", "dots"])
def test_remat_bit_equal_to_none(runs, variant):
    out, _ = runs
    meta, _ = load_case(out, f"dense_tp_{variant}")
    base, _ = load_case(out, "dense_tp")
    assert meta["metrics"] == base["metrics"][:VARIANT_STEPS]
    assert meta["placed"] == base["placed"][:VARIANT_STEPS]
    # the checkpoint's recompute runs the kernel's forward again (ROADMAP R22)
    assert meta["flash"] == [2 * n for n in base["flash"][:VARIANT_STEPS]]


def test_chunked_loss(runs):
    out, refs = runs
    meta, _ = load_case(out, "dense_tp_chunked")
    _check(meta, refs["dense"], VARIANT_STEPS, "dense", FAMILIES["dense"], "tp", (1, 2))
