"""The port's Mixture-of-Experts layer (``repro_torch.models.ffn``:
``moe_schema``, ``expert_capacity``, ``top_k``, ``route``,
``dispatch_slots``, ``moe``) against the JAX reference
(``repro.models.ffn``) on the CPU, at ``olmoe_1b_7b``'s REDUCED config
(d_model 128, 4 experts top-2, d_ff 64) and variants of it, with the
reference's weights (``LM(cfg).init(PRNGKey(0), dtype)``) carried across.
Activations are made with numpy from a seed.

The routing is held first and exactly: the expert ids (top-k order
included) and the overflow mask.  ``jax.lax.top_k`` puts the lower index
first among equal values; ``torch.topk`` does not promise that, and the
port's stable sort does (:func:`test_forced_ties`).

Bars: float32 y and aux to round-off (``rtol=atol=2e-5``,
``tests/test_kernels.py::tol_for``), grads wrt x and the router to 1e-4 of
each tensor's scale; bfloat16 y at ``tol_for`` (3e-2 of y's scale) and
aux to 1e-3.  In bfloat16 the router product (x @ router) may round
differently by one ulp in the two frameworks and flip a choice; where the
routing differs the test says how many choices differ and holds y with the
reference's routing forced into the port (:func:`port_routing`), at the
same bar.

Helpers shared with the LM tests: :func:`record_ref_routing` (the
reference's expert ids per MoE call, from a ``jax.debug.callback`` in a
wrapper of ``repro.models.ffn.moe``, jitted or not) and
:func:`port_routing` (the port's ids per call, optionally forced to given
ids).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import common as pcommon
from repro_torch.models import ffn as pffn
from repro_torch.models import lm as plm
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

CFG = get_config("olmoe-1b-7b", reduced=True)
JCFG = jax_get_config("olmoe-1b-7b", reduced=True)
B, S = 2, 32
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py::tol_for


# ---------------------------------------------------------------------------
# Routing recorders (also used by test_torch_moe_lm.py, test_torch_hybrid_lm.py)
# ---------------------------------------------------------------------------


def ref_routing(x, router, cfg):
    """The reference's routing of ``repro.models.ffn.moe``, its first lines:
    (expert ids (B,S,K), overflow mask (B,S*K)) as numpy."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    c = jffn.expert_capacity(cfg, s)
    probs = jax.nn.softmax((x @ router).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(idx.reshape(b, s * k), e, dtype=jnp.int32)
    pos = jnp.sum(sel * (jnp.cumsum(sel, axis=1) - sel), axis=-1)
    return np.asarray(idx), np.asarray(pos >= c)


@contextlib.contextmanager
def record_ref_routing():
    """Within the block, every call of the reference's ``ffn.moe`` (through
    ``repro.models.lm`` too, jitted or not) appends its expert ids to the
    yielded list, in call order; read it after ``jax.effects_barrier()``."""
    ids = []
    orig = jffn.moe

    def wrapped(x, params, cfg):
        probs = jax.nn.softmax((x @ params["router"]).astype(jnp.float32), axis=-1)
        _, idx = jax.lax.top_k(probs, cfg.experts_per_token)
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), idx, ordered=True)
        return orig(x, params, cfg)

    jffn.moe = wrapped
    try:
        yield ids
    finally:
        jffn.moe = orig


@contextlib.contextmanager
def port_routing(forced=None):
    """Within the block, every call of the port's ``ffn.route`` appends its
    own expert ids to the yielded list; with ``forced`` (a list of id
    arrays, one per call in order) the call's ids are replaced by the given
    ones and its gates taken from its own probabilities at those ids."""
    ids = []
    orig = pffn.route

    def wrapped(x, router, k):
        logits, probs, gates, idx = orig(x, router, k)
        ids.append(idx.numpy().copy())
        if forced is not None:
            idx = torch.from_numpy(np.array(forced[len(ids) - 1])).to(torch.int64)
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, gates, idx

    pffn.route = wrapped
    try:
        yield ids
    finally:
        pffn.route = orig


def routing_diff(port_ids, ref_ids) -> int:
    """Number of (call, token) rows whose expert ids differ."""
    assert len(port_ids) == len(ref_ids)
    n = 0
    for p, r in zip(port_ids, ref_ids):
        assert p.shape == r.shape
        n += int((p != r).any(-1).sum())
    return n


# ---------------------------------------------------------------------------


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=what)


def _moe_params(name, cfg=JCFG, seed=0):
    """Layer 0's MoE weights of the reference's init, both sides."""
    jdt = DTYPES[name][0]
    jp = jax.tree.map(lambda a: a[0], jlm.LM(cfg).init(jax.random.PRNGKey(seed), jdt)["blocks"]["moe"])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _acts(name, shape, seed=0, scale=1.0):
    jdt, tdt = DTYPES[name]
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


#: (what, config overrides, sequence length): olmoe's reduced MoE; capacity
#: factor 0.25 (capacity 4 of 64 choices per expert: most choices
#: overflow); 8 experts top-3 at capacity factor 1.0 (some overflow)
CASES = {
    "reduced": ({}, S),
    "overflow": ({"capacity_factor": 0.25}, 32),
    "e8k3": ({"n_experts": 8, "experts_per_token": 3, "capacity_factor": 1.0}, 48),
}


def _case(case):
    over, s = CASES[case]
    return dataclasses.replace(CFG, **over), dataclasses.replace(JCFG, **over), s


@pytest.mark.parametrize("e,k,cf", [(4, 2, 1.25), (64, 8, 1.25), (16, 2, 1.25), (8, 3, 1.0),
                                    (8, 1, 0.5), (128, 8, 2.0), (5, 2, 1.1)])
@pytest.mark.parametrize("s", [1, 2, 7, 32, 100, 512, 4096])
def test_expert_capacity(e, k, cf, s):
    got = dataclasses.replace(CFG, n_experts=e, experts_per_token=k, capacity_factor=cf)
    ref = dataclasses.replace(JCFG, n_experts=e, experts_per_token=k, capacity_factor=cf)
    assert pffn.expert_capacity(got, s) == jffn.expert_capacity(ref, s)


@pytest.mark.parametrize("case", list(CASES))
def test_schema(case):
    cfg, jcfg, _ = _case(case)
    got, ref = pffn.moe_schema(cfg), jffn.moe_schema(jcfg)
    assert got.keys() == ref.keys()
    for k, s in ref.items():
        assert (got[k].shape, got[k].axes, got[k].init, got[k].scale) == (
            s.shape, s.axes, s.init, s.scale), k


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(DTYPES))
def test_moe(case, name):
    cfg, jcfg, s = _case(case)
    jp, pp = _moe_params(name, jcfg)
    jx, tx = _acts(name, (B, s, cfg.d_model), seed=len(case))
    ref_idx, ref_over = ref_routing(jx, jp["router"], jcfg)
    _, _, _, idx = pffn.route(tx, pp["router"], cfg.experts_per_token)
    _, over, dest = pffn.dispatch_slots(idx, cfg.n_experts, pffn.expert_capacity(cfg, s))
    y_ref, aux_ref = jffn.moe(jx, jp, jcfg)
    y, aux = pffn.moe(tx, pp, cfg)
    assert y.dtype == DTYPES[name][1] and aux.dtype == torch.float32 and aux.dim() == 0
    if case != "reduced":
        assert ref_over.any() and not ref_over.all(), "the case has overflow"
    if name == "float32":
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_array_equal(over.numpy(), ref_over)
        assert int(dest.max()) <= cfg.n_experts * pffn.expert_capacity(cfg, s)
        _close(y, y_ref, TOL[name])
        np.testing.assert_allclose(float(aux), float(aux_ref), rtol=TOL[name])
        return
    # bf16: the routing first; where it differs, y with the reference's routing
    flips = int((idx.numpy() != ref_idx).any(-1).sum())
    if flips:
        print(f"{case} bf16: {flips} of {B * s} tokens routed differently; y held with "
              "the reference's routing forced")
        with port_routing([ref_idx]):
            y, _ = pffn.moe(tx, pp, cfg)
    else:
        np.testing.assert_array_equal(over.numpy(), ref_over)
    _close(y, y_ref, TOL[name])
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-3)


def _tied_router(jp, pp, pairs):
    """The router with column b a copy of column a for each (a, b): those
    experts' probabilities are equal for every token."""
    r = np.asarray(jp["router"], np.float32).copy()
    for a, b in pairs:
        r[:, b] = r[:, a]
    jdt = jp["router"].dtype
    return ({**jp, "router": jnp.asarray(r, jdt)},
            {**pp, "router": torch.from_numpy(r).to(pp["router"].dtype)})


@pytest.mark.parametrize("name", list(DTYPES))
def test_forced_ties(name):
    """8 experts top-3 with columns (0, 5), (2, 3), (4, 7), (1, 6) equal:
    every token's probabilities come in tied pairs.  The port's ids equal
    the reference's (lower index first among ties), where ``torch.topk``'s
    differ on a good share of the tokens; y and aux as in ``test_moe``."""
    cfg, jcfg, s = _case("e8k3")
    jp, pp = _moe_params(name, jcfg)
    jp, pp = _tied_router(jp, pp, ((0, 5), (2, 3), (4, 7), (1, 6)))
    jx, tx = _acts(name, (4, s, cfg.d_model), seed=11)
    ref_idx, ref_over = ref_routing(jx, jp["router"], jcfg)
    _, probs, _, idx = pffn.route(tx, pp["router"], cfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    plain = torch.topk(probs, cfg.experts_per_token).indices.numpy()
    n_plain = int((plain != ref_idx).any(-1).sum())
    print(f"forced ties {name}: torch.topk's ids differ from jax.lax.top_k's on {n_plain} of "
          f"{plain.shape[0] * plain.shape[1]} tokens")
    assert n_plain >= 10, "torch.topk breaks these ties otherwise"
    _, over, _ = pffn.dispatch_slots(idx, cfg.n_experts, pffn.expert_capacity(cfg, s))
    np.testing.assert_array_equal(over.numpy(), ref_over)
    y_ref, aux_ref = jffn.moe(jx, jp, jcfg)
    y, aux = pffn.moe(tx, pp, cfg)
    _close(y, y_ref, TOL[name])
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=TOL[name] if name == "float32"
                               else 1e-3)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_top_k_matches_lax(k):
    """``top_k`` against ``jax.lax.top_k`` on rows full of ties (values
    drawn from 3 levels): values and indices equal."""
    v = np.random.default_rng(k).integers(0, 3, (64, 8)).astype(np.float32)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(v), k)
    got_v, got_i = pffn.top_k(torch.from_numpy(v), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


@pytest.mark.parametrize("case", ["reduced", "overflow"])
def test_grads(case):
    """d(sum(y * g) + aux) wrt x and the router against ``jax.grad``, in
    float32, at 1e-4 of each gradient's scale."""
    cfg, jcfg, s = _case(case)
    jp, pp = _moe_params("float32", jcfg)
    jx, tx = _acts("float32", (B, s, cfg.d_model), seed=5)
    g = np.random.default_rng(6).standard_normal((B, s, cfg.d_model)).astype(np.float32)

    def jloss(x, router):
        y, aux = jffn.moe(x, {**jp, "router": router}, jcfg)
        return jnp.sum(y * g) + aux

    gx_ref, gr_ref = jax.grad(jloss, argnums=(0, 1))(jx, jp["router"])
    tx.requires_grad_()
    router = pp["router"].clone().requires_grad_()
    y, aux = pffn.moe(tx, {**pp, "router": router}, cfg)
    (torch.sum(y * torch.from_numpy(g)) + aux).backward()
    for got, ref, what in ((tx.grad, gx_ref, "x"), (router.grad, gr_ref, "router")):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max())
        assert scale > 0, what
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


class TestMoE:
    """Ports of ``tests/test_models.py::TestMoE``."""

    def test_aux_loss_nonzero_and_finite(self):
        from repro_torch import prng

        lm = plm.LM(CFG)
        params = lm.init(prng.PRNGKey(0), torch.bfloat16, "cpu")
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, CFG.vocab_size, (B, S)))
        _, metrics = lm.loss_fn(params, {"tokens": toks, "labels": toks},
                                plm.RunFlags(remat="none"))
        assert float(metrics["aux"]) > 0.0
        assert bool(torch.isfinite(metrics["aux"]))

    def test_moe_capacity(self):
        cfg = get_config("olmoe-1b-7b")
        c = pffn.expert_capacity(cfg, 4096)
        assert c >= 4096 * cfg.experts_per_token / cfg.n_experts
        assert c % 4 == 0
        assert c == jffn.expert_capacity(jax_get_config("olmoe-1b-7b"), 4096)


def test_schema_param_count():
    """The layer's schema counts what the config's analytic count charges
    a MoE layer beside its attention."""
    cfg = get_config("olmoe-1b-7b")
    n = pcommon.param_count(pffn.moe_schema(cfg))
    assert n == cfg._layer_params(0, False) - cfg._attn_params(False)
    assert n == jcommon.param_count(jffn.moe_schema(jax_get_config("olmoe-1b-7b")))
