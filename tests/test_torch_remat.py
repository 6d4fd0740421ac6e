"""``RunFlags(remat="dots")`` of the port (``repro_torch.models.lm``)
against the JAX reference's ``jax.checkpoint(policy=
dots_with_no_batch_dims_saveable)``, on the CPU, for every family's
REDUCED config in float32: ssm (mamba2-130m), dense (llama3.2-1b), moe
(olmoe-1b-7b), hybrid (jamba-v0.1-52b), vlm (llama-3.2-vision-11b, gate
0.5) and audio (seamless-m4t-large-v2), the vlm and audio weights
``tame``'d as in their LM tests (ROADMAP R19).

* Under "dots" the port's loss and every gradient are bit-equal to its own
  ``remat="none"`` (the bar ``test_block_remat_and_chunked_loss_grads``
  holds "block" to).
* They match the reference's ``jax.value_and_grad`` under
  ``RunFlags(remat="dots")``: the loss at rtol 1e-5, every leaf at 1e-4
  of its scale (the grad tests' float32 bars).
* The products the port saves — the ``aten.mm`` / marked ``aten.bmm``
  calls its policy keeps, each as (rows, contraction, columns) — are
  exactly the ``dot_general``s with no batch dimension in the jaxpr of the
  reference's block, in order, block for block.  The audio encoder saves
  none: it is recomputed whole, as the reference's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import lm as plm
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy

from test_torch_vlm_lm import tame, with_gate

torch.set_num_threads(1)

ARCHS = {"ssm": "mamba2-130m", "dense": "llama3.2-1b", "moe": "olmoe-1b-7b",
         "hybrid": "jamba-v0.1-52b", "vlm": "llama-3.2-vision-11b",
         "audio": "seamless-m4t-large-v2"}
B, S = 2, 32
JFLAGS = {r: jlm.RunFlags(remat=r, q_chunk=16) for r in ("none", "dots")}


def _ref_params(family):
    jcfg = jax_get_config(ARCHS[family], reduced=True)
    jp = jlm.LM(jcfg).init(jax.random.PRNGKey(0), jnp.float32)
    if family == "vlm":
        jp = tame(with_gate(jp, 0.5))
    elif family == "audio":
        jp = tame(jp)
    return jcfg, jp


def _batch(cfg):
    """(reference batch, port batch): tokens, labels and the family's stub
    frontend embeddings, made with numpy."""
    rng = np.random.default_rng(3)
    data = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family in ("audio", "vlm"):
        key, n = (("audio_embeds", cfg.audio_frames) if cfg.family == "audio"
                  else ("image_embeds", cfg.vision_tokens))
        data[key] = np.random.default_rng(7).standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v) for k, v in data.items()})


def _port_grads(cfg, jp, batch, remat):
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for _, t in tree_leaves(pp):
        t.requires_grad_()
    loss, _ = plm.LM(cfg).loss_fn(pp, batch, plm.RunFlags(remat=remat))
    loss.backward()
    return loss.detach(), {k: t.grad for k, t in tree_leaves(pp)}


@pytest.fixture(scope="module", params=list(ARCHS))
def family(request):
    fam = request.param
    cfg = get_config(ARCHS[fam], reduced=True)
    jcfg, jp = _ref_params(fam)
    jb, pb = _batch(cfg)
    return fam, cfg, jcfg, jp, jb, pb


def test_dots_bit_equal_none(family):
    _, cfg, _, jp, _, pb = family
    base_loss, base = _port_grads(cfg, jp, pb, "none")
    loss, grads = _port_grads(cfg, jp, pb, "dots")
    assert torch.equal(loss, base_loss)
    assert set(grads) == set(base)
    for k, g in grads.items():
        assert g is not None and torch.equal(g, base[k]), k


def test_dots_grads_match_reference(family):
    _, cfg, jcfg, jp, jb, pb = family
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.LM(jcfg).loss_fn(p, jb, JFLAGS["dots"])[0]))(jp)
    loss, grads = _port_grads(cfg, jp, pb, "dots")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    keys = [k for k, _ in tree_leaves(grads)]
    ref = dict(zip(keys, jax.tree.leaves(jgrads)))
    for k in keys:
        want = np.asarray(ref[k])
        scale = max(1e-30, float(np.abs(want).max()))
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=k)


def _ref_block_products(jcfg, jp, jb):
    """(rows, contraction, columns) of every ``dot_general`` with no batch
    dimension in the jaxpr of one reference block, sub-jaxprs included."""
    lm = jlm.LM(jcfg)
    x = jnp.zeros((B, S, jcfg.d_model), jnp.float32)
    bp = jax.tree.map(lambda a: a[0], jp["blocks"])
    cross = lm._cross_source(jp, jb, JFLAGS["none"])
    jaxpr = jax.make_jaxpr(lambda x, bp: lm._apply_block(
        x, bp, mask_kind="causal", cross_src=cross, flags=JFLAGS["dots"],
        collect_kv=False))(x, bp)
    out = []

    def walk(jx):
        for e in jx.eqns:
            if e.primitive.name == "dot_general":
                (lc, _), (lb, rb) = e.params["dimension_numbers"]
                if not lb and not rb:
                    ls, rs = e.invars[0].aval.shape, e.invars[1].aval.shape
                    k = math.prod(ls[i] for i in lc)
                    out.append((math.prod(ls) // k, k, math.prod(rs) // k))
            for p in e.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(jaxpr.jaxpr)
    return out


def test_saved_products_match_reference_jaxpr(family, monkeypatch):
    fam, cfg, jcfg, jp, jb, pb = family
    saved = []
    policy = plm._dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == plm.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[0].shape, args[1].shape
            if op is torch.ops.aten.bmm.default:
                assert a[0] == b[0] == 1, (a, b)  # marked: no batch dimension
                a, b = a[1:], b[1:]
            saved.append((a[0], a[1], b[1]))
        return decision

    monkeypatch.setattr(plm, "_dots_policy", spy)
    _port_grads(cfg, jp, pb, "dots")
    ref = _ref_block_products(jcfg, jp, jb)
    n_blocks = plm.LM(cfg).n_blocks
    assert ref and len(saved) == n_blocks * len(ref), (len(saved), n_blocks, len(ref))
    for i in range(n_blocks):
        assert saved[i * len(ref):(i + 1) * len(ref)] == ref, f"block {i}"


def test_batch_one_product_is_not_saved(monkeypatch):
    """A batched product whose batch is 1 (B = H = 1 attention logits)
    reaches ``aten.bmm`` with batch 1 like a marked projection, and is
    recomputed, not saved: the policy reads the mark, not the shape."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    from repro_torch.models.common import no_batch_einsum

    decisions = []

    def spy(ctx, op, *args, **kwargs):
        d = plm._dots_policy(ctx, op, *args, **kwargs)
        if op is torch.ops.aten.bmm.default and not ctx.is_recompute:
            decisions.append(d)
        return d

    q = torch.randn(1, 8, 1, 4, requires_grad=True)
    w = torch.randn(4, 1, 4, requires_grad=True)

    def f(q, w):
        logits = torch.einsum("bqhk,bthk->bhqt", q, q)  # batch dims b, h = 1
        proj = no_batch_einsum("bsd,dhk->bshk", q[:, :, 0], w)
        return logits.sum() + proj.sum()

    out = checkpoint(f, q, w, use_reentrant=False,
                     context_fn=lambda: create_selective_checkpoint_contexts(spy))
    out.backward()
    assert decisions == [plm.CheckpointPolicy.PREFER_RECOMPUTE, plm.CheckpointPolicy.MUST_SAVE]
