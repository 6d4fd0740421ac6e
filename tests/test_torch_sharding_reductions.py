"""The sharded step's reductions partitioned as GSPMD partitions the
reference's: the vocab-parallel loss, the per-rank MoE dispatch and
combine, and the sequence-parallel decode softmax.

(a) ``models.common.cross_entropy_loss`` on DTensor logits (the batch over
    "data", the vocab over "model", padded past the vocab's size) on 1, 2
    and 4 ``gloo`` ranks, labels with -1 and values >= the vocab among
    them, against
    the reference's ``cross_entropy_loss`` and ``jax.grad`` of it: the
    loss and its logits gradient at 1e-6.  On one rank (every reduction
    the identity) the loss and the gradient are the plain port's, bit for
    bit.
(b) ``models.ffn.moe`` on the reduced olmoe, float32, its capacity factor
    cut so that choices overflow, with the weights placed by the tp rules
    on (1, 2), (2, 2) and (1, 4) (there with 2 experts, so that "model"
    splits the experts' ffn dim instead), against the reference's ``moe``
    and ``jax.grad`` of ``(y * gy).sum() + aux``: the routing ids
    identical, y and the gradients at the sharded serving tests' bars
    (``rtol=1e-4``, ``1e-5`` of the scale), aux at the steps tests'
    ``rtol=1e-5``.
(c) The reduced llama decoding 8 greedy tokens under ``decode_constrain``
    on (1, 2), the cache sequence-sharded, past the ring's wrap, against
    the plain port: the tokens identical, the logits at ``rtol=1e-5``,
    ``1e-5`` of the scale.
(d) The reduced llama and olmoe train steps and llama's constrained
    decode step traced (``launch/hlo.py``'s ``StepTrace``, the dry-run's
    tuned profiles) as rank 0 of a fake (2, 4) mesh and unsharded: no
    all-gather whose bytes on the rank reach the rank's (B, S, V) float32
    logits, the (B, E*C, D) MoE slots or the (B, H, 1, W) float32 decode
    logits; fewer collective bytes than the same traces counted before
    these reductions were partitioned; and 8 x the rank's FLOPs equal the
    unsharded step's plus the replicated kv products' share, within 1 %
    (``tests/test_torch_sharding_products.py``'s identity).

The ranks and the trace run in spawned processes that import torch and
the port only (``_torch_sharding.py``); this process computes the
references meanwhile.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sharding import (
    DECODE_STEPS, LOSS_VOCAB, MOE_B, MOE_S, REDUCTION_CASES, REDUCTION_TRACES, TRACE_MESH,
    gathered_bytes, greedy_decode, join, loss_inputs, moe_setup, reduction_trace_worker,
    reductions_worker, start, weight_matrices, weight_product_flops,
)
from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro_torch.configs import get_config
from repro_torch.models.ffn import expert_capacity

torch.set_num_threads(1)

#: collective bytes a rank of the structural traces before the loss, the
#: MoE dispatch and the constrained decode softmax were partitioned (the
#: logits gathered whole over "model", the MoE slots gathered for the
#: combine, the decode logits gathered for the softmax), counted by
#: ``reduction_trace_worker`` on that code under torch 2.13
BEFORE_BYTES = {"llama_train": 3542824, "olmoe_train": 4305852, "llama_decode": 89600}
#: the weights that the rules leave replicated over the 4-way "model" axis
REPLICATED = {"llama32_1b": ("wk", "wv"), "olmoe_1b_7b": ()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reductions")
    ctxs = [start(reductions_worker, w, tmp, cases) for w, cases in REDUCTION_CASES.items()]
    ctxs.append(start(reduction_trace_worker, 1, tmp, TRACE_MESH))
    try:
        refs = {"loss": _loss_reference(), "decode": greedy_decode(),
                **{f"moe_{n}": _moe_reference(n) for n in (None, 2)}}
    finally:
        for ctx in ctxs:
            join(ctx, 600)
    return tmp, refs


def _load(tmp, name):
    with np.load(os.path.join(tmp, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _loss_reference():
    logits, labels = loss_inputs()
    f = lambda x: jcommon.cross_entropy_loss(x, jnp.asarray(labels), LOSS_VOCAB)  # noqa: E731
    loss, grad = jax.value_and_grad(f)(jnp.asarray(logits))
    return np.asarray(loss), np.asarray(grad)


def _moe_reference(n_experts):
    cfg, params, x, gy = moe_setup(n_experts)
    jcfg = jax_get_config("olmoe-1b-7b", reduced=True)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cfg.capacity_factor,
                               n_experts=cfg.n_experts)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def f(x, p):
        y, aux = jffn.moe(x, p, jcfg)
        return (y * gy).sum() + aux, (y, aux)

    (_, (y, aux)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jp)
    probs = jax.nn.softmax((jnp.asarray(x) @ jp["router"]).astype(jnp.float32), axis=-1)
    ids = jax.lax.top_k(probs, jcfg.experts_per_token)[1]
    out = {"y": y, "aux": aux, "ids": ids, "g_x": gx, **{f"g_{k}": v for k, v in gp.items()}}
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


@pytest.mark.parametrize("name", ["loss_1x2", "loss_2x2", "loss_1x4", "loss_1x1"])
def test_vocab_parallel_loss_matches_reference(runs, name):
    tmp, refs = runs
    got, (loss, grad) = _load(tmp, name), refs["loss"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["grad"], grad, rtol=1e-6, atol=1e-6)
    # the masked labels (-1, the vocab's size) take no gradient
    assert not got["grad"][0, :2].any()


def test_one_rank_loss_is_the_plain_ports_to_the_bit(runs):
    got = _load(runs[0], "loss_1x1")
    assert got["loss"].tobytes() == got["plain_loss"].tobytes()
    assert got["grad"].tobytes() == got["plain_grad"].tobytes()


@pytest.mark.parametrize("name", ["moe_1x2", "moe_2x2", "moe_1x4_ffn"])
def test_per_rank_moe_matches_reference(runs, name):
    tmp, refs = runs
    n_experts = {c[0]: c[3] for cs in REDUCTION_CASES.values() for c in cs}[name]
    got, want = _load(tmp, name), refs[f"moe_{n_experts}"]
    cfg = moe_setup(n_experts)[0]
    # the cut capacity drops choices: a sequence routes more of them to
    # some expert than it holds
    loads = np.stack([np.bincount(r.ravel(), minlength=cfg.n_experts) for r in want["ids"]])
    assert loads.max() > expert_capacity(cfg, MOE_S)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    _close(got["y"], want["y"], f"{name}: y")
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5, err_msg=f"{name}: aux")
    for k in want:
        if k.startswith("g_"):
            _close(got[k], want[k], f"{name}: {k}")
    assert got["y"].shape == (MOE_B, MOE_S, cfg.d_model)


def test_constrained_decode_matches_plain(runs):
    tmp, refs = runs
    got = _load(tmp, "decode_1x2")
    tokens, logits = refs["decode"]
    np.testing.assert_array_equal(got["tokens"], tokens)
    assert tokens.shape[1] == DECODE_STEPS
    for i, want in enumerate(logits):
        _close(got[f"l{i}"], want, f"decode step {i}", rtol=1e-5)


@pytest.fixture(scope="module")
def traces(runs):
    with open(runs[0] / "reduction_traces.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", [c[0] for c in REDUCTION_TRACES])
def test_no_rank_gathers_a_reduced_operand(traces, name):
    rec = traces[name]
    assert "error" not in rec, rec["error"]
    _, arch, fields = next(c for c in REDUCTION_TRACES if c[0] == name)
    gathers = [b for kind, b, _ in rec["collectives"] if kind == "all-gather"]
    for what, nbytes in gathered_bytes(name, arch, fields).items():
        assert max(gathers, default=0) < nbytes, (
            f"{name}: an all-gather of {max(gathers)} B reaches the {what} ({nbytes} B)")
    total = sum(b for _, b, _ in rec["collectives"])
    assert total < BEFORE_BYTES[name], f"{name}: {total} collective bytes a rank"


@pytest.mark.parametrize("name", [c[0] for c in REDUCTION_TRACES])
def test_no_rank_repeats_another_ranks_work(traces, name):
    rec = traces[name]
    assert "error" not in rec, rec["error"]
    arch = next(c[1] for c in REDUCTION_TRACES if c[0] == name)
    ranks, model = math.prod(TRACE_MESH), TRACE_MESH[1]
    rank = sum(n for _, _, n in rec["sharded"])
    whole = sum(n for _, _, n in rec["whole"])
    repl = weight_product_flops(rec["whole"], weight_matrices(get_config(arch, reduced=True),
                                                              REPLICATED[arch]))
    want = whole + (model - 1) * repl
    assert abs(ranks * rank - want) <= 0.01 * want, (
        f"{name}: {ranks} ranks x {rank:.4e} FLOPs against {want:.4e}")
