"""Step functions of the trainer and the server (port of
``repro/launch/steps.py``)."""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.lm import LM, RunFlags
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.sharding.rules import full, like, mesh_context


def make_train_step(lm: LM, opt_cfg: AdamWConfig, flags: RunFlags = RunFlags()):
    """(params, opt_state, batch) -> (params, opt_state, metrics) with
    ``loss``, ``ce``, ``aux`` and ``grad_norm`` (0-dim tensors on the
    device).  The parameters are leaf tensors that require grad (the step
    sets the flag where it is missing); each step clears their grads, runs
    ``loss_fn`` and its backward, and updates them in place under
    ``torch.no_grad()`` (:func:`adamw_update`), as the reference's jitted
    step donates them.

    The parameters may be DTensors (``launch.train`` places them under the
    sharding rules): the loss then runs through DTensor's propagation (the
    flash kernel on each rank's local heads, ``models.attention``), each
    grad is redistributed to its parameter's placements, and the metrics
    come back as plain tensors, alike on every rank."""

    def train_step(params, opt_state, batch):
        leaves = [p for _, p in tree_leaves(params)]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_()
            p.grad = None
        with mesh_context(params):
            loss, metrics = lm.loss_fn(params, batch, flags)
            loss.backward()
            # DTensor grads come back Partial where ranks hold parts of a
            # sum: reduced to the parameter's own placements
            grads = tree_map(lambda p: like(p.grad, p), params)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        for p in leaves:
            p.grad = None
        out = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}
        return params, opt_state, {k: full(v) for k, v in out.items()}

    return train_step


def make_prefill_step(lm: LM, max_seq: int, flags: RunFlags = RunFlags()):
    """(params, batch) -> (last-token logits, cache).  On DTensor
    parameters (placed by ``sharding.param_shardings``) the step runs
    through DTensor's propagation as the train step does, and the logits
    and the cache come back as DTensors (``sharding.place_cache`` lays the
    cache out for the serve step)."""

    def prefill_step(params, batch):
        with torch.no_grad(), mesh_context(params):
            return lm.prefill_fn(params, batch, max_seq=max_seq, flags=flags)

    return prefill_step


def make_serve_step(lm: LM, flags: RunFlags = RunFlags()):
    """(params, cache, token) -> (logits, cache), the cache updated in
    place.  On DTensor parameters the cache is one ``sharding.place_cache``
    placed: each rank writes its shards of it."""

    def serve_step(params, cache, token):
        with torch.no_grad(), mesh_context(params):
            return lm.decode_fn(params, cache, token, flags)

    return serve_step
