"""Step functions of the trainer and the server (port of
``repro/launch/steps.py``)."""

from __future__ import annotations

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.lm import LM, RunFlags
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def make_train_step(lm: LM, opt_cfg: AdamWConfig, flags: RunFlags = RunFlags()):
    """(params, opt_state, batch) -> (params, opt_state, metrics) with
    ``loss``, ``ce``, ``aux`` and ``grad_norm`` (0-dim tensors on the
    device).  The parameters are leaf tensors that require grad (the step
    sets the flag where it is missing); each step clears their grads, runs
    ``loss_fn`` and its backward, and updates them in place under
    ``torch.no_grad()`` (:func:`adamw_update`), as the reference's jitted
    step donates them."""

    def train_step(params, opt_state, batch):
        leaves = [p for _, p in tree_leaves(params)]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_()
            p.grad = None
        loss, metrics = lm.loss_fn(params, batch, flags)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        for p in leaves:
            p.grad = None
        out = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}
        return params, opt_state, out

    return train_step


def make_prefill_step(lm: LM, max_seq: int, flags: RunFlags = RunFlags()):
    """(params, batch) -> (last-token logits, cache)."""

    def prefill_step(params, batch):
        return lm.prefill_fn(params, batch, max_seq=max_seq, flags=flags)

    return prefill_step


def make_serve_step(lm: LM, flags: RunFlags = RunFlags()):
    """(params, cache, token) -> (logits, cache)."""

    def serve_step(params, cache, token):
        return lm.decode_fn(params, cache, token, flags)

    return serve_step
