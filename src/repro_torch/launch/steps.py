"""Step functions of the server (port of ``repro/launch/steps.py``).

``make_train_step`` waits for the training slice (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

from repro_torch.models.lm import LM, RunFlags


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
