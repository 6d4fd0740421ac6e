"""Feed-forward layers: the gated MLPs (SwiGLU / GeGLU), the plain GELU
MLP and the token-choice top-k Mixture-of-Experts layer with capacity-based
dispatch (port of ``repro/models/ffn.py``).

The MoE dispatch is the reference's: each (token, choice)'s position in
its expert is a per-sequence cumulative sum, tokens are scattered into
(B, E, C, D) slots (a choice past capacity C goes to a drop row that is
cut off, GShard's overflow), the experts run as three batched products,
and the results are gathered back weighted by the renormalised gates.  The
reference computes all of it outside Pallas, so the port does it in plain
PyTorch.  Nothing in it waits for the host (no ``.item()``, no boolean
indexing), so a decode step around it can be captured in a CUDA graph.
Under a mesh the dispatch runs through DTensor (its cumsum and scatter on
whole operands, ROADMAP item 10) and the slots are cut to each rank's
experts before the expert products.  The MLP's, the router's and the
experts' products run on each rank's shard of their weights
(``sharding.rules.sharded_product``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import act_placements, sharded_product


def mlp_schema(cfg: ModelConfig, d_ff: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_down": ParamSpec((d_ff, d), ("ffn", "embed"), scale=0.5),
        }
    return {
        "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
        "w_down": ParamSpec((d_ff, d), ("ffn", "embed"), scale=0.5),
    }


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    """``jax.nn.silu`` (``x * sigmoid(x)``) for swiglu; ``jax.nn.gelu``
    (tanh approximation, its default) otherwise."""
    if kind == "swiglu":
        return h * torch.sigmoid(h)
    return F.gelu(h, approximate="tanh")


def mlp(x: torch.Tensor, params: Dict[str, torch.Tensor], act: str) -> torch.Tensor:
    """The gated (or plain) MLP; under a mesh ``w_gate`` and ``w_up``
    column-parallel over the ffn dim, ``w_down`` row-parallel
    (:func:`repro_torch.sharding.rules.sharded_product`)."""
    def up(name):
        return sharded_product("...d,df->...f", x, params[name], "matmul")

    if "w_gate" in params:
        h = _act(up("w_gate"), act) * up("w_up")
    else:
        h = _act(up("w_up"), act)
    return sharded_product("...f,fd->...d", h, params["w_down"], "matmul")


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def moe_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff_
    schema: Dict[str, ParamSpec] = {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.1),
        "w_down": ParamSpec((e, f, d), ("experts", "ffn", "embed"), scale=0.5),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
    }
    if cfg.act in ("swiglu", "geglu"):
        schema["w_gate"] = ParamSpec((e, d, f), ("experts", "embed", "ffn"))
    return schema


def expert_capacity(cfg: ModelConfig, seq_len: int) -> int:
    c = math.ceil(seq_len * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return max(4, int(math.ceil(c / 4) * 4))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: (values, indices), largest
    first and, among equal values, the lower index first.  ``torch.topk``
    does not promise that order for ties (bf16 router logits tie often), so
    this is a stable descending sort cut to k."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(probs, -1, idx), idx


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """The router: (float32 logits (B,S,E), probabilities, the top-k gates
    renormalised to sum 1 (B,S,K), their expert ids (B,S,K) int64)."""
    logits = sharded_product("...d,de->...e", x, router, "matmul").to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def dispatch_slots(idx: torch.Tensor, n_experts: int, capacity: int):
    """Where each (token, choice) goes, per sequence.  idx: (B,S,K) ->
    (one-hot choices (B,S*K,E) int32, overflow mask (B,S*K), slot (B,S*K)
    int64 in [0, E*C], E*C being the drop row).  A choice's position in its
    expert counts the choices before it in the sequence (token-major, then
    choice order)."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    experts = torch.arange(n_experts, device=idx.device)
    sel = (flat[..., None] == experts).to(torch.int32)
    cum = torch.cumsum(sel, dim=1, dtype=torch.int32) - sel
    pos = (sel * cum).sum(-1)
    overflow = pos >= capacity
    dest = (flat * capacity + pos).masked_fill(overflow, n_experts * capacity)
    return sel, overflow, dest


def moe(x: torch.Tensor, params: Dict[str, torch.Tensor],
        cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE.  x: (B, S, D) -> (y, aux_loss).

    aux_loss = Switch load balance + router z-loss, weighted by the config's
    coefficients (float32, 0-dim); the caller adds it to the model loss."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    c = expert_capacity(cfg, s)

    logits, probs, gates, idx = route(x, params["router"], k)
    sel, overflow, dest = dispatch_slots(idx, e, c)

    # scatter the tokens into (E, C) slots; only the drop row takes several
    # (an accumulating scatter, as the reference's .add), and it is cut off
    x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    slot = dest[..., None].expand(b, s * k, d)
    disp = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=x.device)
    disp = disp.scatter_add(1, slot, x_rep)[:, : e * c].reshape(b, e, c, d)
    if isinstance(disp, DTensor):
        # DTensor gathers the cumsum's and the scatter's operands whole
        # (replicated over "model"); the slots are cut to each rank's
        # experts, a slice, so the expert products run on local experts
        disp = disp.redistribute(disp.device_mesh, act_placements(x, disp.shape, 1))

    def up(name):  # each rank's experts on their own slots
        return sharded_product("becd,edf->becf", disp, params[name])

    if "w_gate" in params:
        h = _act(up("w_gate"), cfg.act) * up("w_up")
    else:
        h = _act(up("w_up"), cfg.act)
    out = sharded_product("becf,efd->becd", h, params["w_down"])

    # gather back, weighted by the gates; dropped choices read the zero row
    out_flat = torch.cat([out.reshape(b, e * c, d),
                          torch.zeros((b, 1, d), dtype=out.dtype, device=out.device)], dim=1)
    y_tok = torch.gather(out_flat, 1, slot)
    w = gates.reshape(b, s * k).masked_fill(overflow, 0.0).to(x.dtype)
    y = (y_tok * w[..., None]).reshape(b, s, k, d).sum(dim=2)

    # load balance, E * sum_e mean_prob_e * frac_routed_e (Switch, eq. 4),
    # and the router z-loss
    frac = sel.to(torch.float32).reshape(b, s, k, e).sum(2).mean((0, 1)) / k
    balance = e * torch.sum(frac * probs.mean((0, 1)))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = cfg.router_aux_weight * balance + cfg.router_z_weight * z
    return y, aux
