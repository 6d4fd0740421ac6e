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
Under a mesh the router's product runs on each rank's shard of its
weight (``sharding.rules.sharded_product``), and the rest on each rank's
own experts and batch rows in a ``local_map`` (:func:`_moe_per_rank`):
the same per-sequence slots, only the choices routed to the rank's
experts scattered into its slots, its experts' products, its choices
gathered back, and one all-reduce of the (B, S, D) result over "model",
as GSPMD partitions the reference's layer.  The MLP's products run on
each rank's shard of their weights (``sharded_product``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import all_reduce_shards, sharded_product


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


def choices(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """idx (B,S,K) -> the one-hot choices (B,S*K,E) int32, token-major."""
    flat = idx.reshape(idx.shape[0], -1)
    return (flat[..., None] == torch.arange(n_experts, device=idx.device)).to(torch.int32)


def dispatch_slots(idx: torch.Tensor, n_experts: int, capacity: int):
    """Where each (token, choice) goes, per sequence.  idx: (B,S,K) ->
    (one-hot choices (B,S*K,E) int32, overflow mask (B,S*K), slot (B,S*K)
    int64 in [0, E*C], E*C being the drop row).  A choice's position in its
    expert counts the choices before it in the sequence (token-major, then
    choice order)."""
    flat = idx.reshape(idx.shape[0], -1)
    sel = choices(idx, n_experts)
    cum = torch.cumsum(sel, dim=1, dtype=torch.int32) - sel
    pos = (sel * cum).sum(-1)
    overflow = pos >= capacity
    dest = (flat * capacity + pos).masked_fill(overflow, n_experts * capacity)
    return sel, overflow, dest


def _experts(x, params, gates, overflow, dest, act: str, n_experts: int, capacity: int):
    """The tokens x (B,S,D) scattered into ``n_experts`` x ``capacity``
    slots by ``dest`` (B,S*K) (only the drop row at E*C takes several: an
    accumulating scatter, as the reference's .add, cut off), the experts
    as three batched products, and the results gathered back weighted by
    ``gates`` (B,S,K), an overflowed choice (and any choice sent to the
    drop row) reading zeros: y (B,S,D)."""
    b, s, d = x.shape
    k = gates.shape[-1]
    e, c = n_experts, capacity
    x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    slot = dest[..., None].expand(b, s * k, d)
    disp = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=x.device)
    disp = disp.scatter_add(1, slot, x_rep)[:, : e * c].reshape(b, e, c, d)

    def up(name):
        return torch.einsum("becd,edf->becf", disp, params[name])

    if "w_gate" in params:
        h = _act(up("w_gate"), act) * up("w_up")
    else:
        h = _act(up("w_up"), act)
    out = torch.einsum("becf,efd->becd", h, params["w_down"])

    out_flat = torch.cat([out.reshape(b, e * c, d),
                          torch.zeros((b, 1, d), dtype=out.dtype, device=out.device)], dim=1)
    y_tok = torch.gather(out_flat, 1, slot)
    w = gates.reshape(b, s * k).masked_fill(overflow, 0.0).to(x.dtype)
    return (y_tok * w[..., None]).reshape(b, s, k, d).sum(dim=2)


_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def _moe_per_rank(x, params, gates, idx, cfg: ModelConfig, capacity: int):
    """:func:`_experts` on DTensors, per rank in a ``local_map``, as GSPMD
    partitions the reference's dispatch from the experts' sharding.  Each
    rank takes its batch rows (as ``x`` splits them) with every token of
    them, computes the same per-sequence slots (capacity is per sequence,
    so no rank needs another's rows), and runs its shard of the expert
    weights: where "model" splits the experts, only the choices routed to
    its experts enter its (B, E_loc*C + 1, D) slots, the others going to
    the drop row; where it splits their ffn dim instead, every expert on
    its ffn columns.  Either way its y is a part of the sum, all-reduced
    once over "model" (``sharding.rules.all_reduce_shards``), and the
    grads of ``x`` and ``gates`` are the ranks' parts (``Partial``).
    The slots, their scatter and their gather never become DTensors, so
    no collective moves them, forward or backward."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    e = cfg.n_experts
    names = [n for n in _EXPERT_WEIGHTS if n in params]
    w0 = params[names[0]]
    mesh = w0.device_mesh
    dims = mesh.mesh_dim_names
    pm = w0.placements[dims.index("model")] if "model" in dims else Replicate()
    split = pm.is_shard()
    px, gx = [], []
    for n, p in zip(dims, x.placements):
        if n == "model" and split:  # every rank reads the rows whole
            px.append(Replicate())
            gx.append(Partial())
        else:
            px.append(Shard(0) if p == Shard(0) else Replicate())
            gx.append(px[-1])
    pws = [[p if n == "model" else Replicate() for n, p in zip(dims, params[w].placements)]
           for w in names]
    # a weight's grad from a rank's own batch rows is a part of the sum
    gws = [[Partial() if q == Shard(0) else p for p, q in zip(pw, px)] for pw in pws]
    e_loc = e // mesh.size(dims.index("model")) if split and pm.dim == 0 else e
    e0 = mesh.get_local_rank("model") * e_loc if e_loc != e else 0
    pout = [Shard(0) if p == Shard(0) else Replicate() for p in px]

    def local(x, gates, idx, *ws):
        _, overflow, dest = dispatch_slots(idx, e, capacity)
        if e_loc != e:  # this rank's experts' slots; the others' choices to the drop row
            mine = (dest >= e0 * capacity) & (dest < (e0 + e_loc) * capacity)
            dest = torch.where(mine, dest - e0 * capacity, e_loc * capacity)
        y = _experts(x, dict(zip(names, ws)), gates, overflow, dest, cfg.act, e_loc, capacity)
        return all_reduce_shards(y, "sum", mesh, pws[0])

    return local_map(local, out_placements=pout, in_placements=(px, px, px, *pws),
                     in_grad_placements=(gx, gx, px, *gws), device_mesh=mesh,
                     redistribute_inputs=True)(x, gates, idx, *(params[w] for w in names))


def moe(x: torch.Tensor, params: Dict[str, torch.Tensor],
        cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE.  x: (B, S, D) -> (y, aux_loss).

    aux_loss = Switch load balance + router z-loss, weighted by the config's
    coefficients (float32, 0-dim); the caller adds it to the model loss."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    c = expert_capacity(cfg, s)

    logits, probs, gates, idx = route(x, params["router"], k)
    if isinstance(x, DTensor):
        y = _moe_per_rank(x, params, gates, idx, cfg, c)
        sel = choices(idx, e)
    else:
        sel, overflow, dest = dispatch_slots(idx, e, c)
        y = _experts(x, params, gates, overflow, dest, cfg.act, e, c)

    # load balance, E * sum_e mean_prob_e * frac_routed_e (Switch, eq. 4),
    # and the router z-loss
    frac = sel.to(torch.float32).reshape(b, s, k, e).sum(2).mean((0, 1)) / k
    balance = e * torch.sum(frac * probs.mean((0, 1)))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = cfg.router_aux_weight * balance + cfg.router_z_weight * z
    return y, aux
