"""Shared model building blocks: parameter schema, init, norm, rotary
embedding (port of ``repro/models/common.py``).

Parameters are plain nested dicts of tensors.  Every leaf is declared once
via :class:`ParamSpec`, with the reference's shapes and keys, so weights
carry across between the two packages leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch import prng
from repro_torch.device import resolve_device

Params = Any  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0    # stddev multiplier for "normal"

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


Schema = Dict[str, Any]  # nested dict of ParamSpec


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (and over the matching
    leaves of ``rest``, which have the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(flat key, leaf)`` pairs in sorted-key order, keys ``/``-joined as
    the reference's checkpoint store joins them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def logical_axes(schema: Schema):
    """The tree of logical-axis tuples matching the parameter tree (what
    the sharding rules read)."""
    return tree_map(lambda s: s.axes, schema)


def init_params(schema: Schema, key, dtype: torch.dtype = torch.bfloat16,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Materialize parameters with the reference's rule and draws:
    ``split(key, n_leaves)``, the i-th key to the i-th leaf in the
    reference's flatten order (sorted keys, depth first), and for a
    ``normal`` leaf ``normal(k, shape, float32) * scale / sqrt(fan_in)``
    cast to ``dtype``; ``zeros`` and ``ones`` leaves draw nothing.  ``key``
    is a :mod:`repro_torch.prng` key (or the reference's, as numpy); the
    draws run on ``device`` (None = CUDA) and give the reference's weights
    there (``repro_torch.prng``).  On the ``meta`` device nothing is drawn
    and ``key`` is not read: every leaf is an empty meta tensor of its
    shape and ``dtype`` (the reference's ``abstract_params``)."""
    dev = resolve_device(device)
    specs = list(tree_leaves(schema))
    if dev.type == "meta":
        return tree_unflatten({name: torch.empty(spec.shape, dtype=dtype, device=dev)
                               for name, spec in specs})
    keys = prng.split(prng.as_key(key).to(dev), len(specs))

    def make(spec: ParamSpec, k: torch.Tensor) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        # scaled in place: a large leaf's float32 draw is not copied
        return prng.normal(k, spec.shape).mul_(std).to(dtype)

    return tree_unflatten({name: make(spec, keys[i]) for i, (name, spec) in enumerate(specs)})


def tree_unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts from ``/``-joined flat keys (inverse of :func:`tree_leaves`)."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def param_count(schema: Schema) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_leaves(schema)))


_marks = threading.local()


def no_batch_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of a product with no batch dimension (the
    reference's ``dot_general`` with empty batch dimensions), marked for
    ``RunFlags(remat="dots")``.  torch lowers every einsum to ``aten.bmm``,
    this kind with a batch of 1, which by shape is not told apart from a
    batched product whose batch happens to be 1; the dots policy saves the
    ``aten.bmm`` dispatched inside this call (:func:`in_no_batch_einsum`)."""
    _marks.depth = getattr(_marks, "depth", 0) + 1
    try:
        return torch.einsum(eq, a, b)
    finally:
        _marks.depth -= 1


def in_no_batch_einsum() -> bool:
    """True while :func:`no_batch_einsum` runs on this thread."""
    return getattr(_marks, "depth", 0) > 0


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's rounding order: normalise in float32, cast back to
    the input dtype, then multiply by gamma in that dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions: (seq,)
    or broadcastable to x's seq dim.  Angles, cos, sin and the rotation are
    float32, cast back to x's dtype at the end, as in the reference."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., seq, hd/2)
    angles = angles[..., :, None, :]  # heads axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss's per-position terms, as in the reference: logits (B, S, V)
    in float32, ``nll = (logsumexp - gold) * valid`` (B, S) and the mask
    ``valid`` (labels >= vocab_size or < 0 are masked, the padded-vocab
    convention; the padded columns count in the ``logsumexp``).  On
    DTensors vocab-parallel (:func:`vocab_parallel_nll`): no rank reads
    another's columns."""
    logits = logits.to(torch.float32)
    valid = (labels >= 0) & (labels < vocab_size)
    if isinstance(logits, DTensor):
        return vocab_parallel_nll(logits, labels, vocab_size), valid
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return (lse - gold) * valid, valid


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: int) -> torch.Tensor:
    """Mean CE over valid labels in float32 (:func:`token_nll`)."""
    nll, valid = token_nll(logits, labels, vocab_size)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


class _ShardNLL(torch.autograd.Function):
    """:func:`token_nll` on one rank's vocab columns ``[lo, lo + V_loc)``
    of float32 logits (B, S, V_loc); ``reduce(t, op)`` all-reduces a
    per-position tensor over the ranks that split the vocab.

    Forward: each shard's ``logsumexp``, combined as ``m + log(sum_r
    exp(lse_r - m))`` with ``m = max_r lse_r``; the gold logit read where
    the label falls in the shard, 0 elsewhere, summed.  On one shard
    ``exp(0) = 1`` and ``log(1) = 0``, so ``lse`` is the shard's to the bit.
    Backward, local: the two terms autograd forms for ``logsumexp`` and
    ``gather`` (``g * exp(x - lse)`` and ``-g`` scattered into zeros at the
    gold column, on the shard that holds it), added as autograd adds
    them, so one shard gives the plain ops' gradient to the bit."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_size, lo, reduce):
        valid = (labels >= 0) & (labels < vocab_size)
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        lse = torch.logsumexp(logits, dim=-1)
        m = reduce(lse, "max")
        lse = m + torch.log(reduce(torch.exp(lse - m), "sum"))
        idx = safe - lo
        mine = (idx >= 0) & (idx < logits.shape[-1])
        idx = torch.where(mine, idx, torch.zeros_like(idx))
        gold = reduce(torch.gather(logits, -1, idx[..., None])[..., 0].masked_fill(~mine, 0.0),
                      "sum")
        ctx.save_for_backward(logits, lse, idx, mine, valid)
        return (lse - gold) * valid

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine, valid = ctx.saved_tensors
        g = g * valid
        d_lse = g[..., None] * (logits - lse[..., None]).exp()
        d_gold = torch.zeros_like(logits).scatter_add_(-1, idx[..., None],
                                                       (-g).masked_fill(~mine, 0.0)[..., None])
        return d_lse + d_gold, None, None, None, None


def vocab_parallel_nll(logits, labels, vocab_size: int):
    """:func:`token_nll`'s ``nll`` of DTensor logits (B, S, V), float32,
    and labels (B, S), per rank in a ``local_map``: the logits as they are
    split on the batch and the vocab (anything else gathered), the labels
    split on the batch alike, and each rank's ``logsumexp`` and gold logit
    all-reduced over the mesh dims that split the vocab
    (``sharding.rules.all_reduce_shards``): three all-reduces of (B, S)
    floats (a max and two sums), where a gather of the vocab would move
    the logits.  The gradient stays on each rank's columns; nothing is
    reduced for it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import all_reduce_shards, shard_extent

    mesh = logits.device_mesh
    last = logits.dim() - 1
    pl = [p if p in (Shard(0), Shard(last)) else Replicate() for p in logits.placements]
    pb = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    lo = shard_extent(logits.shape[-1], mesh, pl, last)[0]

    def reduce(t, op):
        return all_reduce_shards(t, op, mesh, pl, last)

    return local_map(lambda x, y: _ShardNLL.apply(x, y, vocab_size, lo, reduce),
                     out_placements=pb, in_placements=(pl, pb), in_grad_placements=(pl, pb),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)
