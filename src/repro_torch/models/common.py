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


def gather_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` whole along ``dim``: a DTensor sharded there is all-gathered
    over those mesh dims (its other placements kept); anything else is
    returned as it is.  The loss reads the vocab whole (its ``logsumexp``
    would gather it too, and DTensor's masked ``gather`` over a sharded
    vocab fails on a (B, S, 1) index)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    dim %= t.dim()
    pl = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: int) -> torch.Tensor:
    """Mean CE over valid labels in float32; labels >= vocab_size or < 0
    are masked (the padded-vocab convention), as in the reference."""
    logits = gather_dim(logits.to(torch.float32), -1)
    valid = (labels >= 0) & (labels < vocab_size)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = take_last(logits, safe)
    nll = (lse - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def take_last(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[..., idx]`` per position: ``gather`` along the last dim of ``t``
    (B, S, V) at ``idx`` (B, S).  On DTensors (``t`` whole along its last
    dim, :func:`gather_dim`) each rank gathers its own rows in a
    ``local_map``, the batch as ``t`` has it and the rest whole: DTensor's strategy may shard ``t``'s last dim for the
    gather and give a masked partial, whose reduction fails on a 3-d
    tensor in torch 2.13."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return torch.gather(t, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Replicate, Shard

    pl = [Shard(0) if p == Shard(0) else Replicate() for p in t.placements]
    return local_map(lambda a, i: torch.gather(a, -1, i[..., None])[..., 0],
                     out_placements=pl, in_placements=(pl, pl), device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t, idx)
