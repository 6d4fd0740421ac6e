"""Logical-axis -> mesh-axis sharding rules with divisibility guards (port
of ``repro/sharding/rules.py``).

Every parameter leaf carries logical axis names (``ParamSpec.axes``,
gathered by ``LM.logical_axes``); this module maps them to mesh axes per
*strategy*, as the reference does:

* ``tp``    — megatron-style tensor parallel: heads/ffn/experts/vocab over
              "model", params replicated across "data"/"pod".
* ``fsdp``  — tp + the "embed" axis sharded over ("data",) (and "pod" on the
              multi-pod mesh): ZeRO-3-style weight sharding.
* ``zero1`` — tp for params, but optimizer moments additionally sharded over
              the data axis (ZeRO-1).
* ``dp``    — everything replicated (pure data parallel).

A mesh axis is only used when it exactly divides the dimension, otherwise
it is dropped (yi-9b's 4 kv heads stay replicated on a 16-way model axis).

A *spec* is a tuple with one entry per tensor dim, each ``None``, a mesh
axis name or a tuple of names: the entries of the reference's
``PartitionSpec``, so the two compare with ``==``.  A :class:`NamedSharding`
is a mesh (:class:`repro_torch.launch.mesh.AbstractMesh` or a
``DeviceMesh``) with a spec; on a ``DeviceMesh`` its :attr:`placements`
are the DTensor placements (:func:`placements`).  :func:`local_shard`
cuts a rank's shard out of a full array with no communication, and
:func:`distribute` places a full tensor that every rank holds alike.
The rest are the port's helpers for running on DTensors: every product
of an activation and a weight as GSPMD partitions it from the weight's
sharding (:func:`sharded_product`), a reduction over the shards of an
operand inside a ``local_map`` (:func:`all_reduce_shards`; the
vocab-parallel loss, the per-rank MoE combine and the sequence-parallel
decode softmax) and the global offset of a rank's shard
(:func:`shard_extent`), the placements
of an activation beside the batch (:func:`act_placements`), fsdp's
gather of a weight (:func:`gather_batch_dims`), redistribution to a
reference's placements (:func:`like`), the whole of a DTensor
(:func:`full`), and implicit replication of plain tensors under a mesh
(:func:`mesh_context`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import axis_names, mesh_shape
from repro_torch.models.common import no_batch_einsum, tree_leaves, tree_map

# Logical axes that shard over the tensor-parallel ("model") mesh axis.
_TP_AXES = (
    "vocab",
    "ffn",
    "q_heads",
    "kv_heads",
    "experts",
    "ssm_inner",
    "ssm_heads",
)

Spec = Tuple


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    name: str = "tp"           # tp | fsdp | zero1 | dp
    fsdp_axis: str = "embed"   # logical axis sharded over data under fsdp
    #: shard moments over data even when params are replicated over data
    zero1: bool = False

    @classmethod
    def from_name(cls, name: str) -> "ShardingStrategy":
        if name == "zero1":
            return cls(name="zero1", zero1=True)
        return cls(name=name)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: Spec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def _entry(axes: Tuple[str, ...]):
    """A spec entry as the reference's ``PartitionSpec`` holds it: one axis
    as its name, several as a tuple."""
    return axes[0] if len(axes) == 1 else axes


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return int(math.prod(shape[a] for a in axes))


def spec_for_param(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    strategy: ShardingStrategy,
) -> Spec:
    """The spec of one parameter from its logical axes."""
    entries = []
    used: set = set()  # a mesh axis may appear at most once per spec
    msz = mesh_shape(mesh)["model"]
    for dim, name in zip(shape, logical):
        assigned = None
        if strategy.name == "dp":
            entries.append(None)
            continue
        if name in _TP_AXES and "model" not in used and dim % msz == 0:
            assigned = "model"
        elif strategy.name == "fsdp" and name == strategy.fsdp_axis:
            da = _data_axes(mesh)
            if da and not used.intersection(da) and dim % _axis_size(mesh, da) == 0:
                assigned = _entry(da)
        if assigned is not None:
            used.update([assigned] if isinstance(assigned, str) else assigned)
        entries.append(assigned)
    return tuple(entries)


def param_shardings(axes_tree, abstract_tree, mesh, strategy: ShardingStrategy):
    """:class:`NamedSharding` tree for the whole parameter tree
    (``abstract_tree``: tensors of the leaves' shapes, meta ones will do)."""
    return tree_map(lambda ax, t: NamedSharding(mesh, spec_for_param(ax, t.shape, mesh, strategy)),
                    axes_tree, abstract_tree)


def moment_shardings(param_shardings_tree, abstract_tree, mesh, strategy: ShardingStrategy):
    """Optimizer-moment shardings.  Under zero1, add the data axis to the
    first dimension that is unsharded and divisible (ZeRO-1 partitioning)."""
    if not strategy.zero1:
        return param_shardings_tree

    da = _data_axes(mesh)
    dsz = _axis_size(mesh, da)

    def one(ns: NamedSharding, t) -> NamedSharding:
        spec = list(ns.spec) + [None] * (len(t.shape) - len(ns.spec))
        for i, (cur, dim) in enumerate(zip(spec, t.shape)):
            if cur is None and dim % dsz == 0 and dim >= dsz:
                spec[i] = _entry(da)
                break
        return NamedSharding(mesh, tuple(spec))

    return tree_map(one, param_shardings_tree, abstract_tree)


# ---------------------------------------------------------------------------
# Activations / inputs / caches
# ---------------------------------------------------------------------------


def batch_spec_axes(mesh, batch: int, include_model: bool = False) -> Optional[Tuple[str, ...]]:
    """Largest suffix-trimmed tuple of ("pod","data"[,"model"]) dividing the
    global batch.  ``include_model`` lets tiny replicated models (mamba2-130m)
    spread the batch over the whole mesh."""
    da = _data_axes(mesh) + (("model",) if include_model else ())
    while da and batch % _axis_size(mesh, da) != 0:
        da = da[:-1]
    return da or None


def _batch_entry(mesh, batch: int, include_model: bool = False):
    ba = batch_spec_axes(mesh, batch, include_model)
    return None if ba is None else _entry(ba)


def token_sharding(mesh, batch: int, include_model: bool = False) -> NamedSharding:
    return NamedSharding(mesh, (_batch_entry(mesh, batch, include_model), None))


def embeds_sharding(mesh, batch: int, include_model: bool = False) -> NamedSharding:
    """(B, T, D) stub-embedding inputs (audio frames / vision patches)."""
    return NamedSharding(mesh, (_batch_entry(mesh, batch, include_model), None, None))


def cache_sharding(
    path: Tuple[str, ...],
    shape: Sequence[int],
    mesh,
    batch: int,
    cfg,
    mode: str = "auto",
) -> NamedSharding:
    """Decode-cache leaf sharding, keyed on the leaf's path in the cache tree.

    KV caches ``(layers, [sub,] B, W, KV, hd)``: batch over the data axes,
    then kv-heads over "model" when divisible, otherwise the sequence (W)
    dim when divisible (long-context caches), otherwise replicated.
    SSM states ``(layers, [sub,] B, H, P, N)``: batch over data, heads over
    "model" when divisible.
    """
    del cfg  # the reference takes it and reads nothing of it
    names = [str(p) for p in path]
    ba = batch_spec_axes(mesh, batch)
    msz = mesh_shape(mesh)["model"]

    if "pos" in names[-1:]:
        return NamedSharding(mesh, ())

    spec: list = [None] * len(shape)
    # the batch dim: the first dim equal to `batch`
    try:
        bdim = list(shape).index(batch)
    except ValueError:
        bdim = None
    if bdim is not None and ba is not None:
        spec[bdim] = _entry(ba)

    leaf = names[-1]
    if leaf in ("k", "v"):
        kv_dim, w_dim = len(shape) - 2, len(shape) - 3
        if mode == "batch":
            pass  # batch-only: replicate over the model axis
        elif mode == "seq":
            if shape[w_dim] % msz == 0:
                spec[w_dim] = "model"
        elif shape[kv_dim] % msz == 0:
            spec[kv_dim] = "model"
        elif shape[w_dim] % msz == 0:
            spec[w_dim] = "model"
    elif leaf == "state":
        h_dim = len(shape) - 3
        if shape[h_dim] % msz == 0:
            spec[h_dim] = "model"
    elif leaf.startswith("conv"):
        c_dim = len(shape) - 2
        if shape[c_dim] % msz == 0:
            spec[c_dim] = "model"
    return NamedSharding(mesh, tuple(spec))


def cache_shardings(abstract_cache, mesh, batch: int, cfg, mode: str = "auto"):
    """:func:`cache_sharding` of every leaf of a cache tree (nested dicts;
    meta tensors will do, ``LM.init_cache(..., device="meta")``)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return cache_sharding(path, node.shape, mesh, batch, cfg, mode=mode)

    return walk(abstract_cache, ())


def place_cache(cache, mesh, batch: int, cfg, mode: str = "auto"):
    """A decode cache distributed by :func:`cache_shardings` over ``mesh``
    (a ``DeviceMesh``): the counterpart of the reference's
    ``jit(in_shardings=c_sh)``.  A DTensor leaf is redistributed to its
    rule's placements; a plain leaf, which every rank holds alike (a cache
    made from the same prompt, or zeros), keeps its own slice with nothing
    sent; a meta leaf (``LM.abstract_cache``) becomes a DTensor of meta
    shards (:func:`abstract_place`)."""
    shardings = cache_shardings(cache, mesh, batch, cfg, mode=mode)

    def one(t, sh: NamedSharding):
        if is_dtensor(t):
            return t if tuple(t.placements) == sh.placements else t.redistribute(
                mesh, sh.placements)
        if t.is_meta:
            return abstract_place(t, sh)
        return distribute(t, sh)

    return tree_map(one, cache, shardings)


def local_shape(shape, placements_, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` (the rules
    shard only dims that their mesh axes divide)."""
    out = list(shape)
    for i, p in enumerate(placements_):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def abstract_place(meta, sharding: NamedSharding):
    """A DTensor of ``meta``'s shape and dtype placed by ``sharding`` whose
    shard on this rank is a meta tensor (a shape and a dtype, no data, no
    memory): the dry-run's stand-in for a sharded input."""
    mesh, pl = sharding.mesh, sharding.placements
    local = torch.empty(local_shape(meta.shape, pl, mesh), dtype=meta.dtype, device="meta")
    return wrap_local(local, mesh, pl, meta.shape)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh):
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    every mesh dim that entry d names, ``Replicate()`` on the others.  A
    tuple entry such as ``("pod", "data")`` shards pod-major, as JAX does,
    which DTensor does for mesh dims in its own order; the rules never
    name them in another order, and such a spec raises ``ValueError``
    (DTensor would need a ``_StridedShard``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of the mesh's order "
                             f"{names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} appears twice in spec {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def local_shard(full, placements_, mesh):
    """This rank's shard of ``full`` (a tensor or numpy array every rank
    holds alike) under ``placements_``: equal slices, mesh dims in order,
    no communication.  The rules shard only dims that their mesh axes
    divide."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements_):
        if not p.is_shard():
            continue
        n = mesh.size(i)
        size = out.shape[p.dim]
        if size % n:
            raise ValueError(f"dim {p.dim} of size {size} does not split {n} ways")
        step = size // n
        idx = [slice(None)] * out.ndim
        idx[p.dim] = slice(coord[i] * step, (coord[i] + 1) * step)
        out = out[tuple(idx)]
    return out


def wrap_local(local, mesh, placements_, shape):
    """The DTensor of global ``shape`` (contiguous) whose shard on this rank
    is ``local``: unchecked, nothing is sent."""
    from torch.distributed.tensor import DTensor

    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def place(full, mesh, placements_):
    """A DTensor of ``placements_`` on ``mesh`` from ``full``, a tensor
    that every rank holds alike (made from the same seed, or read from the
    same checkpoint): each rank keeps its own slice, nothing is sent."""
    local = local_shard(full.detach(), placements_, mesh).contiguous()
    return wrap_local(local, mesh, placements_, full.shape)


def distribute(full, sharding: NamedSharding):
    """:func:`place` under a :class:`NamedSharding`."""
    return place(full, sharding.mesh, sharding.placements)


def act_placements(ref, shape, model_dim: Optional[int] = None) -> list:
    """Placements for an activation of ``shape`` beside ``ref`` (a DTensor
    whose dim 0 is the batch): over each mesh dim the batch as ``ref`` has
    it where ``ref`` splits it there, else, over "model", dim ``model_dim``
    (heads, channels, experts) sharded where it divides, else replicated.
    What the per-head and per-expert code runs on, one rank's shard.  A
    batch split over "model" too (``dp`` with the model axis in the batch)
    stays split: each rank then runs every head of its own sequences."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = ref.device_mesh
    out = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, ref.placements)):
        if p == Shard(0):
            out.append(p)
        elif name == "model":
            ok = model_dim is not None and shape[model_dim] % mesh.size(i) == 0
            out.append(Shard(model_dim) if ok else Replicate())
        else:
            out.append(Replicate())
    return out


def _letters(eq: str, x, w) -> Tuple[str, str, str]:
    """The subscripts of ``eq`` ("xs,ws->os") with a leading ``...`` in
    ``xs`` and ``os`` spelled out as upper-case letters for ``x``'s rank."""
    ins, os_ = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    if "..." in ws or len(ws) != w.dim():
        raise ValueError(f"sharded_product: {eq!r} does not name the weight's {w.dim()} dims")
    if xs.startswith("..."):
        lead = "ABCDEFGH"[: x.dim() - (len(xs) - 3)]
        xs, os_ = lead + xs[3:], os_.replace("...", lead)
    if len(xs) != x.dim():
        raise ValueError(f"sharded_product: {eq!r} does not name the input's {x.dim()} dims")
    return xs, ws, os_


def _plain_product(eq: str, x, w, via: str):
    """``x`` times ``w`` by the site's own op (see :func:`sharded_product`)."""
    if via == "matmul":
        return torch.matmul(x, w)
    if via == "no_batch":
        return no_batch_einsum(eq, x, w)
    if via == "einsum":
        return torch.einsum(eq, x, w)
    raise ValueError(f"unknown via {via!r}; expected 'matmul', 'no_batch' or 'einsum'")


def sharded_product(eq: str, x, w, via: str = "einsum"):
    """The product of an activation ``x`` and a weight ``w`` spelled by
    ``eq`` ("xs,ws->os"; ``xs`` and ``os`` may start with ``...``), run on
    plain tensors as the site always ran it: ``via`` "matmul" is ``x @ w``
    (``aten.mm``), "no_batch" the marked
    :func:`repro_torch.models.common.no_batch_einsum` (``aten.bmm``, saved
    by ``remat="dots"``), "einsum" ``torch.einsum``.

    On DTensors each rank runs the same op on its own shards in a
    ``local_map``, the layout GSPMD gives the reference's product from the
    weight's sharding, never DTensor's own plan:

    * the weight's "model" shard on an output dim (ffn, heads, kv heads,
      vocab, experts, ssm channels and heads): column-parallel.  ``x``
      replicated over "model" (or, for a dim that ``x`` shares with the
      weight, the experts, sharded alike); the output sharded on that
      dim, no collective;
    * on a contracted dim (``w_down``, ``wo``, ``out_proj``):
      row-parallel.  ``x`` sharded on it, as the column product leaves it;
      the output a ``Partial`` over "model", reduced once to the residual
      stream's placement (replicated over "model");
    * the weight replicated over "model" (a dim that "model" does not
      divide): the product on the rank's own rows; or, where ``x`` comes
      in split over "model" on a contracted dim (the SSM decode's output
      under ``dp`` with the model axis in the batch, on torch 2.11),
      row-parallel on the rank's rows of the weight, a slice.

    Over every other mesh dim, and over "model" where the weight is
    replicated there, ``x`` keeps each split of a dim that the output
    carries and the weight does not (the batch, over "data", and over
    "model" under ``dp`` with the model axis in the batch); any other
    split is gathered.  The weight is gathered whole over every mesh dim
    but "model" (fsdp).  A placement it does not know (a weight's "model"
    placement other than a shard of one of its dims, one operand a DTensor
    and the other not) raises ``ValueError``: no product is left to
    DTensor's propagation."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return _plain_product(eq, x, w, via)
    if not (is_dtensor(x) and is_dtensor(w)):
        raise ValueError("sharded_product: one operand is a DTensor and the other is not")
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    xs, ws, os_ = _letters(eq, x, w)
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    col = pwm = None  # the weight's letter split over "model", its placement there
    for name, p in zip(names, w.placements):
        if name == "model" and not p.is_replicate():
            if type(p) is not Shard:
                raise ValueError(f"sharded_product {eq!r}: the weight's placement {p} over "
                                 "'model' is not a shard of one of its dims")
            col, pwm = ws[p.dim], p
    if col is None and "model" in names:
        # a replicated weight beside an input split over "model" on a
        # contracted dim: gathering the input would repeat the product on
        # every rank of the group, so each rank takes its rows of the weight
        p = x.placements[names.index("model")]
        if type(p) is Shard and xs[p.dim] in ws and xs[p.dim] not in os_:
            col, pwm = xs[p.dim], Shard(ws.index(xs[p.dim]))
    pw, px, pout, gx, gw = [], [], [], [], []
    for name, pwi, pxi in zip(names, w.placements, x.placements):
        if name == "model" and col is not None:
            # row-parallel, or a dim both share (the experts): x split
            # alike; column-parallel: every rank reads the whole input and
            # its grad is a part of the sum
            shared = col in xs
            px.append(Shard(xs.index(col)) if shared else Replicate())
            gx.append(px[-1] if shared else Partial())
            pw.append(pwm)
            gw.append(pwm)
            pout.append(Shard(os_.index(col)) if col in os_ else Partial())
            continue
        pw.append(Replicate())
        free = (type(pxi) is Shard and xs[pxi.dim] in os_ and xs[pxi.dim] not in ws)
        px.append(pxi if free else Replicate())
        gx.append(px[-1])
        # the weight's grad from a rank's own rows is a part of the sum
        gw.append(Partial() if free else Replicate())
        pout.append(Shard(os_.index(xs[pxi.dim])) if free else Replicate())
    out = local_map(lambda a, b: _plain_product(eq, a, b, via), out_placements=pout,
                    in_placements=(px, pw), in_grad_placements=(gx, gw), device_mesh=mesh,
                    redistribute_inputs=True)(x, w)
    if any(p.is_partial() for p in pout):
        out = out.redistribute(mesh, [Replicate() if p.is_partial() else p for p in pout])
    return out


def shard_extent(size: int, mesh, placements_, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of a dim of ``size``
    that ``placements_`` split on ``mesh``: DTensor's split, mesh dims in
    order, each a ``torch.chunk`` (the last shards shorter where the mesh
    dim does not divide)."""
    coord = mesh.get_coordinate()
    start = 0
    for i, p in enumerate(placements_):
        if p.is_shard(dim):
            step = -(-size // mesh.size(i))
            start += coord[i] * step
            size = max(0, min(step, size - coord[i] * step))
    return start, size


class _SumShards(torch.autograd.Function):
    """:func:`all_reduce_shards`' sum: the all-reduce forward, the gradient
    passed through."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        return _all_reduce(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _all_reduce(t, op: str, mesh, dims):
    from torch.distributed._functional_collectives import AsyncCollectiveTensor, all_reduce

    for i in dims:
        t = all_reduce(t, op, (mesh, i))
        if isinstance(t, AsyncCollectiveTensor):
            t = t.wait()
    return t


def all_reduce_shards(t, op: str, mesh, placements_, dim: Optional[int] = None):
    """Inside a ``local_map``: ``t``, this rank's part of a reduction over
    an operand that ``placements_`` place on ``mesh`` (its dim ``dim``, or
    any dim where None), all-reduced with ``op`` ("sum" or "max") over the
    mesh dims that split that dim: a local ``logsumexp`` or sum made
    global.  Over a mesh dim where the operand is whole, or of size 1, it
    does nothing, so on one shard it is the identity, to the bit.

    "max" carries no gradient (the shift of a softmax or a ``logsumexp``,
    whose gradient is zero).  "sum" passes its gradient through: it is for
    a result that leaves the ``local_map`` replicated over those dims,
    whose gradient each rank then receives whole, and each part's gradient
    is that whole; the inputs that made the parts declare theirs
    ``Partial`` there.  A sum that the rank's own code reads on (a
    softmax's normaliser) would need the other ranks' gradient terms too:
    there it is exact only where nothing is differentiated (decode)."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown op {op!r}; expected 'sum' or 'max'")
    dims = [i for i, p in enumerate(placements_)
            if p.is_shard() and (dim is None or p.is_shard(dim)) and mesh.size(i) > 1]
    if not dims:
        return t
    if op == "max":
        return _all_reduce(t.detach(), "max", mesh, dims)
    return _SumShards.apply(t, mesh, dims)


def gather_batch_dims(w):
    """A weight DTensor gathered whole over every mesh dim but "model"
    (fsdp's "embed" shards over "data" and "pod"), its "model" shard kept:
    FSDP's gather before the compute."""
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    pl = [p if name == "model" else Replicate() for name, p in zip(names, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(w.device_mesh, pl)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def mesh_context(tree):
    """Where ``tree``'s leaves are DTensors, DTensor's implicit replication:
    a plain tensor met beside a DTensor (a position ``arange``, a mask, a
    0-dim constant, all alike on every rank) is taken as replicated.
    Elsewhere a context that does nothing."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    first = next(tree_leaves(tree), (None, None))[1]
    return implicit_replication() if is_dtensor(first) else contextlib.nullcontext()


def like(t, ref):
    """``t`` redistributed to ``ref``'s mesh and placements where ``ref``
    is a DTensor (Partial -> Replicate is an all-reduce, Partial -> Shard a
    reduce-scatter, Replicate -> Shard a local slice); ``t`` otherwise."""
    if not is_dtensor(ref) or tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def full(t):
    """A plain tensor of the whole of ``t`` (a DTensor's ``full_tensor()``:
    a collective unless it is replicated)."""
    return t.full_tensor() if is_dtensor(t) else t
