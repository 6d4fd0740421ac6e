"""The dry-run's counters (port of ``repro/launch/hlo.py``).

The reference reads XLA's compiled, SPMD-partitioned module: its
``cost_analysis()``, its ``memory_analysis()`` and the collectives in its
HLO text.  The port has no compiled artifact, so :class:`StepTrace`
counts what one rank dispatches while a step runs: a ``TorchDispatchMode``
that sits below DTensor (it hands every DTensor op back to DTensor's own
dispatch and sees the ops DTensor then runs on this rank's local
tensors), so every number is per rank, as the reference's are per
device.  On a fake process group with meta shards (``launch/dryrun.py``)
the step moves no data and allocates no memory; the same counters run on
real ranks too.  They do not run under ``FakeTensorMode``: the ops it
sees on ``FakeTensor``s are DTensor's shape propagation and are not
counted, so :meth:`StepTrace.arguments` refuses fakes.

* :func:`collective_bytes`: the payload bytes of each ``_c10d_functional``
  collective (the bytes of its output on this rank, as the reference sums
  the output shapes of the HLO's collectives) by the reference's kind
  names, ``total`` and ``op_counts``; ``by_axis`` splits the bytes by the
  mesh dim of each collective's group, so that the roofline prices the
  NVLink-domain "model" axis apart.  A group is that mesh dim's when it
  holds the same ranks, whatever its name: a backend may run a collective
  on another group object of the same ranks (the default group for a
  mesh dim that spans the world, a flattened group of one real dim).
  :func:`largest_collectives` gives each kind's largest single payload.
* :func:`normalize_cost`: ``flops`` from ``torch.utils.flop_counter``'s
  formulas (the port's kernels register theirs; :func:`flops_by_op`
  splits them by op and input shapes), ``bytes_accessed``, the
  sum of each non-view op's input and output bytes (an unfused count:
  XLA's fusions keep intermediates out of memory, eager PyTorch does not),
  and ``transcendentals``, the elements that exp, log, tanh, sigmoid,
  rsqrt, sin, cos and erf produce.
* :func:`memory_stats`: the reference's keys from the live storages of
  this rank: ``argument_bytes`` (the step's inputs), ``output_bytes``,
  ``alias_bytes`` (outputs that are donated inputs: parameters and
  optimizer state updated in place, a decode cache), ``temp_bytes`` (the
  peak of what the step allocated, less its new outputs) and the
  reference's ``peak_bytes = argument + temp + max(output - alias, 0)``.
  Storages are counted at their size, with no allocator slack.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: ``_c10d_functional`` op names (their overload packets) by kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

_TRANSCENDENTAL = {
    "exp", "exp_", "log", "log_", "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_",
    "sin", "sin_", "cos", "cos_", "erf", "erf_",
}

#: ops that move no tensor data
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "alias",
    "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "size", "stride", "sym_size",
    "sym_stride", "numel", "dim",
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _fake(*trees) -> bool:
    """Whether any tensor in ``trees`` is a ``FakeTensor``.  DTensor derives
    each op's output shape by running the op on fake tensors of the global
    shapes (under a ``FakeTensorMode``, below every user mode): those runs
    are not a rank's work, and the trace's own inputs are real or meta
    tensors, never fakes."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in _tensors(trees))


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st


class StepTrace(TorchDispatchMode):
    """Counts one rank's ops while active (``with StepTrace(mesh) as tr:``).

    ``mesh`` (a ``DeviceMesh``) names the mesh dim of each collective's
    group.  :meth:`arguments` registers the step's inputs (before it runs)
    and :meth:`outputs` its outputs (after), ``donated`` the inputs the
    step may update in place."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Counter = Counter()  # (op, input shapes) -> FLOPs
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.collectives: list = []  # (kind, bytes, mesh dim name or "other")
        self._groups: Dict[str, str] = {}  # group name -> mesh dim name or "other"
        self._dim_ranks: list = []  # (mesh dim name, its group's ranks)
        if mesh is not None:
            import torch.distributed as dist

            for i, name in enumerate(mesh.mesh_dim_names):
                group = mesh.get_group(i)
                self._groups[group.group_name] = name
                self._dim_ranks.append((name, frozenset(dist.get_process_group_ranks(group))))
        self._args: Dict[int, int] = {}
        self._donated: set = set()
        self._new: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self.new_output_bytes = 0

    # -- registration ---------------------------------------------------------
    def arguments(self, tree, donated: Iterable = ()) -> None:
        if _fake([_local(t) for t in _tensors((tree, list(donated)))]):
            raise ValueError("StepTrace counts real or meta tensors: it takes the ops on "
                             "FakeTensors for DTensor's shape propagation and counts none")
        for t in _tensors(tree):
            key, st = _storage_key(_local(t))
            self._args[key] = st.nbytes()
        for t in _tensors(list(donated)):
            self._donated.add(_storage_key(_local(t))[0])

    def outputs(self, tree) -> None:
        seen = set()
        for t in _tensors(tree):
            key, st = _storage_key(_local(t))
            if key in seen:
                continue
            seen.add(key)
            nb = st.nbytes()
            self.output_bytes += nb
            if key in self._donated:
                self.alias_bytes += nb
            elif key not in self._args:
                self.new_output_bytes += nb

    # -- dispatch ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _fake(args, kwargs):  # DTensor's shape propagation, not this rank's work
            return func(*args, **kwargs)
        packet = func.overloadpacket
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            out = func(*args, **kwargs)
            kind = _KINDS.get(packet.__name__)
            if kind is not None:
                group = kwargs.get("group_name", next(
                    (a for a in reversed(args) if isinstance(a, str)), None))
                self.collectives.append((kind, sum(_nbytes(t) for t in _tensors(out)),
                                         self._axis(group)))
            self._track(out)
            return out
        if packet not in flop_registry and func.namespace == "aten":
            # a composite op's parts, counted one by one (FlopCounterMode's rule)
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if _fake(out):
            return out
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            shapes = tuple(tuple(t.shape) for t in _tensors((args, kwargs)))
            self.flops_by_op[(str(packet), shapes)] += n
        name = packet.__name__
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        if not (func.is_view or name in _NO_BYTES):
            self.bytes_accessed += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                                    + sum(_nbytes(t) for t in _tensors(out)))
        self._track(out)
        return out

    def _axis(self, group: Optional[str]) -> str:
        """The mesh dim whose group holds the same ranks as the group named
        ``group``, or "other"."""
        if group not in self._groups:
            axis = "other"
            try:
                import torch.distributed as dist
                from torch.distributed.distributed_c10d import _resolve_process_group

                ranks = frozenset(dist.get_process_group_ranks(_resolve_process_group(group)))
                axis = next((n for n, r in self._dim_ranks if r == ranks), "other")
            except (KeyError, RuntimeError, ValueError, TypeError):
                pass  # not a group this process knows
            self._groups[group] = axis
        return self._groups[group]

    def _track(self, out) -> None:
        for t in _tensors(out):
            key, st = _storage_key(t)
            if key in self._args or key in self._new:
                continue
            nb = st.nbytes()
            self._new[key] = nb
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._new.pop(key, 0)


def collective_bytes(trace: StepTrace) -> Dict[str, Any]:
    """Per-rank payload bytes by collective kind, ``total``, ``op_counts``
    and ``by_axis`` (bytes by the mesh dim of the collective's group)."""
    out: Counter = Counter()
    counts: Counter = Counter()
    axes: Counter = Counter()
    for kind, nbytes, axis in trace.collectives:
        out[kind] += nbytes
        counts[kind] += 1
        axes[axis] += nbytes
    result: Dict[str, Any] = {k: float(v) for k, v in out.items()}
    result["total"] = float(sum(out.values()))
    result["op_counts"] = dict(counts)
    result["by_axis"] = {k: float(v) for k, v in axes.items()}
    return result


def largest_collectives(trace: StepTrace) -> Dict[str, float]:
    """Each collective kind's largest single payload on one rank, bytes:
    what shows a tensor moved whole (the logits, the MoE's slots) where a
    sum of many small ones would not."""
    out: Dict[str, float] = {}
    for kind, nbytes, _ in trace.collectives:
        out[kind] = max(out.get(kind, 0.0), float(nbytes))
    return out


def normalize_cost(trace: StepTrace) -> Dict[str, float]:
    """``flops``, ``bytes_accessed`` (unfused) and ``transcendentals`` of
    one rank."""
    return {
        "flops": float(trace.flops),
        "bytes_accessed": float(trace.bytes_accessed),
        "transcendentals": float(trace.transcendentals),
    }


def flops_by_op(trace: StepTrace, shapes: bool = False) -> Dict[Any, float]:
    """One rank's FLOPs by op (``shapes``: by op and input shapes), largest
    first."""
    out: Counter = Counter()
    for (op, shp), n in trace.flops_by_op.items():
        out[(op, shp) if shapes else op] += n
    return {k: float(v) for k, v in out.most_common()}


def memory_stats(trace: StepTrace) -> Dict[str, float]:
    """The reference's memory keys from one rank's live storages."""
    arg = float(sum(trace._args.values()))
    out, alias = float(trace.output_bytes), float(trace.alias_bytes)
    temp = float(max(trace.peak - trace.new_output_bytes, 0))
    return {
        "argument_bytes": arg,
        "output_bytes": out,
        "temp_bytes": temp,
        "alias_bytes": alias,
        # peak per-rank estimate: live args + temps (aliased outputs reuse
        # argument space)
        "peak_bytes": arg + temp + max(out - alias, 0.0),
    }


def trace_step(step, args: tuple, mesh=None, donated: Optional[Iterable] = None):
    """``step(*args)`` under a :class:`StepTrace`; returns (its outputs,
    the trace)."""
    trace = StepTrace(mesh)
    trace.arguments(args, donated or ())
    with trace:
        out = step(*args)
    trace.outputs(out)
    return out, trace
