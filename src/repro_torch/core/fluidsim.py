"""Fluid cluster simulator in PyTorch (port of ``repro/core/jaxsim.py``).

A fixed-timestep, batched approximation of the Ada-SRSF dynamics: a
struct-of-arrays state over jobs plus per-server occupancy, advanced tick by
tick with branchless masks.  The reference's ``vmap`` over lanes (seeds)
becomes a lane axis written out in every tensor, and its ``lax.scan`` over
ticks a Python loop, run in blocks of :data:`BLOCK_TICKS` ticks over
persistent buffers (:class:`_ChunkRunner`).  On the card each block is
captured once per batch shape as a CUDA graph and replayed, as the
reference compiles its chunk once (``_chunk_jit``); on the CPU the same
blocks run eagerly.  The host syncs once per chunk of ``chunk_steps``
ticks, as the reference does, to retire finished lanes and compact the
batch.

Every executed tick calls the fluid step core once for all lanes
(:mod:`repro_torch.kernels.fluidstep`: the CUDA kernel on the card, its
plain version on the CPU).  The tick is the reference's tick: same
operations in the same order, float32 throughout, Python-float
coefficients taken as float32, first-index ``argmin`` ties, and the same
next-event skip, live freeze and lane/job compaction, so the finished mask
and every finish tick match the reference.

Ported: monolithic traces and WFBP bucket streams (``fusion`` "all",
"none" or a byte threshold: each job's gradient exchange drains as a FIFO
stream of buckets, gated per bucket, with the one-shot gating closure
``gating="fixedpoint"`` or the legacy four rounds ``gating="rounds"``),
the threshold gating policies (``ada``, ``srsfN``) and the exact k-way
lookahead (``kwayK``), every gang placement
(``consolidate``/``first_fit``/``least_loaded``/``random``/``rack_pack``),
any static fabric.  Under WFBP or exact k-way the step core also returns
the ``(L, J, J)`` overlap plane.  The ``random`` placement draws its
server order per lane and tick from the threefry port
(:mod:`repro_torch.prng`), ``uniform(fold_in(PRNGKey(placement_seed),
i))`` at the lane's own tick counter ``i``, as the reference does, inside
the chunk's CUDA graph.  :func:`sample_trace`, :func:`simulate_one` and
:func:`monte_carlo_jct` draw the paper's workload from a key, as the
reference's do.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import netmodel
from repro_torch.core.cluster import TABLE_III
from repro_torch.core.contention import ContentionParams
from repro_torch.core.topology import Topology, nic_topology
from repro_torch.core.trace import PAPER_GPU_DISTRIBUTION
from repro_torch.device import resolve_device
from repro_torch.kernels.fluidstep import FLUID_KERNEL_IMPLS, fluid_step_core
from repro_torch.kernels.fluidstep.kernel import fluid_step_core_cuda

# job phases
QUEUED, COMPUTE, COMM, DONE = 0, 1, 2, 3

#: Safety margin (in ticks) for float tick-count conversions:
#: ``floor(x/dt - margin) + 1`` never overestimates ``ceil(x/dt)``.
_TICK_MARGIN = 1e-2

#: "No event" sentinel for per-job tick caps (far above any max_steps).
_BIG_TICKS = 1 << 30

_F32 = torch.float32
_I32 = torch.int32

#: State leaves that carry the job axis (second axis), compacted with it.
_JOB_LEAVES = ("phase", "loads", "iters_left", "rem", "servers", "finish", "started",
               "bucket")


@dataclasses.dataclass(frozen=True)
class FluidSimConfig:
    """The reference's ``JaxSimConfig`` fields and defaults, plus
    ``device`` (None = CUDA, see :func:`repro_torch.device.resolve_device`).
    ``kernel`` picks the step core: "" lets the device decide (CUDA kernel
    on the card, plain version on the CPU), "ref" forces the plain version."""

    n_servers: int = 16
    gpus_per_server: int = 4
    dt: float = 0.05          # [s]
    max_steps: int = 400_000  # dt * max_steps = simulated horizon cap
    policy: str = "ada"       # ada | srsfN | kwayK
    placement: str = "consolidate"
    a: float = ContentionParams().a
    b: float = ContentionParams().b
    eta: float = ContentionParams().eta
    dual_threshold: float = ContentionParams().dual_threshold
    server_bandwidth: Tuple[float, ...] = ()
    topology: Optional[Topology] = None
    placement_seed: int = 0
    chunk_steps: int = 256
    gating: str = "fixedpoint"
    skip: bool = True
    compact: bool = True
    kernel: str = ""
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.gating not in ("fixedpoint", "rounds"):
            raise ValueError(
                f"unknown gating mode {self.gating!r}: expected "
                "'fixedpoint' or 'rounds'"
            )
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {self.chunk_steps}")
        netmodel.parse_policy(self.policy)
        netmodel.canonical_placement(self.placement)
        if self.kernel and self.kernel not in FLUID_KERNEL_IMPLS:
            raise ValueError(
                f"unknown fluid step impl {self.kernel!r}; expected '' or one "
                f"of {FLUID_KERNEL_IMPLS}"
            )


def _sub_product(x: torch.Tensor, a, b: torch.Tensor) -> torch.Tensor:
    """``x - a * b`` rounded once to float32, as the reference's compiled
    CPU graph contracts the comm drains into a fused multiply-add (ROADMAP
    R4): float32 operands, the product exact in float64."""
    a = a.to(torch.float64) if isinstance(a, torch.Tensor) else a
    return (x.to(torch.float64) - a * b.to(torch.float64)).to(_F32)


def _ticks_to_zero(x: torch.Tensor, inv_dt: float) -> torch.Tensor:
    """Safe underestimate of ``ceil(x / dt)`` (see :data:`_TICK_MARGIN`)."""
    return torch.floor(x * inv_dt - _TICK_MARGIN).to(_I32) + 1


class _Statics:
    """Config-derived constants on the simulation's device."""

    def __init__(self, cfg: FluidSimConfig, device: torch.device) -> None:
        ns = cfg.n_servers
        topo = cfg.topology if cfg.topology is not None else nic_topology(ns)
        if topo.n_servers != ns:
            raise ValueError(
                f"topology covers {topo.n_servers} servers, config has {ns}"
            )
        spec = netmodel.parse_policy(cfg.policy)
        self.max_ways = spec.max_ways
        self.gated = spec.threshold_gated
        self.exact_kway = spec.exact_lookahead
        self.eta_over_b = cfg.eta / cfg.b
        self.placement = netmodel.canonical_placement(cfg.placement)
        self.bw = torch.tensor(
            netmodel.server_bandwidth_array(cfg.server_bandwidth, ns),
            dtype=_F32, device=device,
        )
        inc_t = torch.tensor(topo.incidence(), dtype=_F32, device=device).T
        self.inc_t = inc_t.contiguous()  # (S, D)
        self.inc_out_t = (1.0 - inc_t).contiguous()
        self.oversub = torch.tensor(topo.oversub_array(), dtype=_F32, device=device)
        self.n_domains = int(self.oversub.shape[0])
        self.server_rack = torch.tensor(topo.server_rack(), dtype=_I32, device=device)
        self.n_racks = len(topo.rack_groups())
        self.server_index = torch.arange(ns, dtype=_F32, device=device)
        self.place_key = prng.PRNGKey(cfg.placement_seed, device)
        self.index_le = self.server_index[None, :] <= self.server_index[:, None]
        self.inv_dt = float(np.float32(1.0 / cfg.dt))
        self.dt = float(np.float32(cfg.dt))  # the float32 tick, as a Python float
        # 0-dim operands for torch.where: a Python scalar there becomes a
        # fresh device tensor (one fill launch) on every call
        f32 = lambda v: torch.tensor(v, dtype=_F32, device=device)  # noqa: E731
        i32 = lambda v: torch.tensor(v, dtype=_I32, device=device)  # noqa: E731
        self.zero, self.one, self.inf = f32(0.0), f32(1.0), f32(float("inf"))
        self.zero_i, self.big_i = i32(0), i32(_BIG_TICKS)
        self.compute, self.comm, self.done = i32(COMPUTE), i32(COMM), i32(DONE)


def _is_wfbp(trace: Dict[str, torch.Tensor]) -> bool:
    """A multi-bucket trace: the reference keys its WFBP step on a bucket
    axis wider than 1 (a ``(L, J, 1)`` plane runs the monolithic step)."""
    bb = trace.get("bucket_bytes")
    return bb is not None and int(bb.shape[-1]) > 1


def _trace_consts(trace: Dict[str, torch.Tensor], cfg: FluidSimConfig, inv_dt: float):
    """Per-trace constants the reference derives inside its step:
    contention-free comm seconds of a whole iteration (under WFBP the sum
    over live buckets, each paying the latency ``a``) and of each bucket,
    GPU counts as float, the ticks of one compute segment, the job index
    and, where the step needs the overlap plane, ``~eye(J)``.  Built once
    per batch shape, as a CUDA graph reads them by address."""
    n_jobs = trace["arrival"].shape[1]
    dev = trace["arrival"].device
    out = {
        "n_gpus_f": trace["n_gpus"].to(_F32),
        "k_iter": torch.clamp(_ticks_to_zero(trace["t_iter"], inv_dt), min=1),
        "job_index": torch.arange(n_jobs, device=dev),
        "wfbp": _is_wfbp(trace),
    }
    if out["wfbp"]:
        bucket_t = trace["bucket_bytes"] * cfg.b + cfg.a  # (L, J, B)
        b_max = int(bucket_t.shape[-1])
        live = torch.arange(b_max, device=dev) < trace["n_buckets"][..., None]
        out["bucket_t"] = bucket_t
        out["comm_total"] = torch.where(live, bucket_t, torch.zeros((), device=dev)).sum(-1)
    else:
        out["comm_total"] = trace["msg_bytes"] * cfg.b + cfg.a
    if out["wfbp"] or netmodel.parse_policy(cfg.policy).exact_lookahead:
        out["not_eye"] = ~torch.eye(n_jobs, dtype=torch.bool, device=dev)
    return out


def _place(free, free_total, want, rank_key, k: _Statics):
    """Gang placement for every lane: fill servers in ascending
    ``rank_key`` order (ties by server index).  ``free``/``rank_key`` are ``(L, S)``, ``free_total``
    ``(L, 1)``, ``want`` ``(L, 1)``.  Returns per-server takes ``(L, S)``
    and the feasible flag ``(L, 1)``; small integers, exact in float32."""
    key_u = rank_key[:, None, :]
    key_s = rank_key[:, :, None]
    before = (key_u < key_s) | ((key_u == key_s) & k.index_le)
    cum = (before * free[:, None, :]).sum(-1)
    take = torch.minimum(torch.clamp(want - (cum - free), min=0), free)
    feasible = free_total >= want
    return torch.where(feasible, take, k.zero), feasible


def _init_lane_state(trace: Dict[str, torch.Tensor], cfg: FluidSimConfig,
                     n_domains: int) -> Dict[str, torch.Tensor]:
    """Initial state of every lane (the reference's layout with a lane
    axis, and each job's current ``bucket`` under WFBP): padded jobs
    (``valid`` False) start DONE."""
    n_lanes, n_jobs = trace["arrival"].shape
    dev = trace["arrival"].device
    ns = cfg.n_servers
    valid = trace["valid"]
    return {
        "phase": torch.where(valid, QUEUED, DONE).to(_I32),
        "loads": torch.zeros((n_lanes, n_jobs, n_domains), dtype=torch.bool, device=dev),
        "iters_left": trace["iters"].clone(),
        "rem": torch.zeros((n_lanes, n_jobs), dtype=_F32, device=dev),
        "servers": torch.zeros((n_lanes, n_jobs, ns), dtype=_I32, device=dev),
        "finish": torch.full((n_lanes, n_jobs), float("inf"), dtype=_F32, device=dev),
        "free": torch.full((n_lanes, ns), float(cfg.gpus_per_server), dtype=_F32, device=dev),
        "t": torch.zeros((n_lanes,), dtype=_F32, device=dev),
        "n_done": torch.zeros((n_lanes,), dtype=_I32, device=dev),
        "i": torch.zeros((n_lanes,), dtype=_I32, device=dev),
        "started": torch.zeros((n_lanes, n_jobs), dtype=torch.bool, device=dev),
        **({"bucket": torch.zeros((n_lanes, n_jobs), dtype=_I32, device=dev)}
           if _is_wfbp(trace) else {}),
    }


def _lane_step(tr, c, st, k: _Statics, cfg: FluidSimConfig):
    """One tick of every lane: the reference's executed tick, then
    (``cfg.skip``) the bulk advance of the following eventless ticks.  Each
    line mirrors ``jaxsim._make_lane_step.step``."""
    dt = cfg.dt
    wfbp, exact = c["wfbp"], k.exact_kway
    i_new = st["i"] + 1
    # clock derived from the integer tick counter (no accumulated drift)
    t = i_new.to(_F32) * dt
    phase, rem, servers = st["phase"], st["rem"], st["servers"]
    n_gpus_f, comm_total = c["n_gpus_f"], c["comm_total"]

    spans0 = (servers > 0).sum(-1) > 1
    # SRSF key of running jobs: remaining iters x (compute + free comm) x GPUs
    rem_service = (
        st["iters_left"] * (tr["t_iter"] + torch.where(spans0, comm_total, k.zero)) * n_gpus_f
    )

    # ---- admission: smallest-SRSF arrived job that fits -------------------
    free_total = st["free"].sum(-1, keepdim=True)
    fits = n_gpus_f <= free_total
    queued = phase == QUEUED
    arrived = queued & (tr["arrival"] < t[:, None]) & fits
    # queued-job priority is compute-only (E_J = 0 before placement);
    # arrived implies queued, so one mask serves both of the reference's
    pick = torch.where(
        arrived, st["iters_left"] * tr["t_iter"] * n_gpus_f, k.inf
    ).argmin(-1, keepdim=True)
    can_pick = arrived.gather(-1, pick)
    load = rank_extra = None
    if k.placement == "least_loaded":
        # per-server remaining workload (Alg. 3's L_S in gang form)
        load = (rem_service[..., None] * servers).sum(-2)
    elif k.placement == "random":
        # a fresh uniform server order per lane and tick, keyed on the
        # lane's own tick counter (the skip advances it as the reference's)
        rank_extra = prng.uniform(prng.fold_in(k.place_key, st["i"]), (cfg.n_servers,))
    elif k.placement == "rack_pack":
        rank_extra = netmodel.rack_pack_rank(
            st["free"], k.server_rack, k.n_racks, cfg.gpus_per_server
        )
    rank_key = netmodel.placement_rank(
        k.placement, st["free"], load, k.server_index, rank_extra
    )
    take, feasible = _place(
        st["free"], free_total, n_gpus_f.gather(-1, pick), rank_key, k
    )
    admit = can_pick & feasible  # (L, 1)
    hot = (c["job_index"] == pick) & admit
    free = st["free"] - torch.where(admit, take, k.zero)
    servers = torch.where(hot[..., None], take.to(_I32)[:, None, :], servers)
    phase = torch.where(hot, k.compute, phase)
    rem = torch.where(hot, tr["t_iter"], rem)
    # incremental domain-load update of the admitted job's row: the
    # reference multiplies the {0,1} member row; the non-negative integer
    # takes give the same zero pattern, exactly
    row_loads = ((take @ k.inc_t) > 0) & ((take @ k.inc_out_t) > 0)
    loads = torch.where(hot[..., None], row_loads[:, None, :], st["loads"])
    member = servers > 0
    spans = member.sum(-1) > 1

    # ---- communication contention state ----------------------------------
    started = st["started"]
    in_comm = phase == COMM
    active = in_comm & started & (rem > 0)
    core = fluid_step_core(
        loads, member.to(_F32), active, rem, k.bw, k.oversub,
        b=cfg.b, eta=cfg.eta, need_overlap=wfbp or exact, impl=cfg.kernel,
    )
    overlap = core["overlap"]

    # ---- drain compute -----------------------------------------------------
    is_comp = phase == COMPUTE
    rem = torch.where(is_comp, rem - dt, rem)
    comp_done = is_comp & (rem <= 0)
    to_comm = comp_done & spans
    iter_done_direct = comp_done & ~spans

    # ---- comm gating -------------------------------------------------------
    # a waiting WFBP job's rem is its current bucket's cost: gating decides
    # per bucket
    new_cost = rem if wfbp else comm_total
    waiting = in_comm & ~started

    def may_start_vs(k_would, min_old_rem, olds):
        if exact:
            return netmodel.may_start_dynamic(
                k_would, new_cost, min_old_rem, k.max_ways, k.gated, cfg.dual_threshold,
                exact_kway_olds=olds, rem=rem, eta_over_b=k.eta_over_b,
            )
        return netmodel.may_start_dynamic(
            k_would, new_cost, min_old_rem, k.max_ways, k.gated, cfg.dual_threshold,
        )

    # round 1 against the base active set, on the core's outputs
    olds0 = overlap & active[:, None, :] if overlap is not None else None
    start_ok = waiting & may_start_vs(core["k_would"], core["min_old_rem"], olds0)
    if wfbp and cfg.gating == "fixedpoint":
        # the one-shot greedy closure in place of the four rounds
        accept = netmodel.gating_fixed_point(
            start_ok, rem_service, loads, core["counts"], overlap, active, rem,
            new_cost, k.max_ways, k.gated, cfg.dual_threshold,
            exact_kway=exact, eta_over_b=k.eta_over_b,
            not_eye=c["not_eye"], job_index=c["job_index"],
        )
        started = started | accept
        leftover = start_ok & ~accept
    else:
        # one start per tick, smallest remaining service first
        pick_c = torch.where(start_ok, rem_service, k.inf).argmin(-1, keepdim=True)
        start_now = (c["job_index"] == pick_c) & start_ok
        started = started | start_now
        leftover = start_ok & ~start_now
        if wfbp:
            # gating="rounds": three more rounds, each against the contention
            # state with the earlier rounds' starts, one start each
            for _ in range(3):
                active_now = in_comm & started & (rem > 0)
                counts_now = netmodel.domain_counts(loads, active_now)
                k_would = netmodel.domain_k(loads, counts_now, extra=1)
                olds_now = overlap & active_now[:, None, :]
                min_old_rem = torch.where(olds_now, rem[:, None, :], k.inf).amin(-1)
                ok = (in_comm & ~started) & may_start_vs(k_would, min_old_rem, olds_now)
                pick_c = torch.where(ok, rem_service, k.inf).argmin(-1, keepdim=True)
                started = started | ((c["job_index"] == pick_c) & ok)
            # the skip's guard: any waiter blocks bulk advancement
            leftover = in_comm & ~started

    # ---- drain comm at the slowest-member-scaled Eq. 5 rate ---------------
    ratio = core["ratio"]
    draining = in_comm & started
    rem = torch.where(draining, _sub_product(rem, k.dt, ratio), rem)
    comm_done = draining & (rem <= 0)

    # ---- iteration bookkeeping --------------------------------------------
    # WFBP bucket stream: a finished bucket with buckets left hands the next
    # one to gating afresh; only the last bucket ends the iteration
    if wfbp:
        next_b = st["bucket"] + 1
        more_buckets = comm_done & (next_b < tr["n_buckets"])
        iter_done = iter_done_direct | (comm_done & ~more_buckets)
    else:
        iter_done = iter_done_direct | comm_done
    iters_left = st["iters_left"] - iter_done.to(_F32)
    job_done = iter_done & (iters_left <= 0)
    next_compute = iter_done & ~job_done

    phase = torch.where(to_comm, k.comm, phase)
    if wfbp:
        bucket_t = c["bucket_t"]
        rem = torch.where(to_comm, bucket_t[..., 0], rem)
        bucket = torch.where(to_comm, k.zero_i, st["bucket"])
        last = bucket_t.shape[-1] - 1
        next_t = bucket_t.gather(-1, next_b.clamp(0, last).long()[..., None])[..., 0]
        rem = torch.where(more_buckets, next_t, rem)
        bucket = torch.where(more_buckets, next_b, bucket)
        started = started & ~(to_comm | iter_done | more_buckets)
    else:
        rem = torch.where(to_comm, comm_total, rem)
        started = started & ~(to_comm | iter_done)
    phase = torch.where(next_compute, k.compute, phase)
    rem = torch.where(next_compute, tr["t_iter"], rem)
    phase = torch.where(job_done, k.done, phase)
    finish = torch.where(job_done, t[:, None], st["finish"])
    free = free + (servers * job_done[..., None]).sum(-2)
    servers = torch.where(job_done[..., None], k.zero_i, servers)
    loads = loads & ~job_done[..., None]

    new_state = {
        "phase": phase,
        "loads": loads,
        "iters_left": iters_left,
        "rem": rem,
        "servers": servers,
        "finish": finish,
        "free": free,
        "t": t,
        "n_done": (phase == DONE).sum(-1, dtype=_I32),
        "i": i_new,
        "started": started,
    }
    if wfbp:
        new_state["bucket"] = bucket
    if not cfg.skip:
        return new_state

    # ---- next-event skip: bulk-advance provably eventless ticks -----------
    in_comm2 = phase == COMM
    is_comp2 = phase == COMPUTE
    active2 = in_comm2 & started & (rem > 0)
    waiting2 = (in_comm2 & ~started).any(-1)
    counts2 = netmodel.domain_counts(loads, active2)
    k_eff2 = netmodel.domain_k(loads, counts2.to(_F32) * k.oversub)
    ratio2 = (ratio / netmodel.rate_ratio(core["k_eff"], cfg.b, cfg.eta)) * netmodel.rate_ratio(
        k_eff2, cfg.b, cfg.eta
    )
    # gating must re-run next tick after a passing candidate was left, a
    # completion while transfers wait, a barrier or fresh bucket, and under
    # exact k-way (a cost comparison, not monotone in time) while any waits
    gate_block = leftover.any(-1) | (comm_done.any(-1) & waiting2) | to_comm.any(-1)
    if wfbp:
        gate_block = gate_block | more_buckets.any(-1)
    if exact:
        gate_block = gate_block | waiting2
    fits2 = n_gpus_f <= free.sum(-1, keepdim=True)
    cap_arr = torch.where(
        (phase == QUEUED) & fits2,
        _ticks_to_zero(tr["arrival"] - t[:, None], k.inv_dt) - 1,
        k.big_i,
    )
    k_cur = _ticks_to_zero(rem, k.inv_dt)
    # a computing job is not done this tick, so its spans flag is the
    # reference's post-release spans2
    ns_comp = is_comp2 & ~spans
    cap_comp = torch.where(
        is_comp2 & spans,
        k_cur - 1,
        torch.where(
            ns_comp, k_cur - 1 + c["k_iter"] * (iters_left.to(_I32) - 1), k.big_i
        ),
    )
    pos = ratio2 > 0
    cap_comm = torch.where(
        active2 & pos,
        _ticks_to_zero(rem / torch.where(pos, ratio2, k.one), k.inv_dt) - 1,
        k.big_i,
    )
    caps = torch.minimum(torch.minimum(cap_arr, cap_comp), cap_comm).amin(-1)
    extra = torch.clamp(torch.minimum(caps, cfg.max_steps - i_new), 0, _BIG_TICKS)
    extra = torch.where(gate_block, k.zero_i, extra)[:, None]
    nf = extra.to(_F32)
    # linear drains, plus whole-iteration jumps for non-spanning compute
    # jobs crossing >= 1 invisible iteration boundary
    cross = ns_comp & (extra >= k_cur) & (extra > 0)
    m = torch.clamp(extra - k_cur, min=0)
    aq = torch.div(m, c["k_iter"], rounding_mode="floor")
    rq = m - aq * c["k_iter"]
    new_state["rem"] = torch.where(
        cross,
        tr["t_iter"] - rq.to(_F32) * dt,
        torch.where(
            is_comp2,
            rem - nf * dt,
            torch.where(active2, _sub_product(rem, nf * dt, ratio2), rem),
        ),
    )
    new_state["iters_left"] = torch.where(cross, iters_left - (1 + aq).to(_F32), iters_left)
    new_state["i"] = i_new + extra[:, 0]
    new_state["t"] = new_state["i"].to(_F32) * dt
    return new_state


def _live_tick(tr, c, st, k: _Statics, cfg: FluidSimConfig, n_jobs: int):
    """One tick of every lane with the live freeze: a lane that has
    finished or hit the step cap keeps its state leaf by leaf (the
    reference's ``live`` select), so the batch can run past early
    finishers."""
    live = (st["n_done"] < n_jobs) & (st["i"] < cfg.max_steps)
    by_rank = (live, live[:, None], live[:, None, None])
    new = _lane_step(tr, c, st, k, cfg)
    return {name: torch.where(by_rank[v.dim() - 1], v, st[name]) for name, v in new.items()}


#: Ticks per block of a chunk (a divisor of the default ``chunk_steps``):
#: on the card one block is captured as a CUDA graph and replayed
#: ``chunk_steps / BLOCK_TICKS`` times per chunk.  Capture costs about one
#: eager tick per tick of the block plus instantiation, once per batch
#: shape, while replay costs the same per tick for blocks of 8, 16 and 32
#: ticks (PERF.md), so the smallest of them wins.
BLOCK_TICKS = 8


class _ChunkRunner:
    """A chunk of ``cfg.chunk_steps`` ticks over persistent trace and state
    buffers of one (lanes, jobs) shape, run as ``chunk_steps / block``
    blocks of ``block`` ticks; each block writes the new state back into
    the same buffers in place.  The port's counterpart of
    ``jaxsim._chunk_jit``.

    With ``graph`` (CUDA only) the first block runs eagerly on a side
    stream (it builds and loads the kernel library, warms the allocator
    and is the chunk's first block), then one block is captured as a CUDA
    graph, and every later block, in this chunk and the next ones, replays
    it.  The graph reads its inputs by address: the trace, the state, the
    per-trace constants and the statics all live as long as the runner.
    ``fluid_step_core_cuda.launches`` advances at capture, not at replay,
    so the runner takes back the launches the capture added and adds them
    once per replay.  A capture or replay that fails raises.
    """

    def __init__(self, trace, state, cfg: FluidSimConfig, k: _Statics, *,
                 block: int = BLOCK_TICKS, graph: bool = False) -> None:
        if block < 1 or cfg.chunk_steps % block:
            raise ValueError(f"block of {block} ticks does not divide chunk_steps "
                             f"{cfg.chunk_steps}")
        if graph and trace["arrival"].device.type != "cuda":
            raise ValueError("a CUDA graph needs the simulation on a CUDA device")
        self.trace, self.state, self.cfg, self.k = trace, state, cfg, k
        self.block, self.use_graph = block, graph
        self.c = _trace_consts(trace, cfg, k.inv_dt)
        self.n_jobs = int(trace["arrival"].shape[1])
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches_per_replay = 0
        #: seconds of the eager first block, of recording the captured
        #: block, and of ending the capture (graph instantiation)
        self.timing: Dict[str, float] = {}

    def _block(self) -> None:
        st = self.state
        for _ in range(self.block):
            st = _live_tick(self.trace, self.c, st, self.k, self.cfg, self.n_jobs)
        for name, v in st.items():
            self.state[name].copy_(v)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._block()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = fluid_step_core_cuda.launches
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._block()
            t2 = time.perf_counter()
        torch.cuda.synchronize()
        self.launches_per_replay = fluid_step_core_cuda.launches - before
        fluid_step_core_cuda.launches = before  # nothing ran at capture
        self.timing = {"warmup_s": t1 - t0, "capture_s": t2 - t1,
                       "instantiate_s": time.perf_counter() - t2}

    def run_chunk(self) -> Dict[str, torch.Tensor]:
        n_blocks = self.cfg.chunk_steps // self.block
        if not self.use_graph:
            for _ in range(n_blocks):
                self._block()
            return self.state
        if self.graph is None:
            self._capture()  # the eager warm-up block is this chunk's first
            n_blocks -= 1
        for _ in range(n_blocks):
            self.graph.replay()
            fluid_step_core_cuda.launches += self.launches_per_replay
        return self.state

    def release(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def _lane_chunk(trace, state, cfg: FluidSimConfig, statics: Optional[_Statics] = None,
                block: int = BLOCK_TICKS):
    """``cfg.chunk_steps`` ticks of every lane, run eagerly as blocks of
    ``block`` ticks over copies of ``state`` (left as it was); returns the
    new state."""
    k = statics if statics is not None else _Statics(cfg, trace["arrival"].device)
    state = {name: v.clone() for name, v in state.items()}
    return _ChunkRunner(trace, state, cfg, k, block=math.gcd(block, cfg.chunk_steps)).run_chunk()


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _drive_batched(traces: Dict[str, torch.Tensor], cfg: FluidSimConfig, *,
                   graph: Optional[bool] = None) -> Dict[str, object]:
    """Host driver: chunks with early exit and (``cfg.compact``)
    lane/job/bucket compaction, as the reference's ``_drive_batched``.
    Returns numpy result planes shaped like the input batch, the number of
    chunks, per batch shape the seconds its graph capture took
    (``captures``), and the bucket-axis width of each batch shape run
    (``bucket_widths``, empty for monolithic traces).

    ``graph`` is for the tests and chip_smoke.py: None (the default)
    replays each chunk's blocks from a CUDA graph on the card and runs them
    eagerly on the CPU; False runs them eagerly on the card too; True on
    the CPU raises."""
    device = traces["arrival"].device
    if graph is None:
        graph = device.type == "cuda"
    elif graph and device.type != "cuda":
        raise ValueError("graph=True needs the simulation on a CUDA device")
    n_lanes0, n_jobs0 = traces["arrival"].shape
    if "valid" not in traces:
        traces = dict(traces)
        traces["valid"] = torch.ones((n_lanes0, n_jobs0), dtype=torch.bool, device=device)
    results = {
        "jct": np.full((n_lanes0, n_jobs0), np.inf, np.float32),
        "finished": np.zeros((n_lanes0, n_jobs0), bool),
        "makespan": np.zeros((n_lanes0,), np.float32),
    }
    k = _Statics(cfg, device)
    block = math.gcd(BLOCK_TICKS, cfg.chunk_steps)
    orig = np.arange(n_lanes0)  # current lane -> original row (-1 = retired)
    state = _init_lane_state(traces, cfg, k.n_domains)
    runner = _ChunkRunner(traces, state, cfg, k, block=block, graph=graph)
    captures = []
    wfbp = _is_wfbp(traces)
    bucket_widths = [int(traces["bucket_bytes"].shape[-1])] if wfbp else []
    chunks = 0
    while True:
        fresh = runner.graph is None
        state = runner.run_chunk()
        if fresh and runner.timing:
            captures.append({"lanes": len(orig), "jobs": runner.n_jobs, **runner.timing})
        chunks += 1
        n_jobs_cur = int(traces["arrival"].shape[1])
        n_done, tick = torch.stack([state["n_done"], state["i"]]).cpu().numpy()
        done = (n_done >= n_jobs_cur) | (tick >= cfg.max_steps)
        newly = [l for l in np.nonzero(done)[0] if orig[l] >= 0]
        valid = traces["valid"].cpu().numpy()
        if newly:
            phase = state["phase"].cpu().numpy()
            finish = state["finish"].cpu().numpy()
            t_now = state["t"].cpu().numpy()
            arr = traces["arrival"].cpu().numpy()
            for l in newly:
                row = orig[l]
                fin = (phase[l] == DONE) & valid[l]
                results["jct"][row, :n_jobs_cur] = finish[l] - arr[l]
                results["finished"][row, :n_jobs_cur] = fin
                results["makespan"][row] = finish[l][fin].max() if fin.any() else t_now[l]
                orig[l] = -1
        if done.all():
            break
        if not (cfg.compact and done.any()):
            continue

        # ---- compaction: retire finished lanes, shrink the batch ---------
        # pow2 lanes and jobs in multiples of 8, as the reference buckets
        # them; dropped lanes are final and dropped job columns are
        # all-invalid across the surviving lanes.
        live = np.nonzero(~done)[0]
        n_live = len(live)
        lanes_new = _next_pow2(n_live)
        pad_lane = int(np.nonzero(done)[0][0])
        sel = np.concatenate([live, np.full(lanes_new - n_live, pad_lane, live.dtype)])
        col_used = valid[live].any(axis=0)
        jobs_need = int(np.nonzero(col_used)[0][-1]) + 1 if col_used.any() else 1
        jobs_new = min(n_jobs_cur, max(8, -(-jobs_need // 8) * 8))
        if lanes_new >= len(done) and jobs_new > 3 * n_jobs_cur // 4:
            continue
        sel_dev = torch.as_tensor(sel, device=device)
        traces = {
            name: v.index_select(0, sel_dev)[:, :jobs_new].contiguous()
            for name, v in traces.items()
        }
        state = {
            name: (
                v.index_select(0, sel_dev)[:, :jobs_new].contiguous()
                if name in _JOB_LEAVES else v.index_select(0, sel_dev)
            )
            for name, v in state.items()
        }
        state["n_done"] = (state["phase"] == DONE).sum(1, dtype=_I32)
        if wfbp:
            # keep >= 2 bucket columns: one would turn the WFBP step off
            b_need = max(2, int(traces["n_buckets"].max()))
            if b_need < traces["bucket_bytes"].shape[-1]:
                traces["bucket_bytes"] = traces["bucket_bytes"][..., :b_need].contiguous()
            bucket_widths.append(int(traces["bucket_bytes"].shape[-1]))
        orig = np.concatenate([orig[live], np.full(lanes_new - n_live, -1, orig.dtype)])
        # the new shape's buffers, and a new capture; the old graph and
        # its memory pool go
        runner.release()
        runner = _ChunkRunner(traces, state, cfg, k, block=block, graph=graph)
    runner.release()
    results["chunks"] = chunks
    results["captures"] = captures
    results["bucket_widths"] = bucket_widths
    return results


def simulate_traces_batched(traces: Dict[str, torch.Tensor], cfg: FluidSimConfig, *,
                            _graph: Optional[bool] = None):
    """Simulate a stacked batch of traces (leading axis = seed, see
    :func:`stack_traces`) on ``cfg.device``.  Returns numpy ``jct`` and
    ``finished`` ``(L, J)``, ``makespan`` ``(L,)``, the number of
    ``chunks`` the driver ran, the graph ``captures`` and the
    ``bucket_widths``.  On the card each chunk is replayed from a CUDA
    graph; ``_graph=False`` (for the tests and chip_smoke.py) runs it
    eagerly, see :func:`_drive_batched`."""
    device = resolve_device(cfg.device)
    traces = {name: torch.as_tensor(v).to(device) for name, v in traces.items()}
    return _drive_batched(traces, cfg, graph=_graph)


def simulate_trace(trace: Dict[str, torch.Tensor], cfg: FluidSimConfig):
    """Simulate one fixed workload (per-job ``(J,)`` planes)."""
    out = simulate_traces_batched({k: torch.as_tensor(v)[None] for k, v in trace.items()}, cfg)
    return {
        "jct": out["jct"][0],
        "finished": out["finished"][0],
        "makespan": out["makespan"][0],
        "chunks": out["chunks"],
    }


def trace_from_jobs(jobs, fusion: object = "all", device=None) -> Dict[str, torch.Tensor]:
    """``JobSpec`` list -> the struct-of-arrays trace the simulator
    consumes, on ``device`` (None = CUDA).  A ``fusion`` other than "all"
    adds the WFBP planes: ``bucket_bytes`` ``(J, B)`` (zero-padded) and
    ``n_buckets`` ``(J,)`` from :func:`netmodel.fusion_plan` over each
    model's layers; a model without layers is one bucket."""
    dev = resolve_device(device)
    tr = {
        "arrival": torch.tensor([j.arrival for j in jobs], dtype=_F32, device=dev),
        "iters": torch.tensor([j.iterations for j in jobs], dtype=_F32, device=dev),
        "t_iter": torch.tensor([j.model.t_iter_compute for j in jobs], dtype=_F32, device=dev),
        "msg_bytes": torch.tensor([j.model.size_bytes for j in jobs], dtype=_F32, device=dev),
        "n_gpus": torch.tensor([j.n_gpus for j in jobs], dtype=_I32, device=dev),
    }
    thr = netmodel.fusion_threshold(fusion)
    if thr == float("inf"):
        return tr
    plans = [
        netmodel.fusion_plan(j.model.layer_grad_bytes, j.model.layer_t_b, thr)[0]
        if j.model.has_layers else (j.model.size_bytes,)
        for j in jobs
    ]
    bb = np.zeros((len(plans), max(len(p) for p in plans)), np.float32)
    for i, plan in enumerate(plans):
        bb[i, : len(plan)] = plan
    tr["bucket_bytes"] = torch.from_numpy(bb).to(dev)
    tr["n_buckets"] = torch.tensor([len(p) for p in plans], dtype=_I32, device=dev)
    return tr


def stack_traces(traces: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack per-seed traces into one rectangular batch, padding ragged job
    counts with inert jobs masked out by a boolean ``valid`` plane.  WFBP
    planes are padded along the job and the bucket axis; when any lane
    carries them, lanes without get monolithic ones."""
    if not traces:
        raise ValueError("need at least one trace to stack")
    n_max = max(int(tr["arrival"].shape[0]) for tr in traces)
    has_buckets = any("bucket_bytes" in tr for tr in traces)
    b_max = max((int(tr["bucket_bytes"].shape[-1]) for tr in traces if "bucket_bytes" in tr),
                default=1)
    fills = {"arrival": 0.0, "iters": 1.0, "t_iter": 1.0, "msg_bytes": 0.0,
             "n_gpus": 1, "valid": False, "bucket_bytes": 0.0, "n_buckets": 1}
    out: Dict[str, List[torch.Tensor]] = {}
    for tr in traces:
        n = int(tr["arrival"].shape[0])
        dev = tr["arrival"].device
        lane = dict(tr)
        lane.setdefault("valid", torch.ones((n,), dtype=torch.bool, device=dev))
        if has_buckets and "bucket_bytes" not in lane:
            lane["bucket_bytes"] = lane["msg_bytes"][:, None]
            lane["n_buckets"] = torch.ones((n,), dtype=_I32, device=dev)
        for name, v in lane.items():
            if v.dim() == 2:  # (J, B): zero-fill both axes
                v = torch.nn.functional.pad(v, (0, b_max - v.shape[1], 0, n_max - n),
                                            value=fills[name])
            else:
                pad = torch.full((n_max - n,), fills[name], dtype=v.dtype, device=v.device)
                v = torch.cat([v, pad])
            out.setdefault(name, []).append(v)
    return {name: torch.stack(vs) for name, vs in out.items()}


def simulate_jobs(jobs, cfg: FluidSimConfig, fusion: object = "all") -> Dict[str, object]:
    """One fluid simulation of a fixed job list; numpy outputs."""
    out = simulate_trace(trace_from_jobs(jobs, fusion=fusion, device=resolve_device(cfg.device)), cfg)
    return {
        "jct": out["jct"],
        "finished": out["finished"],
        "makespan": float(out["makespan"]),
        "chunks": out["chunks"],
    }


def from_reference(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The reference's trace or lane-state dict, pulled to numpy, as the
    port's tensors on ``device`` (dtypes kept: bool, int32, float32)."""
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.array(v)).to(dev) for name, v in arrays.items()}


def to_numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_reference`."""
    return {name: v.detach().cpu().numpy() for name, v in tensors.items()}


def sample_trace(key, n_jobs: int, horizon: float = 1200.0, min_iters: int = 1000,
                 max_iters: int = 6000) -> Dict[str, torch.Tensor]:
    """The paper's workload as arrays, drawn from a threefry ``key``
    (batched keys give a leading lane axis), as the reference's
    ``sample_trace``: arrivals ``floor(U[1, horizon))``, iterations
    ``U{min_iters..max_iters}``, a Table III model per job and GPU counts by
    the paper's distribution; on the key's device."""
    key = prng.as_key(key)
    dev = key.device
    models = list(TABLE_III.values())
    t_iter = torch.tensor([m.t_iter_compute for m in models], dtype=_F32, device=dev)
    sizes = torch.tensor([m.size_bytes for m in models], dtype=_F32, device=dev)
    total = sum(c for _, c in PAPER_GPU_DISTRIBUTION)
    gpu_choices = torch.tensor([g for g, _ in PAPER_GPU_DISTRIBUTION], dtype=_I32, device=dev)
    probs = torch.tensor([c / total for _, c in PAPER_GPU_DISTRIBUTION], dtype=_F32, device=dev)
    keys = prng.split(key, 4)
    k1, k2, k3, k4 = (keys[..., i, :] for i in range(4))
    arrival = torch.floor(prng.uniform(k1, (n_jobs,), minval=1.0, maxval=horizon))
    iters = prng.randint(k2, (n_jobs,), min_iters, max_iters + 1)
    midx = prng.randint(k3, (n_jobs,), 0, len(models)).long()
    gidx = prng.choice(k4, gpu_choices, (n_jobs,), p=probs)
    return {
        "arrival": arrival,
        "iters": iters.to(_F32),
        "t_iter": t_iter[midx],
        "msg_bytes": sizes[midx],
        "n_gpus": gidx.to(_I32),
    }


def simulate_one(key, n_jobs: int, cfg: FluidSimConfig):
    """Simulate one sampled paper workload (:func:`sample_trace` of ``key``)."""
    dev = resolve_device(cfg.device)
    return simulate_trace(sample_trace(prng.as_key(key).to(dev), n_jobs), cfg)


def monte_carlo_jct(n_seeds: int = 16, n_jobs: int = 64, policy: str = "ada",
                    base_seed: int = 0, **cfg_kw) -> Dict[str, object]:
    """Mean and std of avg-JCT over ``n_seeds`` sampled paper workloads
    (keys ``split(PRNGKey(base_seed), n_seeds)``), all in one batch, as the
    reference's ``monte_carlo_jct``.  Also returns the sampled ``traces``
    (numpy) beside the reference's keys."""
    cfg = FluidSimConfig(policy=policy, **cfg_kw)
    dev = resolve_device(cfg.device)
    keys = prng.split(prng.PRNGKey(base_seed, dev), n_seeds)
    traces = sample_trace(keys, n_jobs)
    out = simulate_traces_batched(traces, cfg)
    jct, fin = out["jct"], out["finished"]
    avg = np.array([jct[i][fin[i]].mean() for i in range(n_seeds)])
    return {
        "avg_jct_mean": float(avg.mean()),
        "avg_jct_std": float(avg.std()),
        "per_seed": avg,
        "finished_frac": float(fin.mean()),
        "traces": to_numpy(traces),
    }
