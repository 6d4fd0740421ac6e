"""The plain reference of the fluid simulator: the tick semantics of the
contention-aware cluster simulation, written once more in NumPy over a
few lanes, with no compaction, no graph and no kernel.

One tick of every live lane does, in this order: admission of the
smallest-SRSF arrived job that fits (gang placement on the servers with
the most free GPUs, ties by server index), the contention state
(in-flight transfers per server NIC, the k of the most loaded NIC a
transfer crosses, the Eq. (5) drain ratio; every NIC at nominal
bandwidth), the compute drain,
AdaDUAL gating of waiting transfers (one start per tick, smallest
remaining service first), the comm drain, the iteration bookkeeping,
and the next-event skip, which advances every tick in which provably
nothing happens at once.  Every float is float32; the comm drains round
once from a float64 product, as the simulator states.

``prec="bf16_state"`` is the control: the same ticks with the clock, the
remaining costs and the trace's compute and comm seconds rounded to
bfloat16 wherever they are stored, the cut a port that halves its
state's bytes would make (the iteration counters stay exact: rounded,
they would stop counting down).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

QUEUED, COMPUTE, COMM, DONE = 0, 1, 2, 3
_F32, _I32 = np.float32, np.int32
_BIG_TICKS = 1 << 30
_TICK_MARGIN = 0.01
_INF = _F32(np.inf)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), kept as float32."""
    x = np.ascontiguousarray(x, _F32)
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(_F32)
    return np.where(np.isfinite(x), out, x)


def _ticks_to_zero(x: np.ndarray, inv_dt: float) -> np.ndarray:
    """A safe underestimate of ``ceil(x / dt)``."""
    return np.floor(x * inv_dt - _TICK_MARGIN).astype(_I32) + 1


def _sub_product(x, a, b):
    """``x - a * b`` rounded once to float32 from float64."""
    a = a.astype(np.float64) if isinstance(a, np.ndarray) else a
    return (x.astype(np.float64) - a * b.astype(np.float64)).astype(_F32)


def _rate_ratio(k, b32, eta):
    return b32 / (k * b32 + (k - 1) * _F32(eta))


def _domain_k(loads, w):
    """max of ``w`` over the domains each job loads, at least 1 (``loads``
    is (L, D, J): domains before jobs)."""
    return np.maximum((loads * w[:, :, None]).max(1), w.dtype.type(1))


def _domain_counts(loads, mask):
    """Jobs of ``mask`` (L, J) in each domain: (L, D) int32."""
    return (loads & mask[:, None, :]).sum(-1, dtype=_I32)


def simulate(cfg: dict, tr: Dict[str, np.ndarray], policy: str = "ada",
             placement: str = "lwf", prec: str = "f32") -> Dict[str, np.ndarray]:
    """Run lanes ``tr`` (stacked planes of :func:`jobs.stack`) to the end.
    Returns ``jct`` and ``finished`` ``(L, J)``, ``makespan`` ``(L,)`` and
    ``ticks`` ``(L,)`` (executed ticks until each lane froze)."""
    if policy != "ada" or placement != "lwf":
        raise ValueError(f"the reference runs ada under lwf, got {policy}/{placement}")
    if prec not in ("f32", "bf16_state"):
        raise ValueError(f"unknown precision {prec!r}")
    rnd = bf16 if prec == "bf16_state" else (lambda x: x)
    L, J = tr["arrival"].shape
    S, G = cfg["n_servers"], cfg["gpus_per_server"]
    dt = cfg["dt"]
    dt32 = float(_F32(dt))
    inv_dt = float(_F32(1.0 / dt))
    b, a, eta, max_steps = cfg["b"], cfg["a"], cfg["eta"], cfg["max_steps"]
    b32 = _F32(b)
    dual = _F32(b / (2.0 * (b + eta)))
    # one contention domain per server NIC: a ring loads a NIC when it
    # holds GPUs on that server and on another
    inc = np.eye(S, dtype=_F32)
    inc_t, inc_out_t = inc.T.copy(), (1.0 - inc).T.copy()
    D = S
    idx = np.arange(S)
    index_le = idx[None, :] <= idx[:, None]  # [s, u]: u <= s
    job_index = np.arange(J)

    arrival, t_iter = tr["arrival"], rnd(tr["t_iter"])
    n_gpus_f = tr["n_gpus"].astype(_F32)
    k_iter = np.maximum(_ticks_to_zero(t_iter, inv_dt), 1)
    comm_total = rnd(tr["msg_bytes"] * b32 + _F32(a))

    phase = np.full((L, J), QUEUED, _I32)
    loads = np.zeros((L, D, J), bool)  # domains each job's ring crosses
    iters_left = tr["iters"].copy()
    rem = np.zeros((L, J), _F32)
    servers = np.zeros((L, S, J), _I32)  # GPUs each job holds on each server
    finish = np.full((L, J), np.inf, _F32)
    free = np.full((L, S), G, _F32)
    n_done = np.zeros(L, _I32)
    i = np.zeros(L, _I32)
    started = np.zeros((L, J), bool)
    res = {"jct": np.full((L, J), np.inf, _F32), "finished": np.zeros((L, J), bool),
           "makespan": np.zeros(L, _F32), "ticks": np.zeros(L, np.int64)}
    lanes = np.arange(L)  # original lane of each row still running
    ticks = 0

    while len(lanes):
        ticks += 1
        # ---- admission -----------------------------------------------------
        i_new = i + 1
        t_n = rnd(i_new.astype(_F32) * dt)
        spans0 = (servers > 0).sum(1) > 1
        rem_service = iters_left * (t_iter + np.where(spans0, comm_total, _F32(0))) * n_gpus_f
        free_total = free.sum(-1, keepdims=True)
        fits = n_gpus_f <= free_total
        queued = phase == QUEUED
        arrived = queued & (arrival < t_n[:, None]) & fits
        rows = np.arange(len(lanes))[:, None]
        free_n, servers_n, phase_n, rem_n, loads_n = free, servers, phase, rem, loads
        if arrived.any():  # else no lane admits and every leaf stays
            pick = np.where(arrived, iters_left * t_iter * n_gpus_f, _INF).argmin(-1)[:, None]
            can_pick = arrived[rows, pick]
            want = n_gpus_f[rows, pick]
            key = -free
            before = (key[:, None, :] < key[:, :, None]) | (
                (key[:, None, :] == key[:, :, None]) & index_le)
            cum = (before * free[:, None, :]).sum(-1, dtype=_F32)
            take = np.minimum(np.maximum(want - (cum - free), _F32(0)), free)
            feasible = free_total >= want
            take = np.where(feasible, take, _F32(0))
            admit = can_pick & feasible
            hot = (job_index == pick) & admit
            free_n = free - np.where(admit, take, _F32(0))
            servers_n = np.where(hot[:, None, :], take.astype(_I32)[:, :, None], servers)
            phase_n = np.where(hot, COMPUTE, phase).astype(_I32)
            rem_n = np.where(hot, t_iter, rem)
            row_loads = ((take @ inc_t) > 0) & ((take @ inc_out_t) > 0)
            loads_n = np.where(hot[:, None, :], row_loads[:, :, None], loads)
        spans = (servers_n > 0).sum(1) > 1

        # ---- contention state ----------------------------------------------
        in_comm = phase_n == COMM
        active = in_comm & started & (rem_n > 0)
        counts = _domain_counts(loads_n, active)
        k_eff = _domain_k(loads_n, counts.astype(_F32))
        # every NIC at nominal bandwidth: the slowest member's scale is 1
        ratio = _rate_ratio(k_eff, b32, eta)
        k_would = _domain_k(loads_n, counts + 1)
        dmin = np.where(loads_n & active[:, None, :], rem_n[:, None, :], _INF).min(-1)
        min_old_rem = np.where(loads_n, dmin[:, :, None], _INF).min(1)

        # ---- compute drain -------------------------------------------------
        is_comp = phase_n == COMPUTE
        rem_n = np.where(is_comp, rem_n - dt, rem_n)
        comp_done = is_comp & (rem_n <= 0)
        to_comm = comp_done & spans
        iter_done_direct = comp_done & ~spans

        # ---- AdaDUAL gating ------------------------------------------------
        waiting = in_comm & ~started
        start_ok = waiting & ((k_would <= 1) | ((k_would <= 2) & (comm_total < dual * min_old_rem)))
        started_n, leftover = started, np.zeros_like(started)
        if start_ok.any():  # else nothing starts and nothing is left over
            pick_c = np.where(start_ok, rem_service, _INF).argmin(-1)[:, None]
            start_now = (job_index == pick_c) & start_ok
            started_n = started | start_now
            leftover = start_ok & ~start_now

        # ---- comm drain ----------------------------------------------------
        draining = in_comm & started_n
        rem_n = np.where(draining, _sub_product(rem_n, dt32, ratio), rem_n)
        comm_done = draining & (rem_n <= 0)

        # ---- iteration bookkeeping -----------------------------------------
        iter_done = iter_done_direct | comm_done
        iters_n = iters_left - iter_done.astype(_F32)
        job_done = iter_done & (iters_n <= 0)
        next_compute = iter_done & ~job_done
        phase_n = np.where(to_comm, COMM, phase_n).astype(_I32)
        rem_n = np.where(to_comm, comm_total, rem_n)
        started_n = started_n & ~(to_comm | iter_done)
        phase_n = np.where(next_compute, COMPUTE, phase_n).astype(_I32)
        rem_n = np.where(next_compute, t_iter, rem_n)
        phase_n = np.where(job_done, DONE, phase_n).astype(_I32)
        finish_n = np.where(job_done, t_n[:, None], finish)
        free_n = free_n + (servers_n * job_done[:, None, :]).sum(-1).astype(_F32)
        servers_n = np.where(job_done[:, None, :], 0, servers_n).astype(_I32)
        loads_n = loads_n & ~job_done[:, None, :]
        n_done_n = (phase_n == DONE).sum(-1, dtype=_I32)

        # ---- next-event skip -----------------------------------------------
        in_comm2 = phase_n == COMM
        is_comp2 = phase_n == COMPUTE
        active2 = in_comm2 & started_n & (rem_n > 0)
        waiting2 = (in_comm2 & ~started_n).any(-1)
        gate_block = leftover.any(-1) | (comm_done.any(-1) & waiting2) | to_comm.any(-1)
        i_n = i_new
        if not gate_block.all():  # else no lane advances past this tick
            counts2s = _domain_counts(loads_n, active2)
            k_eff2 = _domain_k(loads_n, counts2s.astype(_F32))
            ratio2 = (ratio / _rate_ratio(k_eff, b32, eta)) * _rate_ratio(k_eff2, b32, eta)
            fits2 = n_gpus_f <= free_n.sum(-1, keepdims=True)
            cap_arr = np.where((phase_n == QUEUED) & fits2,
                               _ticks_to_zero(arrival - t_n[:, None], inv_dt) - 1, _BIG_TICKS)
            k_cur = _ticks_to_zero(rem_n, inv_dt)
            ns_comp = is_comp2 & ~spans
            cap_comp = np.where(
                is_comp2 & spans, k_cur - 1,
                np.where(ns_comp, k_cur - 1 + k_iter * (iters_n.astype(_I32) - 1), _BIG_TICKS))
            pos = ratio2 > 0
            cap_comm = np.where(
                active2 & pos,
                _ticks_to_zero(rem_n / np.where(pos, ratio2, _F32(1)), inv_dt) - 1, _BIG_TICKS)
            caps = np.minimum(np.minimum(cap_arr, cap_comp), cap_comm).min(-1)
            extra = np.clip(np.minimum(caps, max_steps - i_new), 0, _BIG_TICKS)
            extra = np.where(gate_block, 0, extra).astype(_I32)[:, None]
            nf = extra.astype(_F32)
            cross = ns_comp & (extra >= k_cur) & (extra > 0)
            m = np.maximum(extra - k_cur, 0)
            aq = m // k_iter
            rq = m - aq * k_iter
            rem_n = np.where(
                cross, t_iter - rq.astype(_F32) * dt,
                np.where(is_comp2, rem_n - nf * dt,
                         np.where(active2, _sub_product(rem_n, nf * dt, ratio2), rem_n)))
            iters_n = np.where(cross, iters_n - (1 + aq).astype(_F32), iters_n)
            i_n = (i_new + extra[:, 0]).astype(_I32)
            t_n = rnd(i_n.astype(_F32) * dt)

        (phase, loads, iters_left, rem, servers, finish, free, n_done, i, started) = (
            phase_n, loads_n, iters_n, rnd(rem_n), servers_n, finish_n, free_n, n_done_n, i_n,
            started_n)

        # ---- lanes that have ended leave the batch -------------------------
        done = (n_done >= J) | (i >= max_steps)
        if done.any():
            for row in np.nonzero(done)[0]:
                lane, fin = lanes[row], phase[row] == DONE
                res["jct"][lane] = finish[row] - arrival[row]
                res["finished"][lane] = fin
                res["makespan"][lane] = finish[row][fin].max() if fin.any() else t_n[row]
                res["ticks"][lane] = ticks
            keep = ~done
            lanes = lanes[keep]
            (phase, loads, iters_left, rem, servers, finish, free, n_done, i, started,
             arrival, t_iter, n_gpus_f, k_iter, comm_total) = (
                x[keep] for x in (phase, loads, iters_left, rem, servers, finish, free, n_done,
                                  i, started, arrival, t_iter, n_gpus_f, k_iter, comm_total))
    return res
