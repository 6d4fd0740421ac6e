"""Incremental cluster-state indices for the dispatch path (port of
``repro/core/clusterindex.py``).

:class:`ClusterIndex` keeps per-GPU, per-server and per-rack workload
sums and per-server feasibility aggregates, updated in O(gang) per state
change and recomputed lazily *in the exact accumulation order of a full
rescan*, so the gangs the placement picks — and the whole event stream —
are the rescan's bit for bit.  It is the engine's one workload mode (the
reference's default); the reference's ``rescan`` oracle is not ported
(ROADMAP queue 1, item 7g).

Exact-float discipline: the index never maintains a sum by adding and
subtracting deltas.  It tracks, per GPU, the ordered list of resident live
jobs (append on place, remove on release) — the engine's ``_live``
insertion order restricted to that GPU — and re-folds a dirty GPU's
workload left to right over that list, the same numbers added in the same
order as the rescan.  Server loads fold GPU workloads in GPU-index order
(``Cluster.server_workload``), rack loads fold server loads in rack order.

* ``Cluster.place`` appends the new job's share to each chosen GPU
  (``+=``), which is the canonical fold: placements dirty only the
  server/rack sums above the GPU.
* A job's share changes only at iteration boundaries (``on_decay``), or,
  under ``bandwidth_aware_srsf``, conservatively at every refresh.
* ``Cluster.release`` does not touch workloads; the release dirties the
  gang's GPUs for the next ``refresh``.
* Server/rack sums and the feasibility aggregates (max free memory over
  the server's GPUs that are not down, and over its empty ones for
  exclusive mode) are flushed lazily on first read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.cluster import Cluster, GpuId

__all__ = ["ClusterIndex"]


class ClusterIndex:
    """Maintained per-GPU/server/rack workload and feasibility aggregates.

    Owned by the engine; the engine calls the ``on_*`` hooks from its
    place/release/decay/fault paths and
    dispatches ``refresh_workloads`` here.  The placement layer reads the
    aggregates through :meth:`server_loads` / :meth:`rack_loads` /
    :meth:`server_feas`.
    """

    def __init__(self, cluster: Cluster) -> None:
        self.cluster = cluster
        n = cluster.n_servers
        #: per-GPU ordered resident live jobs — ``_live`` order restricted
        #: to the GPU (append on place, remove on release)
        self._residents: Dict[GpuId, List[int]] = {gid: [] for gid in cluster.gpus}
        #: per-live-job workload share (remaining service), as of the last
        #: refresh (or placement, whichever is newer)
        self._share: Dict[int, float] = {}
        #: jobs whose share is stale (iteration completed since last refresh)
        self._decayed: Set[int] = set()
        #: GPUs whose ``workload`` must be re-folded at the next refresh
        self._dirty_gpus: Set[GpuId] = set()
        # lazily-flushed per-server load sums
        self._server_load: List[float] = [0.0] * n
        self._dirty_servers: Set[int] = set(range(n))
        # lazily-flushed per-rack load sums (registered on first lwf_rack use)
        self._racks: Optional[Tuple[Tuple[int, ...], ...]] = None
        self._rack_of: Dict[int, int] = {}
        self._rack_load: List[float] = []
        self._dirty_racks: Set[int] = set()
        # lazily-flushed per-server feasibility aggregates
        self._max_free: List[float] = [0.0] * n
        self._max_free_excl: List[float] = [0.0] * n
        self._feas_dirty: Set[int] = set(range(n))

    # -- engine hooks --------------------------------------------------------

    def on_place(self, job_id: int, gpu_ids: Sequence[GpuId], share: float) -> None:
        """A gang was committed via ``Cluster.place`` (share already added
        to each GPU's workload, at the end of its fold — see module doc)."""
        self._share[job_id] = share
        residents = self._residents
        servers = set()
        for gid in gpu_ids:
            residents[gid].append(job_id)
            servers.add(gid[0])
        self._mark_load(servers)
        self._feas_dirty.update(servers)

    def on_release(self, job_id: int, gpu_ids: Sequence[GpuId]) -> None:
        """A gang was torn down (finish, preemption, resize, cancellation):
        drop the job from the resident lists and dirty its GPUs for the refresh the
        engine always performs before the next placement."""
        self._share.pop(job_id, None)
        self._decayed.discard(job_id)
        residents = self._residents
        servers = set()
        for gid in gpu_ids:
            try:
                residents[gid].remove(job_id)
            except ValueError:
                pass
            self._dirty_gpus.add(gid)
            servers.add(gid[0])
        self._mark_load(servers)
        self._feas_dirty.update(servers)

    def on_decay(self, job_id: int) -> None:
        """An iteration completed: the job's remaining-service share is
        stale until the next refresh."""
        if job_id in self._share:
            self._decayed.add(job_id)

    def on_server_capacity(self, server: int) -> None:
        """A server went down or came back (fault injection): only placement
        feasibility changes; the preemptions' releases handle workloads."""
        self._feas_dirty.add(server)

    # -- refresh (the refresh_workloads replacement) -------------------------

    def refresh(self, runs: Dict[int, object], params, bandwidth_aware: bool) -> None:
        """Bring every GPU workload up to date in O(decayed gangs), not
        O(live jobs x gang): re-derive stale shares, then re-fold only the
        dirty GPUs in canonical order."""
        share = self._share
        dirty = self._dirty_gpus
        if bandwidth_aware:
            # shares read the per-server bandwidth map: conservatively
            # re-derive every live share, as the reference does
            stale = list(share)
        else:
            stale = self._decayed
        for jid in stale:
            run = runs.get(jid)
            if run is None:
                continue
            new = run.remaining_service(params, bandwidth_aware)
            if new != share[jid]:
                share[jid] = new
                dirty.update(run.gpus)
        self._decayed.clear()
        if dirty:
            gpus = self.cluster.gpus
            residents = self._residents
            servers = set()
            for gid in dirty:
                total = 0.0
                for jid in residents[gid]:
                    total += share[jid]
                gpus[gid].workload = total
                servers.add(gid[0])
            dirty.clear()
            self._mark_load(servers)

    # -- aggregate accessors (placement fast path) ---------------------------

    def server_loads(self) -> List[float]:
        """Per-server workload sums — value-identical to
        ``[cluster.server_workload(s) for s in range(n_servers)]``."""
        if self._dirty_servers:
            sw = self.cluster.server_workload
            load = self._server_load
            for s in self._dirty_servers:
                load[s] = sw(s)
            self._dirty_servers.clear()
        return self._server_load

    def rack_loads(self, racks: Sequence[Sequence[int]]) -> List[float]:
        """Per-rack workload sums for the given rack grouping —
        value-identical to ``[sum(load[s] for s in rack) for rack in racks]``."""
        if self._racks is None or racks != self._racks:
            self._set_racks(racks)
        load = self.server_loads()  # flush servers before racks
        if self._dirty_racks:
            rl = self._rack_load
            rk = self._racks
            for r in self._dirty_racks:
                rl[r] = sum(load[s] for s in rk[r])
            self._dirty_racks.clear()
        return self._rack_load

    def server_feas(self, server: int) -> Tuple[float, float]:
        """(max free MB over the server's GPUs that are not down, same over
        its *empty* ones).  ``-1.0`` when no GPU qualifies, so ``feas < mem_mb`` is an
        exact whole-server skip for any job profile."""
        if server in self._feas_dirty:
            mf = -1.0
            mfe = -1.0
            for g in self.cluster.gpus_of_server(server):
                if g.down:
                    continue
                free = g.mem_capacity_mb - g.mem_used_mb
                if free > mf:
                    mf = free
                if free > mfe and not g.resident_jobs:
                    mfe = free
            self._max_free[server] = mf
            self._max_free_excl[server] = mfe
            self._feas_dirty.discard(server)
        return self._max_free[server], self._max_free_excl[server]

    # -- internals -----------------------------------------------------------

    def _mark_load(self, servers: Set[int]) -> None:
        self._dirty_servers.update(servers)
        if self._racks is not None:
            rack_of = self._rack_of
            dirty = self._dirty_racks
            for s in servers:
                r = rack_of.get(s)
                if r is not None:
                    dirty.add(r)

    def _set_racks(self, racks: Sequence[Sequence[int]]) -> None:
        self._racks = tuple(tuple(r) for r in racks)
        self._rack_of = {s: ri for ri, rack in enumerate(self._racks) for s in rack}
        self._rack_load = [0.0] * len(self._racks)
        self._dirty_racks = set(range(len(self._racks)))

    # -- verification (property tests) ---------------------------------------

    def assert_consistent(self, engine) -> None:
        """Differential oracle: every maintained aggregate must equal the
        from-scratch rescan recomputation with EXACT float equality (same
        accumulation order).  Valid right after a refresh (between a decay
        and its refresh the GPU values are intentionally stale — exactly
        as they would be under the rescan, which also only rebuilds inside
        ``refresh_workloads``)."""
        cluster = self.cluster
        expect: Dict[GpuId, float] = {gid: 0.0 for gid in cluster.gpus}
        for jid in engine._live:
            run = engine._runs[jid]
            share = run.remaining_service(engine.params, engine.bandwidth_aware_srsf)
            for gid in run.gpus:
                expect[gid] += share
        for gid, want in expect.items():
            got = cluster.gpus[gid].workload
            assert got == want, f"GPU {gid}: workload {got!r} != rescan {want!r}"
        loads = self.server_loads()
        for s in range(cluster.n_servers):
            want = cluster.server_workload(s)
            assert loads[s] == want, f"server {s}: load {loads[s]!r} != {want!r}"
        if self._racks is not None:
            rl = self.rack_loads(self._racks)
            for ri, rack in enumerate(self._racks):
                want = sum(loads[s] for s in rack)
                assert rl[ri] == want, f"rack {ri}: load {rl[ri]!r} != {want!r}"
        for s in range(cluster.n_servers):
            mf, mfe = self.server_feas(s)
            want_mf = -1.0
            want_mfe = -1.0
            for g in cluster.gpus_of_server(s):
                if g.down:
                    continue
                free = g.mem_free_mb()
                want_mf = max(want_mf, free)
                if not g.resident_jobs:
                    want_mfe = max(want_mfe, free)
            assert mf == want_mf and mfe == want_mfe, (
                f"server {s}: feas ({mf}, {mfe}) != ({want_mf}, {want_mfe})"
            )
        # resident lists == _live order restricted to each GPU
        for gid, lst in self._residents.items():
            want_lst = [
                jid for jid in engine._live if gid in engine._runs[jid].gpus
            ]
            assert lst == want_lst, f"GPU {gid}: residents {lst} != {want_lst}"
