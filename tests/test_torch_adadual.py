"""The port's scalar decision layer against the reference's, on seeded
random inputs: AdaDUAL (``core/adadual.py``), the scalar gating predicate
and drain rate of ``core/netmodel.py``, the contention model's scalar
methods, the cluster and job helpers the engine reads, the topology's
loaded domains, and every placement policy on random cluster states (with
and without the maintained workload index).  Bar: bools equal, floats
``==``, GPU lists equal."""

import math
import random

import numpy as np
import pytest

from repro.core import adadual as radd
from repro.core import cluster as rcl
from repro.core import contention as rcon
from repro.core import netmodel as rnet
from repro.core import placement as rpl
from repro.core import topology as rtopo
from repro.core.clusterindex import ClusterIndex as RIndex
from repro_torch.core import adadual as padd
from repro_torch.core import cluster as pcl
from repro_torch.core import contention as pcon
from repro_torch.core import netmodel as pnet
from repro_torch.core import placement as ppl
from repro_torch.core import topology as ptopo
from repro_torch.core.clusterindex import ClusterIndex as PIndex


def _params(rng, mod):
    b = float(rng.uniform(1e-10, 2e-9))
    return mod.ContentionParams(a=float(rng.uniform(0, 1e-3)), b=b,
                                eta=float(rng.choice([0.0, rng.uniform(0, 2) * b])))


def _sizes(rng, n):
    """Byte counts over many magnitudes, with ties."""
    out = list(10.0 ** rng.uniform(3, 9, n))
    if n > 1 and rng.random() < 0.3:
        out[1] = out[0]
    return [float(x) for x in out]


@pytest.mark.parametrize("seed", range(6))
class TestAdaDual:
    def test_closed_forms(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(50):
            rp, pp = _params(np.random.default_rng(seed), rcon), _params(
                np.random.default_rng(seed), pcon)
            m1, m2 = sorted(_sizes(rng, 2))
            t = float(rng.uniform(0, rp.b * m2))
            assert padd.candidate_minima(m1, m2, pp) == radd.candidate_minima(m1, m2, rp)
            for fn in ("c1_average_completion", "c2a_average_completion",
                       "c2b_average_completion"):
                assert getattr(padd, fn)(t, m1, m2, pp) == getattr(radd, fn)(t, m1, m2, rp)

    def test_should_start(self, seed):
        rng = np.random.default_rng(100 + seed)
        rp, pp = _params(np.random.default_rng(seed), rcon), _params(
            np.random.default_rng(seed), pcon)
        for _ in range(300):
            k = int(rng.integers(0, 5))
            olds = _sizes(rng, k)
            new = _sizes(rng, 1)[0]
            mc = int(rng.integers(0, 4))
            assert padd.adadual_should_start(new, olds, mc, pp) == \
                radd.adadual_should_start(new, olds, mc, rp)
            n = int(rng.integers(1, 4))
            assert padd.srsf_n_should_start(mc, n) == radd.srsf_n_should_start(mc, n)
            ways = int(rng.integers(2, 5))
            assert padd.kway_adadual_should_start(new, olds, pp, max_ways=ways) == \
                radd.kway_adadual_should_start(new, olds, rp, max_ways=ways)
            if olds:
                assert padd.kway_lookahead_costs(new, olds, pp) == \
                    radd.kway_lookahead_costs(new, olds, rp)

    def test_integrator(self, seed):
        rng = np.random.default_rng(200 + seed)
        rp, pp = _params(np.random.default_rng(seed), rcon), _params(
            np.random.default_rng(seed), pcon)
        for _ in range(40):
            n = int(rng.integers(1, 7))
            starts = [float(x) for x in rng.uniform(0, 1.0, n)]
            if rng.random() < 0.3:
                starts = [0.0] * n
            sizes = _sizes(rng, n)
            assert padd.simulate_task_set(starts, sizes, pp) == \
                radd.simulate_task_set(starts, sizes, rp)
            t2 = float(rng.uniform(0, 0.5))
            assert padd.simulate_two_tasks(t2, sizes[0], sizes[-1], pp) == \
                radd.simulate_two_tasks(t2, sizes[0], sizes[-1], rp)


@pytest.mark.parametrize("seed", range(4))
def test_may_start_and_rate(seed):
    rng = np.random.default_rng(300 + seed)
    for _ in range(400):
        k = int(rng.integers(0, 6))
        new = float(10.0 ** rng.uniform(3, 9))
        old = float(rng.choice([math.inf, 0.0, 10.0 ** rng.uniform(3, 9)]))
        kw = dict(max_ways=int(rng.integers(1, 5)), threshold_gated=bool(rng.random() < 0.5),
                  dual_threshold=float(rng.uniform(0.1, 0.5)))
        assert pnet.may_start(k, new, old, **kw) == rnet.may_start(k, new, old, **kw)
        kf = float(rng.choice([1.0, 2.0, rng.uniform(1, 12)]))
        b, eta = float(rng.uniform(1e-10, 2e-9)), float(rng.uniform(0, 1e-9))
        assert pnet.rate(kf, b, eta) == rnet.rate(kf, b, eta)


def test_contention_params():
    rng = np.random.default_rng(7)
    for name in ("TPU_DCN_A", "TPU_DCN_B", "TPU_DCN_ETA", "PAPER_A", "PAPER_B", "DEFAULT_ETA"):
        assert getattr(pcon, name) == getattr(rcon, name), name
    assert pcon.ALLREDUCE_ALGORITHMS == rcon.ALLREDUCE_ALGORITHMS
    for _ in range(50):
        bw = tuple(float(x) for x in rng.uniform(0.3, 2.0, int(rng.integers(0, 6))))
        p = pcon.ContentionParams(server_bandwidth=bw)
        r = rcon.ContentionParams(server_bandwidth=bw)
        k = float(rng.uniform(1, 9))
        assert p.rate(k) == r.rate(k) and p.seconds_per_byte(k) == r.seconds_per_byte(k)
        m = float(10.0 ** rng.uniform(3, 9))
        ki = int(rng.integers(1, 5))
        assert p.allreduce_time(m, ki) == r.allreduce_time(m, ki)
        servers = {int(s) for s in rng.integers(0, 8, int(rng.integers(1, 4)))}
        assert p.bandwidth_scale(servers) == r.bandwidth_scale(servers)
        for alg in pcon.ALLREDUCE_ALGORITHMS:
            n = int(rng.integers(1, 65))
            args = (n, float(rng.uniform(0, 1e-4)), float(rng.uniform(0, 1e-9)),
                    float(rng.uniform(0, 1e-10)))
            assert pcon.allreduce_cost_terms(alg, *args) == rcon.allreduce_cost_terms(alg, *args)
    for mod in (pcon, rcon):
        with pytest.raises(ValueError):
            mod.allreduce_cost_terms("tree", 4, 1.0, 1.0, 1.0)
        with pytest.raises(ValueError):
            mod.ContentionParams().rate(0.5)


def test_job_helpers():
    rng = random.Random(3)
    for _ in range(50):
        prof = rng.choice(list(pcl.TABLE_III))
        n, it = rng.choice([1, 2, 4, 8]), rng.randint(1, 5000)
        pj = pcl.JobSpec(0, 0.0, n, it, pcl.TABLE_III[prof])
        rj = rcl.JobSpec(0, 0.0, n, it, rcl.TABLE_III[prof])
        assert pj.gpu_bounds == rj.gpu_bounds and pj.total_samples == rj.total_samples
        assert pj.compute_time == rj.compute_time
        a, b, hint = rng.uniform(0, 1e-3), rng.uniform(1e-10, 1e-9), rng.randint(1, 4)
        assert pj.comm_time(hint, a, b) == rj.comm_time(hint, a, b)
        assert pj.initial_workload(hint, a, b) == rj.initial_workload(hint, a, b)


@pytest.mark.parametrize("topo", ["nic", "two_tier", "uplink_only"])
def test_loaded_domains(topo):
    build = {"nic": lambda m: m.nic_topology(12), "two_tier": lambda m: m.two_tier(12, 4, 3.0),
             "uplink_only": lambda m: m.uplink_only(12, 3, 2.0)}[topo]
    pt, rt = build(ptopo), build(rtopo)
    rng = random.Random(5)
    for _ in range(200):
        servers = set(rng.sample(range(12), rng.randint(1, 6)))
        got = pt.loaded_domains(servers)
        assert got == rt.loaded_domains(servers)
        assert [pt.oversub_of(d) for d in sorted(got)] == [rt.oversub_of(d) for d in sorted(got)]


def _random_state(seed, exclusive):
    """The same random cluster state on both sides: jobs placed with random
    memory and workload shares, some released, the index told of each."""
    rng = random.Random(seed)
    n_servers, gps = rng.choice([(4, 4), (8, 4), (6, 2), (16, 4)])
    mem = rng.choice([16160.0, 32000.0])
    sides = []
    for cl, idx in ((pcl, PIndex), (rcl, RIndex)):
        c = cl.Cluster(n_servers, gps, gpu_mem_mb=mem)
        c.exclusive = exclusive
        sides.append((cl, c, idx(c)))
    placed = []
    for jid in range(rng.randint(0, 3 * n_servers)):
        m = rng.choice([2751.0, 3213.0, 4527.0, 9000.0])
        gids = sorted(rng.sample([(s, g) for s in range(n_servers) for g in range(gps)],
                                 rng.choice([1, 1, 2, 4])))
        share = rng.uniform(0, 5000.0)
        if any(sides[0][1].gpus[g].mem_free_mb() < m for g in gids):
            continue
        for cl, c, idx in sides:
            job = cl.JobSpec(jid, 0.0, len(gids), 10,
                             cl.ModelProfile("x", 1e8, m, 16, 0.03, 0.05))
            c.place(job, gids, share)
            idx.on_place(jid, gids, share)
        placed.append((jid, gids, m))
    for jid, gids, m in placed:
        if rng.random() < 0.2:
            for cl, c, idx in sides:
                job = cl.JobSpec(jid, 0.0, len(gids), 10,
                                 cl.ModelProfile("x", 1e8, m, 16, 0.03, 0.05))
                c.release(job, gids)
                idx.on_release(jid, gids)
    return sides, rng


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_placement_policies(seed, exclusive):
    sides, rng = _random_state(seed, exclusive)
    (_, pc, pidx), (_, rc, ridx) = sides
    for idx in (pidx, ridx):
        idx.refresh({}, None, False)  # re-fold the released GPUs' workloads
    n_servers = pc.n_servers
    ptop = ptopo.two_tier(n_servers, 2, 3.0) if n_servers > 2 else None
    rtop = rtopo.two_tier(n_servers, 2, 3.0) if n_servers > 2 else None
    for name in ("rand", "ff", "ls", "lwf", "lwf_rack"):
        for kappa in (1, 2, 4):
            pp = ppl.PlacementPolicy(name, kappa=kappa, seed=seed, topology=ptop)
            rp = rpl.PlacementPolicy(name, kappa=kappa, seed=seed, topology=rtop)
            assert repr(pp) == repr(rp)
            for use_index in (False, True):
                pp.index, rp.index = (pidx, ridx) if use_index else (None, None)
                for _ in range(6):
                    n = rng.choice([1, 2, 3, 4, 8, 16])
                    m = rng.choice([2751.0, 4527.0, 12000.0])
                    pj = pcl.JobSpec(0, 0.0, n, 10, pcl.ModelProfile("y", 1e8, m, 16, 0.03, 0.05))
                    rj = rcl.JobSpec(0, 0.0, n, 10, rcl.ModelProfile("y", 1e8, m, 16, 0.03, 0.05))
                    assert pp(pc, pj) == rp(rc, rj), (name, kappa, use_index, n, m)
    with pytest.raises(ValueError):
        ppl.PlacementPolicy("best_fit")


def test_bandwidth_aware_service():
    """The bandwidth-aware SRSF estimate (``JobRun.per_iter_service``) of
    a gang on slow servers, against the reference's."""
    from repro.core.engine import JobRun as RRun
    from repro_torch.core.engine import JobRun as PRun

    rng = random.Random(11)
    for _ in range(40):
        bw = tuple(rng.uniform(0.3, 1.5) for _ in range(8))
        servers = set(rng.sample(range(8), rng.randint(1, 4)))
        prof = rng.choice(list(pcl.TABLE_III))
        runs = []
        for cl, con, run in ((pcl, pcon, PRun), (rcl, rcon, RRun)):
            spec = cl.JobSpec(0, 0.0, 4, 100, cl.TABLE_III[prof])
            r = run(spec=spec, gpus=[(s, 0) for s in sorted(servers)], servers=servers,
                    placed_at=0.0)
            runs.append((r, con.ContentionParams(server_bandwidth=bw)))
        (pr, pp), (rr, rp) = runs
        for aware in (False, True):
            assert pr.per_iter_service(pp, aware) == rr.per_iter_service(rp, aware)
            assert pr.remaining_service(pp, aware) == rr.remaining_service(rp, aware)
