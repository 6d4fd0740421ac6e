"""Chunked all-reduces (``comm_chunks``) and the ring-edge ``"link"``
contention domain of the port's event engine, against the JAX package's.

Every case of ``tests/test_chunked_comm.py`` runs on both engines from the
same jobs: each ``SimResult`` field is ``==`` the reference's, and the
reference's own assertions hold on the port's results.  Then the ring
edges of ``RingEdgeTopology``, the ``ValueError`` for chunks with WFBP
fusion, and the ``incidence`` raise that keeps the fluid path off the
"link" reading.
"""

import dataclasses

import pytest

import repro.core as RC
import repro.core.simulator as rsim
import repro.core.topology as rtopo
import repro_torch.core.cluster as pcluster
import repro_torch.core.simulator as psim
import repro_torch.core.topology as ptopo
import repro_torch.scenarios as P
from repro.core.cluster import Cluster as RCluster
from repro.core.placement import PlacementPolicy as RPlacement
from repro_torch.core.cluster import Cluster as PCluster
from repro_torch.core.placement import PlacementPolicy as PPlacement
from repro_torch.core.trace import paper_trace as p_paper_trace

SIDES = {
    "port": (psim, pcluster.TABLE_III, PCluster, PPlacement),
    "ref": (rsim, RC.TABLE_III, RCluster, RPlacement),
}


def mk(side, jid, arrival, n_gpus, iters, model):
    table = SIDES[side][1]
    mod = pcluster if side == "port" else RC
    return mod.JobSpec(jid, arrival, n_gpus, iters, table[model])


def assert_same(got, ref):
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def both(jobs_of, **kw):
    """The same run on both engines: ``jobs_of(side)`` builds the jobs."""
    got = SIDES["port"][0].simulate(jobs_of("port"), **kw)
    ref = SIDES["ref"][0].simulate(jobs_of("ref"), **kw)
    assert_same(got, ref)
    return got


class TestChunkedComm:
    @pytest.mark.parametrize("n", [1, 2, 8])
    def test_single_job_exact_latency_cost(self, n):
        """N chunks cost exactly (N-1) extra latencies per iteration."""
        res = both(lambda s: [mk(s, 0, 0.0, 8, 40, "resnet50")], comm_chunks=n)
        m, p = pcluster.TABLE_III["resnet50"], P.get_scenario("smoke").params
        expect = (m.t_iter_compute + n * p.a + p.b * m.size_bytes) * 40
        assert res.jct[0] == pytest.approx(expect, rel=1e-6)

    @pytest.mark.parametrize("comm", ["srsf1", "ada"])
    def test_all_jobs_finish_with_chunking(self, comm):
        def jobs(side):
            gen = p_paper_trace if side == "port" else RC.paper_trace
            return gen(seed=11, n_jobs=30, min_iters=50, max_iters=200)

        res = both(jobs, comm=comm, comm_chunks=4)
        assert len(res.jct) == 30

    def test_chunking_lets_short_messages_preempt(self):
        """Under SRSF(1) a small-message job queued behind a vgg transfer
        gets through sooner when the vgg all-reduce is chunked."""
        def jobs(side):
            return [mk(side, 0, 0.0, 8, 300, "vgg16"), mk(side, 1, 0.5, 8, 300, "resnet50")]

        kw = dict(comm="srsf1", n_servers=2, gpus_per_server=4)
        base = both(jobs, comm_chunks=1, **kw)
        chunked = both(jobs, comm_chunks=8, **kw)
        assert base.comm_started_clean > 0
        assert chunked.jct[1] < base.jct[1]
        assert chunked.jct[0] < base.jct[0] * 1.25

    @pytest.mark.parametrize("name", ["paper", "contended_residue", "oversub_fabric"])
    @pytest.mark.parametrize("comm", ["ada", "srsf2", "kway3"])
    def test_scenario_cells(self, name, comm):
        """QUICK-size scenarios (explicit fabrics among them) chunked."""
        import repro.scenarios as R

        got, ref = (
            mod.run_scenario_event(
                mod.get_scenario(name, seed=1, **mod.QUICK_OVERRIDES[name]),
                comm=comm, comm_chunks=3,
            )
            for mod in (P, R)
        )
        assert_same(got, ref)


class TestContentionDomain:
    def test_single_job_domain_invariant(self):
        jobs = lambda s: [mk(s, 0, 0.0, 8, 50, "resnet50")]  # noqa: E731
        a = both(jobs, comm="srsf1", contention_domain="server")
        b = both(jobs, comm="srsf1", contention_domain="link")
        assert a.jct[0] == pytest.approx(b.jct[0])

    def test_link_domain_allows_disjoint_link_overlap(self):
        """Jobs on servers {0,1} and {1,2} share server 1 but no ring edge:
        SRSF(1) serializes them under "server" and overlaps them under
        "link"."""
        mapping = {
            0: [(0, 0), (0, 1), (1, 0), (1, 1)],
            1: [(1, 2), (1, 3), (2, 0), (2, 1)],
        }
        results = {}
        for side, (sim, _, cluster_cls, placement_cls) in SIDES.items():

            class Pin(placement_cls):
                def __init__(self):
                    super().__init__("ff")

                def __call__(self, cluster, job):
                    return mapping[job.job_id]

            for dom in ("server", "link"):
                eng = sim.ClusterSimulator(
                    [mk(side, 0, 0.0, 4, 200, "vgg16"), mk(side, 1, 0.0, 4, 200, "vgg16")],
                    cluster=cluster_cls(n_servers=3, gpus_per_server=4),
                    placement=Pin(), comm_policy=sim.SrsfN(1), contention_domain=dom,
                )
                results[side, dom] = eng.run()
        for dom in ("server", "link"):
            assert_same(results["port", dom], results["ref", dom])
        assert results["port", "link"].avg_jct() < results["port", "server"].avg_jct()

    @pytest.mark.parametrize("comm", ["ada", "srsf1", "kway2"])
    def test_link_scenario_cells(self, comm):
        import repro.scenarios as R

        got, ref = (
            mod.run_scenario_event(
                mod.get_scenario("contended_residue", seed=1,
                                 **mod.QUICK_OVERRIDES["contended_residue"]),
                comm=comm, contention_domain="link", comm_chunks=2,
            )
            for mod in (P, R)
        )
        assert_same(got, ref)

    def test_invalid_domain_raises(self):
        with pytest.raises(ValueError):
            psim.ClusterSimulator([], contention_domain="nope")


class TestRingEdgeTopology:
    @pytest.mark.parametrize("servers", [[3], [0, 1], [1, 0], [0, 2, 5], [7, 1, 4, 2], [2, 2, 6]])
    def test_domains_equal_reference(self, servers):
        got = ptopo.RingEdgeTopology(8)
        ref = rtopo.RingEdgeTopology(8)
        assert got.loaded_domains(servers) == ref.loaded_domains(servers)
        assert got.ring_edges(servers) == ref.ring_edges(servers)
        assert all(got.oversub_of(d) == 1.0 for d in got.loaded_domains(servers))
        assert (got.name, got.n_servers, got.domains, got.racks) == (
            ref.name, ref.n_servers, ref.domains, ref.racks)

    def test_ring_edges_are_directed(self):
        t = ptopo.RingEdgeTopology(4)
        assert t.loaded_domains([0, 1]) == {("edge", 0, 1), ("edge", 1, 0)}
        assert t.loaded_domains([0, 2, 3]) == {("edge", 0, 2), ("edge", 2, 3), ("edge", 3, 0)}
        assert t.loaded_domains([2]) == frozenset()
        with pytest.raises(ValueError):
            t.loaded_domains([0, 4])

    def test_incidence_raises_as_the_reference(self):
        with pytest.raises(NotImplementedError) as got:
            ptopo.RingEdgeTopology(4).incidence()
        with pytest.raises(NotImplementedError) as ref:
            rtopo.RingEdgeTopology(4).incidence()
        assert str(got.value) == str(ref.value)

    def test_fluid_refuses_the_link_reading(self):
        """The fluid path lowers a topology to its incidence matrix: the
        ring-edge reading raises there, with the reference's type."""
        import dataclasses as dc

        from repro_torch.core import fluidsim

        cfg = fluidsim.FluidSimConfig(n_servers=4, gpus_per_server=2,
                                      topology=ptopo.RingEdgeTopology(4), device="cpu")
        with pytest.raises(NotImplementedError):
            fluidsim._Statics(cfg, "cpu")
        scn = dc.replace(P.get_scenario("smoke"), topology=ptopo.RingEdgeTopology(4))
        with pytest.raises(NotImplementedError):
            P.run_scenario_fluid(scn, device="cpu")

    def test_engine_takes_the_ring_for_link(self):
        from repro_torch.core.engine import EventEngine

        eng = EventEngine([], contention_domain="link")
        assert isinstance(eng.topology, ptopo.RingEdgeTopology)
        assert eng._uniform_oversub and eng.topology.domains == ()
        assert EventEngine([]).topology.name == "nic"


def test_chunks_with_fusion_raise():
    jobs = P.get_scenario("fusion_sweep", seed=0).job_list()[:2]
    with pytest.raises(ValueError, match="mutually exclusive"):
        psim.simulate(jobs, comm_chunks=2, fusion="none")
    psim.simulate(jobs[:1], comm_chunks=1, fusion="none")  # one chunk is no chunking
